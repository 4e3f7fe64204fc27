"""The NXDN48 site: the plain reference's NXDN machines equal the
program's per-channel decoder, through the harness its bank equals the
reference at 4 channels on the CPU, a lower-precision reference fails the
comparison, the K5 reader counts a round's blocked SACCH and FACCH1
trellises, and on the card the cell runs through ``benchmark/run.py``
(marker ``cuda``)."""
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import control
from benchmark.harness import layers, roofline, spec
from benchmark.reference import stream
from benchmark.synth import nxdn
from conftest import ROOT, run_small, small_cell

CELL = "nxdn_site.busy"


def _port_decode(row):
    from digiham_tpu_torch.protocols import nxdn as port
    from digiham_tpu_torch.runtime.meta import PipelineMetaWriter

    dec, events = port.make_decoder(), []
    dec.set_meta_writer(PipelineMetaWriter(events.append))
    return dec.process(row), events


def _tx_calls():
    """A call of every variant, 1% of its dibits replaced, a gap after."""
    rng = np.random.default_rng(2**31 + 20)
    rows = []
    for v in range(len(nxdn.VARIANTS)):
        d = nxdn.call(rng, 3.0, v)
        hit = rng.choice(len(d), len(d) // 100, replace=False)
        d[hit] = rng.integers(0, 4, len(hit))
        rows.append(np.concatenate([d, rng.integers(0, 4, 300)])
                    .astype(np.uint8))
    return rows


@pytest.mark.parametrize("streams", ["host_synth", "tx"])
def test_decoder_equals_the_programs(streams):
    """Bytes and events of ``reference/nxdn`` against the program's
    ``protocols.nxdn.make_decoder``: on the program's bank streams
    (voice and FACCH1 slots, TX_RELEASE, RCCH and UDCH frames) and on the
    benchmark's calls of every variant with errors."""
    pytest.importorskip("digiham_tpu_torch")
    if streams == "host_synth":
        from digiham_tpu_torch.bench import host_synth

        rows = list(host_synth.nxdn_streams(11, 3))
    else:
        rows = _tx_calls()
    voiced = 0
    for row in rows:
        frames, events = stream.decode_channel("nxdn", row)
        voice, ev = _port_decode(row)
        assert b"".join(b for _, b in frames) == voice
        assert [e for _, e in events] == ev
        voiced += bool(frames)
    assert voiced == len(rows)


def test_every_variant_decodes_as_its_kind():
    """Without errors each variant's call hands over its frames (a
    late-entry frame one slot) and, its superframe complete, the call's
    kind, source and destination."""
    rng = np.random.default_rng(7)
    kinds = {0: b"conference", 1: b"individual", 2: b"conference",
             3: b"conference"}
    for v, kind in kinds.items():
        # a clean SACCH unit can fail its own CRC (punctured bits decode as
        # received zeros, in digiham too): the first call whose superframe
        # completes
        for _ in range(10):
            d = nxdn.call(rng, 2.0, v)
            frames, events = stream.decode_channel("nxdn", np.concatenate(
                [d, np.zeros(300, np.uint8)]))
            if any(b"source:" in e for _, e in events):
                break
        n = len(d) // nxdn.FRAME_SIZE - 2
        sizes = [len(b) for _, b in frames]
        late = n // 4 if v == 3 else 0
        assert sizes == [36 if v != 3 or i % 4 != 3 else 18
                         for i in range(n)]
        assert sum(s == 18 for s in sizes) == late
        assert any(b"type:" + kind in e for _, e in events)
        assert events[-1][1] == b"protocol:NXDN\n"  # TX_RELEASE resets


def test_bank_equals_reference():
    pytest.importorskip("digiham_tpu_torch")
    result, said = run_small(small_cell(CELL))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 5 and result["failed"] == 0


def test_lower_precision_fails():
    numbers, frames, _ = control.control(small_cell(CELL), 1, 8 * 48000,
                                         "cpu", n_workers=1)
    assert frames > 100
    assert any(v["value"] > v["limit"] for v in numbers.values()), numbers


def test_k5_roofline_counts_a_rounds_trellises():
    """One round of 1,000 frames: 1,000 SACCH trellises of 36 steps and
    2,000 FACCH1 ones of 96, 16 states; the operations bound it."""
    reader = spec.metric_reader("k5_roofline.nxdn")
    n = 1000
    ops = n * 36 * (16 * 14 + 5) + 2 * n * 96 * (16 * 14 + 5)
    by = n * (2 * 36 + 4) + 2 * n * (2 * 96 + 4)
    least = max(ops / roofline.FP32_OPS_PER_S, by / roofline.HBM_BYTES_PER_S)
    assert least == ops / 67e12
    session = types.SimpleNamespace(device=[
        ("void viterbi_kernel<16>(...)", 0.0, 6.0),
        ("void demod_kernel<1, 0>(...)", 6.0, 50.0),
        ("void viterbi_kernel<16>(...)", 50.0, 54.0)])  # us
    ctx = layers.Context(cell=None, steps=1, push_s=1.0, step_s=0.0,
                         decode_s=0.0, slice=(session, 1.0, 0, 1),
                         slice_rounds=[n])
    assert reader(ctx) == pytest.approx(100.0 * least / 10e-6)
    assert reader(layers.Context(None, 1, 1.0, 0.0, 0.0, (session, 1.0, 0, 1),
                                 [])) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(trace, benchmark_spec):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147484020", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if not trace:
        want = {m["name"] for m in benchmark_spec["end_to_end"]
                if CELL in m.get("workloads", [CELL])}
        assert set(result["metrics"]) == want
    else:
        assert result["device"]["busy_s"] > 0
        for name in ("k2_roofline", "k5_roofline.nxdn"):
            assert 0 < result["metrics"][name]["value"] <= 100
