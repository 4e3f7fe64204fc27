"""On the card: one short run of each cell through ``benchmark/run.py``,
as the check runs it, comes out correct with its metrics; and the
reference's front equals the program's CUDA kernels (K2 with a filter,
K3 without) at a bank's full width for every front the port runs. Skips
without a card (marker ``cuda``)."""
import json
import subprocess
import sys

import pytest

from conftest import FRONTS, ROOT, front_cell

CELLS = ["dmr_site.busy", "ysf_site.busy", "dmr_site.live", "ysf_site.live"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(name, trace, benchmark_spec):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if not trace:
        want = {m["name"] for m in benchmark_spec["end_to_end"]
                if name in m.get("workloads", [name])}
        assert set(result["metrics"]) == want
    else:
        assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("front", list(FRONTS))
def test_front_equals_the_programs_kernels(front, monkeypatch):
    """256 channels, one 4-century block from the stream's start (a
    zeroed RRC history): K2 (wide at sps 10, narrow at sps 20) or K3 (the
    D-Star and POCSAG 2FSK shapes) against the reference, bit for bit."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from benchmark.harness import traffic
    from benchmark.reference import dsp
    from digiham_tpu_torch.dsp.demod import demod_init, rrc_demod_block
    from digiham_tpu_torch.dsp.rrc import NARROW_RRC, WIDE_RRC, RrcState

    dev = torch.device("cuda")
    rrc, sps, mode, invert = FRONTS[front]
    C, nc = 256, 4
    cell = front_cell(front, monkeypatch, channels=C)
    L = nc * (100 * sps + 1) + 2
    audio = torch.from_numpy(traffic.make(cell, 2**31 + 11, dev).rows(
        list(range(C)), L)).to(dev)
    want, _, _ = dsp.demodulate(audio, sps, rrc, mode=mode, invert=invert)
    design = {"wide": WIDE_RRC, "narrow": NARROW_RRC}.get(rrc)
    got, _, _ = rrc_demod_block(
        audio, RrcState.init(C, design or WIDE_RRC, dev),
        demod_init(C, dev), nc, sps, design, mode=mode, invert=invert)
    got = got.cpu().numpy()
    assert got.shape == (C, nc * 100) and want.shape[1] >= nc * 100
    wrong = int(np.count_nonzero(got != want[:, :nc * 100]))
    print(f"{front}: {rrc} sps {sps} {mode} invert {invert}: "
          f"{wrong} of {got.size} symbols differ")
    assert wrong == 0
