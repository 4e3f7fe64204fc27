"""The port's measuring programs (``digiham_tpu_torch/bench/``) on the CPU
with ``--device cpu``, at 8 channels, 2 centuries, 2 steps and 2 reps.

- each program prints its JSON lines with the keys of the JAX program it
  ports, a positive value, ``"correct": true`` (its fixture gate passed)
  and distinct rep checksums;
- without a card and without ``--device cpu`` each one prints the failure
  line (``value: null``) and exits non-zero (decided inside the test, by
  patching ``torch.cuda.is_available``);
- the headline's step loop equals bench.py's on the same input: identical
  numpy I/Q windows through JAX's ``DmrPipeline.step_iq_planes`` (the XLA
  path) with bench.py's ``rebase`` and ``checksum`` and through
  ``common.iq_steps``: the checksums are equal, exactly;
- ``bench/dmr_synth.py`` equals ``tests/dmr_synth.py`` on 20 seeds;
- a ``tracked`` latency row (2 channels, 2 centuries, block 1,024) gives
  the per-frame latencies in samples that tools/bench_latency.py's
  ``bench_tracked`` gives on the same streams, exactly;
- bench.py's multi-process verdict rules and back-off ladder;
- the stage prefixes of tools/bench_multistream.py (``fm``, ``rrc``,
  ``demod``, ``fm_rrc``): ``common.stage_steps`` equals the JAX tool's
  ``_make_stage_step`` bodies on the same numpy base planes (float sums
  within 1e-5 relative, the ``demod`` symbol sum exactly), and
  ``bench_multistream --stage demod`` runs a process to its line.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import dmr_synth as j_synth  # noqa: E402
from digiham_tpu.pipeline import DmrPipeline as JDmrPipeline  # noqa: E402
from digiham_tpu_torch.bench import (  # noqa: E402
    bench_latency, bench_protocols, common, dmr_synth, headline)
from digiham_tpu_torch.pipeline import DmrPipeline  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--channels", "8", "--centuries", "2",
         "--steps", "2", "--reps", "2"]
# bench.py :477-495 (``unroll`` is ``steps`` in the port)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline",
                 "frames_decoded_per_s", "channels", "samples_per_step",
                 "steps", "async_calls", "sustained_wall_seconds",
                 "per_step_seconds", "serial_call_seconds", "rep_checksums",
                 "backend"}
# tools/bench_protocols.py :93-106
PROTOCOL_KEYS = {"metric", "value", "unit", "realtime_channels", "channels",
                 "samples_per_step", "steps", "async_calls",
                 "per_step_seconds", "sustained_wall_seconds",
                 "serial_call_seconds"}
# tools/bench_multistream.py :356-368
MULTISTREAM_KEYS = {"metric", "protocol", "stage", "n_procs",
                    "aggregate_msps", "per_proc_wall_s", "wall_ratio",
                    "per_proc_max_rep_s", "steps", "centuries", "reps"}
# tools/bench_latency.py :234-239
LATENCY_KEYS = {"driver", "block", "block_ms", "algo_latency_ms",
                "push_wall_ms", "frames_matched", "frames_missed", "backend"}


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, _lines(capsys.readouterr().out)


def test_headline_line(capsys):
    rc, lines = _run(headline.main, SMALL + ["--procs", "0"], capsys)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert HEADLINE_KEYS <= set(line)
    assert line["metric"] == "dmr_iq_pipeline_throughput"
    assert line["value"] > 0 and line["correct"] is True
    assert line["vs_baseline"] == line["value"] / 0.048
    assert len(set(line["rep_checksums"])) == 2
    assert line["backend"] == "cpu" and line["card"] is None
    assert line["block_len"] == 2 * 1001 + 8
    assert line["gate"]["fixture"].endswith("dmr_smoke.npz")
    assert line["gate"]["path"] == "step_iq_planes"


def test_protocol_lines(capsys):
    rc, lines = _run(bench_protocols.main, SMALL, capsys)
    assert rc == 0
    assert [ln["metric"] for ln in lines] == [
        f"{p}_pipeline_throughput" for p in bench_protocols.BLOCKS]
    for line in lines:
        assert PROTOCOL_KEYS <= set(line)
        assert line["value"] > 0 and line["correct"] is True
        assert len(set(line["rep_checksums"])) == 2
        assert line["gate"]["fixture"].endswith(
            f"{line['metric'].split('_')[0]}_smoke.npz")


def test_protocol_blocks_are_the_jax_tools():
    """Without --centuries each protocol takes the JAX tool's block."""
    assert bench_protocols.BLOCKS == {"dmr": 32, "ysf": 40, "nxdn": 16,
                                      "dstar": 32, "pocsag": 8}
    pipes = {p: common.make_pipeline(p, 2, 1, "cpu")
             for p in bench_protocols.BLOCKS}
    assert {p: q.sps for p, q in pipes.items()} == {
        "dmr": 10, "ysf": 10, "nxdn": 20, "dstar": 10, "pocsag": 40}


def test_multistream_two_processes():
    r = subprocess.run(
        [sys.executable, "-m", "digiham_tpu_torch.bench.bench_multistream",
         "--procs", "2", *SMALL], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = _lines(r.stdout)
    assert len(lines) == 1
    line = lines[0]
    assert MULTISTREAM_KEYS <= set(line)
    assert line["aggregate_msps"] > 0 and line["correct"] is True
    assert len(line["per_proc_wall_s"]) == 2
    assert all(w > 0 for w in line["per_proc_wall_s"])
    assert len(line["per_proc_rep_s"]) == 2
    flat = [c for cs in line["rep_checksums"] for c in cs]
    assert len(set(flat)) == 4


def test_latency_lines(capsys):
    rc, lines = _run(bench_latency.main,
                     ["--device", "cpu", "--driver", "streamdriver",
                      "--driver", "tracked", "--block", "4800", "--nc", "2"],
                     capsys)
    assert rc == 0
    assert [ln["driver"] for ln in lines] == ["streamdriver[nc=1]",
                                              "tracked[nc=2]"]
    for line in lines:
        assert LATENCY_KEYS <= set(line) and line["correct"] is True
        assert line["frames_matched"] > 0 and line["frames_missed"] == 0
        assert line["algo_latency_ms"]["p50"] > 0
    assert lines[0]["gate"]["fixture"].endswith("dmr_bank_smoke.npz")


@pytest.mark.parametrize("main", [headline.main, bench_protocols.main,
                                  bench_latency.main, "multistream"])
def test_without_a_card_the_failure_line(main, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if main == "multistream":
        from digiham_tpu_torch.bench import bench_multistream
        main = bench_multistream.main
    rc, lines = _run(main, [], capsys)
    assert rc != 0 and len(lines) == 1
    assert lines[0]["value"] is None
    assert lines[0]["backend"] == "unavailable"
    assert "no CUDA device" in lines[0]["error"]


def test_headline_loop_equals_bench_py():
    """The same numpy I/Q base planes through bench.py's ``step_k`` body
    (JAX, the XLA path; its ``rebase`` and ``checksum``, :316-329 and
    :393-396) and through ``common.iq_steps``: equal checksums."""
    channels, n_cent, sps, steps = 8, 2, 10, 3
    L = common.block_len(n_cent, sps)
    rng = np.random.default_rng(5)
    length = L + common.STRIDE * (steps - 1)
    base_re, base_im = rng.standard_normal((2, channels, length)).astype(
        np.float32)

    jpipe = JDmrPipeline(channels=channels, sps=sps, n_centuries=n_cent)

    def checksum(out):
        return (out["dibits"].astype(jnp.int32).sum()
                + out["sync_dist_dense"].sum()
                + out["voice_payload"].astype(jnp.int32).sum()
                + out["bptc_data"].sum()
                + out["sync_type"].sum()
                + out["tact_slot"].sum())

    state = jpipe.init_state()
    acc = jnp.int32(0)
    last_re = jnp.ones((channels,), jnp.float32)
    last_im = jnp.zeros((channels,), jnp.float32)
    for k in range(steps):
        window = slice(k * common.STRIDE, k * common.STRIDE + L)
        out, (last_re, last_im), state = jpipe.step_iq_planes(
            jnp.asarray(base_re[:, window]), jnp.asarray(base_im[:, window]),
            last_re, last_im, state)
        acc = acc + checksum(out)
        state.demod.pos = jnp.zeros_like(state.demod.pos)
    acc = (acc + state.demod.volume_ring.sum().astype(jnp.int32)
           + state.demod.offset.sum()
           + state.rrc.history.sum().astype(jnp.int32))

    pipe = DmrPipeline(channels=channels, sps=sps, n_centuries=n_cent,
                       device="cpu")
    got, _ = common.iq_steps(pipe, torch.from_numpy(base_re),
                             torch.from_numpy(base_im), pipe.init_state(), L,
                             steps)
    assert int(got) == int(acc)


def test_dmr_synth_equals_the_test_suites():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        slot, busy, lcss = (int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                            int(rng.integers(0, 4)))
        assert np.array_equal(dmr_synth.make_cach(slot, busy, lcss),
                              j_synth.make_cach(slot, busy, lcss))
        payload = rng.integers(0, 4, 108).astype(np.uint8)
        frag = bytes(rng.integers(0, 256, 4).astype(np.uint8))
        for kw in ({"sync": True}, {"sync": True, "ms": True},
                   {"sync": False}, {"sync": False, "emb_fragment": frag,
                                     "lcss": lcss}):
            got = dmr_synth.voice_frame(slot, payload, **kw)
            want = j_synth.voice_frame(slot, payload, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(dmr_synth.voice_frame(slot),
                              j_synth.voice_frame(slot))


def _jax_latency_tool():
    path = os.path.join(ROOT, "tools", "bench_latency.py")
    spec = importlib.util.spec_from_file_location("bench_latency", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_latency_streams_equal_the_jax_tools():
    tool = _jax_latency_tool()
    for seed in (7, 1000, 3001):
        dib, ends = bench_latency.synth_stream(seed)
        jdib, jends = tool.synth_stream(seed)
        assert np.array_equal(dib, jdib) and ends == jends
    assert np.array_equal(bench_latency.modulate(dib), tool.modulate(jdib))


def test_tracked_row_latencies_equal_the_jax_tools():
    """2 channels, 2 centuries, block 1,024: every matched frame's latency
    in samples, in emission order, and the misses."""
    tool = _jax_latency_tool()
    want, _, want_missed = tool.bench_tracked(2, 2, 1024)
    got, walls, missed = bench_latency.bench_tracked(2, 2, 1024, "cpu")
    assert got == want and missed == want_missed == 0
    assert len(got) > 0 and len(walls) > 0


def test_multistream_verdicts():
    """bench.py's ``_ms_verdict`` rules, ported."""
    good = {"n_procs": 8, "aggregate_msps": 3200.0,
            "per_proc_wall_s": [8.1, 8.3, 8.2, 8.0, 8.4, 8.1, 8.2, 8.3]}
    assert headline.ms_verdict(good, 400.0) == "stable"
    slow = {"n_procs": 8, "aggregate_msps": 700.0,
            "per_proc_wall_s": [60.0] * 8}
    assert "aggregate" in headline.ms_verdict(slow, 400.0)
    uneven = {"n_procs": 8, "aggregate_msps": 3200.0,
              "per_proc_wall_s": [2.7, 3.0, 3.1, 2.9, 26.9, 3.2, 3.0, 2.8]}
    assert "uneven" in headline.ms_verdict(uneven, 400.0)
    err = {"n_procs": 8, "steps": 64, "error": "timeout>900s"}
    assert headline.ms_verdict(err, 400.0) == "timeout>900s"


def test_multistream_stage_ladder(monkeypatch):
    """The configured point twice, then fewer processes, then fewer steps
    a rep; the first stable run wins and every attempt is kept."""
    calls = []

    def fake(n, steps, args):
        calls.append((n, steps))
        walls = [1.0] * n
        agg = 1000.0 if (n, steps) == (4, 64) else 10.0
        return {"n_procs": n, "steps": steps, "aggregate_msps": agg,
                "per_proc_wall_s": walls, "correct": True}

    monkeypatch.setattr(headline, "_run_multistream_once", fake)
    head = {"value": 400.0}
    headline.multistream_stage(head, 8, None)
    assert calls == [(8, 64), (8, 64), (4, 64)]
    ms = head["multistream"]
    assert ms["stable"] and ms["n_procs"] == 4
    assert ms["aggregate_vs_baseline"] == 1000.0 / 0.048
    assert [a["verdict"] for a in ms["attempts"]][-1] == "stable"
    calls.clear()
    head = {"value": 400.0}
    monkeypatch.setattr(headline, "_run_multistream_once",
                        lambda n, s, a: calls.append((n, s)) or {
                            "n_procs": n, "steps": s, "error": "rc=1"})
    headline.multistream_stage(head, 8, None)
    assert calls == [(8, 64), (8, 64), (4, 64), (8, 32), (4, 32)]
    assert "error" in head["multistream"]


def _jax_stage(stage, base, channels, n_cent, sps, L, steps):
    """tools/bench_multistream.py's ``_make_stage_step`` body (:81-140) on
    numpy base planes, through the JAX package's functions (XLA)."""
    from digiham_tpu.dsp.demod import demod_init, gfsk_demod_block
    from digiham_tpu.dsp.fm import fm_discriminator
    from digiham_tpu.dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block

    def win(x, k):
        return jnp.asarray(x[:, k * common.STRIDE:k * common.STRIDE + L])

    acc = jnp.float32(0)
    if stage in ("fm", "fm_rrc"):
        iq = (base[0] + 1j * base[1]).astype(np.complex64)
        last = jnp.ones((channels,), jnp.complex64)
        rrc = RrcState.init(channels, WIDE_RRC)
        for k in range(steps):
            audio, last = fm_discriminator(win(iq, k), last)
            if stage == "fm":
                acc = acc + audio.sum()
            else:
                y, rrc = rrc_filter_block(audio * 5000.0, rrc, WIDE_RRC)
                acc = acc + y.sum()
    elif stage == "rrc":
        rrc = RrcState.init(channels, WIDE_RRC)
        for k in range(steps):
            y, rrc = rrc_filter_block(win(base[0], k), rrc, WIDE_RRC)
            acc = acc + y.sum()
    else:
        dm = demod_init(channels)
        for k in range(steps):
            dib, dm = gfsk_demod_block(win(base[0], k), dm, n_cent, sps)
            acc = acc + dib.astype(jnp.float32).sum()
            dm.pos = jnp.zeros_like(dm.pos)
        acc = acc + dm.offset.sum()
    return float(acc)


@pytest.mark.parametrize("stage", list(common.STAGE_PREFIXES))
def test_stage_prefix_equals_the_jax_tool(stage):
    channels, n_cent, sps, steps = 8, 2, 10, 3
    L = common.block_len(n_cent, sps)
    length = L + common.STRIDE * (steps - 1)
    n_planes, scale = common.STAGE_PREFIXES[stage]
    rng = np.random.default_rng(11)
    base = (rng.standard_normal((n_planes, channels, length))
            * scale).astype(np.float32)
    want = _jax_stage(stage, base, channels, n_cent, sps, L, steps)
    pipe = DmrPipeline(channels=channels, sps=sps, n_centuries=n_cent,
                       device="cpu")
    got = float(common.stage_steps(stage, pipe,
                                   [torch.from_numpy(p) for p in base], L,
                                   steps))
    if stage == "demod":
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-5)


def test_multistream_stage_prefix_process():
    r = subprocess.run(
        [sys.executable, "-m", "digiham_tpu_torch.bench.bench_multistream",
         "--procs", "1", "--stage", "demod", *SMALL], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    line = _lines(r.stdout)[0]
    assert line["stage"] == "demod" and line["correct"] is True
    assert line["gate"]["path"] == "step_iq_planes"
    assert line["aggregate_msps"] > 0
    assert len(set(line["rep_checksums"][0])) == 2
