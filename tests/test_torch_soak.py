"""The port's soak programs (``digiham_tpu_torch/soak/``) on the CPU, held
to the JAX repo's.

- ``soak/classify.py`` gives the verdicts and margins of
  tools/soak_classify.py on the cases of tests/test_soak_classify.py (a
  healthy window stays ``UNCLASSIFIED``, a pinned slicer boundary, a flat
  valley, timing settle, ``diff_frames``, ``classify_root``'s episodes and
  ``noise_errors``), and the same oracle trace and filtered stream;
- ``soak/synth.py``'s builders equal tests/ysf_synth.py, tests/nxdn_synth.py,
  the D-Star and POCSAG builders of tests/test_dstar.py and
  tests/test_pocsag.py, and the stream builders of tools/fuzz_timesharded.py
  (taken from its source, whose import would configure JAX) on the same
  seeds;
- ``dmr_soak`` at 4 channels x 40 frames: every channel's bytes equal the
  JAX bank's on the same pushes, all frames bit-exact;
- the unscreened campaign (tests/torch_soak.py), two cases of each
  protocol: no ``UNCLASSIFIED`` mismatch;
- ``fuzz_timesharded`` on the CPU mesh, one case of each protocol;
- ``python3 -m digiham_tpu_torch.soak`` on the CPU prints its line, and
  every program raises without a card when ``device`` is None.

Integers, bytes and events exact; classifier margins exact (both round to
8 places the same float64 arithmetic on the same oracle decisions).
"""
import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(__file__)
TOOLS = os.path.join(HERE, "..", "tools")
sys.path.insert(0, HERE)
sys.path.insert(0, TOOLS)

import nxdn_synth  # noqa: E402
import soak_classify as JC  # noqa: E402  (tools/soak_classify.py)
import test_dstar  # noqa: E402
import test_pocsag  # noqa: E402
import torch_soak  # noqa: E402
import ysf_synth  # noqa: E402
from digiham_tpu.dsp.rrc import WIDE_RRC as J_WIDE  # noqa: E402
from digiham_tpu.pipeline import DmrPipeline as JDmrPipeline  # noqa: E402
from digiham_tpu.runtime.tracked_bank import (  # noqa: E402
    TrackedChannelBank as JBank)
from dmr_synth import voice_frame  # noqa: E402
from digiham_tpu_torch.dsp.rrc import WIDE_RRC  # noqa: E402
from digiham_tpu_torch.soak import (  # noqa: E402
    __main__ as soak_main, ber_sweep, classify, dmr_soak, fuzz_timesharded,
    impaired, ser_equiv, synth)

torch.set_num_threads(1)

LEVELS = np.array([1.0, 3.0, -1.0, -3.0], np.float32) / 3.0
SPS = 10


def _stream(n_sym=1200, seed=3, noise=25.0, amp=1000.0):
    """tests/test_soak_classify.py's stream (:17-21)."""
    rng = np.random.default_rng(seed)
    dib = rng.integers(0, 4, n_sym).astype(np.uint8)
    x = np.repeat(LEVELS[dib], SPS) * amp
    return (x + rng.normal(0, noise, x.shape)).astype(np.float32), dib


def _pinned():
    raw, _ = _stream(seed=5, noise=0.0)
    raw = raw.copy()
    raw[450 * SPS:451 * SPS] = np.float32(625.0)
    return raw


# (case, samples, window, the JAX test's verdicts)
WINDOWS = {
    "healthy": (lambda: classify.rrc_np(_stream()[0], WIDE_RRC), (400, 544),
                ("UNCLASSIFIED",)),
    "slicer_boundary": (_pinned, (440, 470), ("slicer-boundary",)),
    "flat_valley": (lambda: _stream(noise=0.0)[0], (300, 444),
                    ("flat-valley-tie",)),
    "timing_settle": (lambda: classify.rrc_np(_stream(seed=9)[0], WIDE_RRC),
                      (0, 80), ("timing-settle", "slicer-boundary",
                                "flat-valley-tie")),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_classify_window_equals_the_tool(case):
    make, (lo, hi), verdicts = WINDOWS[case]
    samples = make()
    got = classify.classify_window(samples, lo, hi, sps=SPS)
    assert got == JC.classify_window(samples, lo, hi, sps=SPS)
    assert got["verdict"] in verdicts
    if case == "healthy":
        assert got["min_slicer_margin"] > classify.SLICER_TOL
    if case == "slicer_boundary":
        assert got["min_slicer_margin"] < 1e-6


@pytest.mark.parametrize("mode,invert,noise", [("gfsk", False, 25.0),
                                               ("fsk", False, 40.0),
                                               ("fsk", True, 40.0)])
def test_oracle_trace_and_filter_equal_the_tool(mode, invert, noise):
    raw, _ = _stream(n_sym=900, seed=21, noise=noise)
    filt = classify.rrc_np(raw, WIDE_RRC)
    assert np.array_equal(filt, JC.rrc_np(raw, J_WIDE))
    got = classify.oracle_trace(filt, SPS, mode, invert)
    want = JC.oracle_trace(filt, SPS, mode, invert)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]


def test_tolerances_unchanged():
    assert classify.SLICER_TOL == JC.SLICER_TOL == 1e-3
    assert classify.VALLEY_TOL == JC.VALLEY_TOL == 1e-3


@pytest.mark.parametrize("emitted,expect", [
    (b"x" * 27 * 3 + b"y" * 27 + b"x" * 27, 6), (b"x" * 27 * 6, 6),
    (b"", 2)])
def test_diff_frames_equals_the_tool(emitted, expect):
    got = classify.diff_frames(emitted, b"x" * 27, expect)
    assert got == JC.diff_frames(emitted, b"x" * 27, expect)


def _episode():
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[200] ^= 1                                  # isolated: not blamed
    dev[5000] ^= 1
    dev[5040] ^= 1
    dev[5120] ^= 1                                 # the episode
    margins = [1.0] * 10000
    margins[5000] = 1e-5                           # root IS knife-edge
    return dev, orc, margins, [(100, 1.0, 0)], 5100, 5244


def _timing_flip():
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[5000:5144] ^= 1                            # slewed transient
    return (dev, orc, [1.0] * 10000, [(100, 1.0, 0), (4950, 1e-5, 1)],
            5100, 5244)


def _no_divergence():
    orc = np.zeros(1000, np.uint8)
    return orc.copy(), orc, [1.0] * 1000, [(10, 1.0, 0)], 500, 644


def _real_bug():
    orc = np.zeros(10000, np.uint8)
    dev = orc.copy()
    dev[5050] ^= 1
    return dev, orc, [1.0] * 10000, [(100, 1.0, 0)], 5040, 5184


# tests/test_soak_classify.py :81-131: (case, want verdict, root symbol)
ROOTS = {"episode_grouping": (_episode, "slicer-boundary", 5000),
         "timing_flip": (_timing_flip, "flat-valley-tie", 5000),
         "no_divergence": (_no_divergence, None, None),
         "real_bug_stays_unclassified": (_real_bug, "UNCLASSIFIED", 5050)}


@pytest.mark.parametrize("case", list(ROOTS))
def test_classify_root_equals_the_tool(case):
    make, verdict, root = ROOTS[case]
    args = make()
    got = classify.classify_root(*args)
    assert got == JC.classify_root(*args)
    if verdict is None:
        assert got is None
    else:
        assert got["verdict"] == verdict and got["root_symbol"] == root


def test_noise_errors_equals_the_tool():
    tx = np.zeros(1000, np.uint8)
    orc = tx.copy()
    orc[500] = 2
    orc[510] = 1
    for lo, hi, want in ((432, 576, 2), (0, 144, 0)):
        assert classify.noise_errors(orc, tx, lo, hi) == want
        assert JC.noise_errors(orc, tx, lo, hi) == want


def test_classify_miss_ladder():
    """tools/tpu_soak.py's order: noise error first, then the window's
    knife-edge class, then a cascade from a knife-edge root."""
    tx = np.zeros(10000, np.uint8)
    margins = [1.0] * 10000
    cents = [(100, 1.0, 0), (5050, 1e-5, 1)]
    noisy = tx.copy()
    noisy[5100] = 3
    assert classify.classify_miss(tx, (noisy, margins, cents), tx, 5100,
                                  5244)["verdict"] == "noise-error(1sym)"
    dev = tx.copy()
    dev[5000:5144] ^= 1
    v = classify.classify_miss(dev, (tx, margins, [(100, 1.0, 0)]), tx,
                               5100, 5244)
    assert v["verdict"] == "UNCLASSIFIED"
    v = classify.classify_miss(dev, (tx, margins, cents), tx, 5100, 5244)
    assert v["verdict"] == "flat-valley-tie"  # the window's own feeding tie
    cents = [(100, 1.0, 0), (4950, 1e-5, 1)]  # feeds the root, not 5100
    v = classify.classify_miss(dev, (tx, margins, cents), tx, 5100, 5244)
    assert v["verdict"] == "cascade(flat-valley-tie@5000)"
    assert classify.verdict_class(v["verdict"]) == "cascade(flat-valley-tie)"


# --- the TX side -----------------------------------------------------------

def _fuzz_tool_builders():
    """The stream builders of tools/fuzz_timesharded.py (:43-121), taken
    from its source: importing the tool would set JAX's platform and
    compilation cache."""
    path = os.path.join(TOOLS, "fuzz_timesharded.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = ("_dmr_dibits", "_ysf_dibits", "_nxdn_dibits", "_dstar_bits",
             "_pocsag_bits")
    ns = {"np": np, "voice_frame": voice_frame}
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    exec(compile(ast.Module(body, []), path, "exec"), ns)
    return {n: ns[n] for n in names}


def test_fuzz_stream_builders_equal_the_tool():
    tool = _fuzz_tool_builders()
    pairs = (("_dmr_dibits", synth.dmr_dibits),
             ("_ysf_dibits", synth.ysf_dibits),
             ("_nxdn_dibits", synth.nxdn_dibits),
             ("_dstar_bits", synth.dstar_bits),
             ("_pocsag_bits", synth.pocsag_bits))
    for name, mine in pairs:
        for seed in range(4):
            want = tool[name](np.random.default_rng(seed))
            got = mine(np.random.default_rng(seed))
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, seed)


def test_ysf_and_nxdn_builders_equal_the_synthesizers():
    rng = np.random.default_rng(4)
    for i in range(8):
        dch = bytes(rng.integers(0, 256, 10).astype(np.uint8))
        ambe = bytes(rng.integers(0, 256, 7).astype(np.uint8))
        assert np.array_equal(synth.vd2_frame(i, dch, ambe),
                              ysf_synth.vd2_frame(i, dch, ambe))
        assert np.array_equal(synth.v1_frame(i), ysf_synth.v1_frame(i))
        assert np.array_equal(synth.vw_frame(i), ysf_synth.vw_frame(i))
    assert np.array_equal(synth.header_frame(b"A", b"B", b"C", b"D"),
                          ysf_synth.header_frame(b"A", b"B", b"C", b"D"))
    assert np.array_equal(synth.terminator_frame(),
                          ysf_synth.terminator_frame())
    units = synth.vcall_superframe_bytes(2, 1234, 4321)
    assert np.array_equal(units, nxdn_synth.vcall_superframe_bytes(
        2, 1234, 4321))
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    for i in range(4):
        assert np.array_equal(synth.encode_sacch_unit(i, units[i]),
                              nxdn_synth.encode_sacch_unit(i, units[i]))
    for mt, off in ((0b001000, None), (0b001000, 38), (0b000001, 110)):
        assert np.array_equal(synth.encode_facch1(mt, off),
                              nxdn_synth.encode_facch1(mt, off))
    slots = [synth.voice_slot_dibits(payload, 38),
             synth.voice_slot_dibits(payload, 110)]
    assert np.array_equal(
        synth.nxdn_frame((1, 2, 3), synth.encode_sacch_unit(1, units[1]),
                         slots),
        nxdn_synth.nxdn_frame((1, 2, 3),
                              nxdn_synth.encode_sacch_unit(1, units[1]),
                              slots))


def test_dstar_and_pocsag_builders_equal_the_tests():
    for n in (3, 25, 44):
        got = synth.full_voice_stream(n, {1: b"abc"})
        want = test_dstar.full_voice_stream(n, {1: b"abc"})
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert len(got) == len(want)
    assert synth.make_header_bytes(own="DL1ABC") == \
        test_dstar.make_header_bytes(own="DL1ABC")
    words = [synth.address_codeword(a, f) for a, f in ((1, 0), (77777, 3))]
    words += [synth.data_codeword(p) for p in synth.alpha_payloads("Hi 42")]
    assert words == ([test_pocsag.address_codeword(1, 0),
                      test_pocsag.address_codeword(77777, 3)]
                     + [test_pocsag.data_codeword(p)
                        for p in test_pocsag.alpha_payloads("Hi 42")])
    assert np.array_equal(synth.build_stream(words),
                          test_pocsag.build_stream(words))


# --- the programs ------------------------------------------------------------

def test_dmr_soak_equals_the_jax_bank():
    """4 channels x 40 frames: the JAX bank on the same pushes (the noise
    of block b on channel c seeded by (7, b, c), as tools/tpu_soak.py
    seeds it) gives every channel the same bytes."""
    channels, frames = 4, 40
    got = dmr_soak.run(channels=channels, frames=frames, device="cpu",
                       log=lambda text: None)
    assert got["ok"] and got["unclassified"] == 0
    assert got["frames_bit_exact"] == got["frames_expected"] == 80
    base = dmr_soak.base_audio(dmr_soak.tx_dibits(frames))
    assert np.array_equal(
        dmr_soak.chan_noise(7, 3, 2, 100),
        np.random.default_rng((7, 3, 2)).normal(0, 60, 100))
    out = [b""] * channels

    def on_output(c, data):
        out[c] += bytes(data)

    bank = JBank(JDmrPipeline(channels=channels, sps=10, n_centuries=16),
                 on_output=on_output)
    for b in range(got["blocks"]):
        bank.push(dmr_soak.noisy_block(base, b, range(channels), 7))
    bank.flush()
    assert got["outputs"] == out


def test_unscreened_campaign_has_no_unclassified_mismatch():
    result = torch_soak.campaign(10, 0)
    assert result["cases"] == 10 and result["channel_streams"] == 20
    assert not result["unclassified"], result["unclassified"]
    assert result["bytes"] > 0 and result["events"] > 0
    protos = [r["proto"] for r in result["records"]]
    assert sorted(set(protos)) == sorted(torch_soak.PROTOCOLS)


@pytest.mark.parametrize("proto", list(fuzz_timesharded.PROTOS))
def test_fuzz_timesharded_on_the_cpu_mesh(proto):
    r = fuzz_timesharded.run(cases=1, seed0=3, channels=2, device="cpu",
                             proto=proto, log=lambda text: None)
    assert r["ok"] and not r["divergences"]
    assert r["protocols"][proto] == 1 and r["bytes"] > 0


def test_soak_main_prints_its_line(capsys):
    rc = soak_main.main(["dmr", "--device", "cpu", "--channels", "2",
                         "--frames", "12"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert line["program"] == "dmr_soak" and line["ok"] is True
    assert line["frames_expected"] == 12 and line["card"] is None
    assert line["backend"] == "cpu" and "outputs" not in line


@pytest.mark.parametrize("run", [
    dmr_soak.run, impaired.run, ser_equiv.run, ber_sweep.run,
    fuzz_timesharded.run, lambda device: soak_main.main(["dmr"])])
def test_device_none_is_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(device=None)


def test_classify_shortfall_explains_or_flags_missing_frames():
    """A missing frame is explained by a classified symbol error in its
    pair's windows; a shortfall no symbol error covers is UNCLASSIFIED."""
    def window(f):
        return 100 + 144 * f, 244 + 144 * f

    tx = np.zeros(1200, np.uint8)
    dev = tx.copy()
    dev[100 + 144 * 3 + 50] = 2     # frame 3 (pair 1): the oracle agrees
    trace = (dev.copy(), [1.0] * 1200, [(99, 1.0, 0)])
    out = classify.classify_shortfall(dev, lambda: trace, tx, window, 3, 2)
    assert [(f, v["verdict"]) for f, v in out] == [(2, "noise-error(1sym)")]
    out = classify.classify_shortfall(dev, lambda: trace, tx, window, 3, 1)
    assert out[-1][1] == {"verdict": "UNCLASSIFIED", "unexplained_frames": 1}
    assert classify.classify_shortfall(tx, None, tx, window, 3, 3) == []
