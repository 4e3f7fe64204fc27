"""Kernel K4's plain version and its streaming wrapper on the CPU against
the JAX package's many-channel FIR: the Pallas kernel in interpret mode
(``digiham_tpu.ops.fir.rrc_filter_block_pallas``, as tests/test_pallas_ops.py
runs it) and the XLA convolution (``rrc_filter_block(impl="xla")``), for the
81- and 161-tap designs and a 129-tap asymmetric one, block lengths around
the history length and off the tile size, chained over 3 blocks with the
history carried.

Tolerances: against a numpy float32 tap loop in the stated order (each
product and each sum rounded on its own) the difference must be 0. Against
interpret-mode Pallas, which sums in the same order, and against the
convolution, which sums in another, at most 2e-6 of the block's peak: XLA's
CPU backend may contract a multiply-add into one FMA (one rounding fewer
per tap; observed: single-ulp differences). The histories are raw input:
equal.

Also here: a numpy float32 emulation of the kernel's tiling (a tile's
window staged with everything else poisoned with NaN, 7 consecutive outputs
a thread through ``fir_span``: 8 taps a step, then one tap a step) against
the plain version, ``array_equal``; the shared-memory carve-up; and the
build's library name, which must change when only a header changes.
"""
import shutil
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp import rrc as j_rrc
from digiham_tpu.ops.fir import rrc_filter_block_pallas
from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.ops import fir

torch.set_num_threads(1)

C = 4
CUSTOM_129 = rrc.RrcDesign(
    "custom129", 3.0,
    tuple(float(t) for t in np.random.default_rng(129).normal(0, 0.3, 129)))
DESIGNS = {"wide": rrc.WIDE_RRC, "narrow": rrc.NARROW_RRC,
           "custom129": CUSTOM_129}
LENGTHS = [1, 79, 80, 81, 1000, 1003]
RTOL = 2e-6  # of the block's peak


def _numpy_tap_loop(x, hist, taps):
    """y and new history of [hist | x] in float32 numpy, tap by tap."""
    full = np.concatenate([hist, x], axis=1)
    T = x.shape[1]
    y = taps[0] * full[:, :T]
    for j in range(1, len(taps)):
        y = y + taps[j] * full[:, j:j + T]
    assert y.dtype == np.float32
    return y, full[:, full.shape[1] - (len(taps) - 1):]


def _blocks(seed, T, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(C, T)) * 2000).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("name", list(DESIGNS))
def test_plain_matches_interpreted_pallas(name, T):
    """Three chained blocks through ``rrc_filter_block(device cpu)``, the
    Pallas kernel in interpret mode and the numpy tap loop: the numpy loop
    equal bit for bit, Pallas within RTOL, histories equal."""
    design = DESIGNS[name]
    st = rrc.RrcState.init(C, design, device="cpu")
    j_hist = jnp.zeros((C, design.ntaps - 1), jnp.float32)
    for x in _blocks(T, T):
        n_y, n_hist = _numpy_tap_loop(x, st.history.numpy(),
                                      design.scaled_taps)
        y, st = rrc.rrc_filter_block(torch.from_numpy(x), st, design)
        j_y, j_hist = rrc_filter_block_pallas(
            jnp.asarray(x), j_hist, design.scaled_taps, interpret=True)
        assert y.dtype == torch.float32 and y.shape == (C, T)
        assert np.array_equal(y.numpy(), n_y)
        peak = max(np.abs(n_y).max(), np.abs(x).max())
        assert np.abs(y.numpy() - np.asarray(j_y)).max() <= RTOL * peak
        assert np.array_equal(st.history.numpy(), n_hist)
        assert np.array_equal(st.history.numpy(), np.asarray(j_hist))


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("name", list(DESIGNS))
def test_plain_matches_xla_conv(name, T):
    """The same chain against the JAX package's convolution."""
    design = DESIGNS[name]
    j_design = j_rrc.RrcDesign(design.name, design.gain, design.taps)
    st = rrc.RrcState.init(C, design, device="cpu")
    j_st = j_rrc.RrcState.init(C, j_design)
    taps = design.taps_tensor("cpu")
    for x in _blocks(100 + T, T):
        y, hist = fir.rrc_filter_block_kernel(torch.from_numpy(x),
                                              st.history, taps)
        st = rrc.RrcState(hist)
        j_y, j_st = j_rrc.rrc_filter_block(jnp.asarray(x), j_st, j_design,
                                           impl="xla")
        # the peak of the whole block: at T = 1 one output may cancel
        peak = max(np.abs(np.asarray(j_y)).max(), np.abs(x).max())
        assert np.abs(y.numpy() - np.asarray(j_y)).max() <= RTOL * peak
        assert np.array_equal(hist.numpy(), np.asarray(j_st.history))


def test_fir_cmajor_is_the_plain_loop_on_the_cpu():
    rng = np.random.default_rng(5)
    taps = rrc.WIDE_RRC.taps_tensor("cpu")
    x = torch.from_numpy(rng.normal(0, 500, (3, 1080)).astype(np.float32))
    y = fir.fir_cmajor(x, taps)
    assert y.shape == (3, 1000)
    assert torch.equal(y, fir.fir_cmajor_plain(x, taps))
    # the first output by hand, in the fixed order
    acc = np.float32(taps[0].item()) * x[0, 0].numpy()
    for j in range(1, 81):
        acc = np.float32(acc + np.float32(taps[j].item()) * x[0, j].numpy())
    assert y[0, 0].item() == acc
    # a strided view is taken as it is
    wide = torch.cat([x, x], dim=1)
    assert torch.equal(fir.fir_cmajor(wide[:, :1080], taps), y)
    # one whose time stride is not 1 is made contiguous, not reinterpreted
    assert torch.equal(fir.fir_cmajor(wide[:, ::2][:, :540], taps),
                       fir.fir_cmajor_plain(wide[:, ::2][:, :540], taps))
    assert fir.LAUNCHES == 0  # CPU tensors never count as kernel launches


def test_empty_and_short_blocks():
    """T = 0 filters nothing and keeps the history; T < ntaps-1 makes the
    new history from old history and samples; it is always a copy."""
    taps = rrc.WIDE_RRC.taps_tensor("cpu")
    hist = torch.arange(2 * 80, dtype=torch.float32).reshape(2, 80)
    y, new = fir.rrc_filter_block_kernel(torch.zeros((2, 0)), hist, taps)
    assert y.shape == (2, 0) and torch.equal(new, hist)
    assert new.data_ptr() != hist.data_ptr()
    x = torch.full((2, 5), -1.0)
    y, new = fir.rrc_filter_block_kernel(x, hist, taps)
    assert y.shape == (2, 5)
    assert torch.equal(new, torch.cat([hist[:, 5:], x], dim=1))
    long = torch.ones((2, 200))
    _, new = fir.rrc_filter_block_kernel(long, hist, taps)
    long.zero_()
    assert new.min() == 1.0  # not a view of the caller's samples


@pytest.mark.parametrize("bad", ["dtype", "history", "ndim", "short",
                                 "taps"])
def test_what_k4_does_not_take_raises(bad):
    taps = rrc.WIDE_RRC.taps_tensor("cpu")
    x = torch.zeros((2, 100))
    hist = torch.zeros((2, 80))
    with pytest.raises(ValueError):
        if bad == "dtype":
            fir.rrc_filter_block_kernel(x.double(), hist, taps)
        elif bad == "history":
            fir.rrc_filter_block_kernel(x, hist[:, :79], taps)
        elif bad == "ndim":
            fir.rrc_filter_block_kernel(x[0], hist, taps)
        elif bad == "short":
            fir.fir_cmajor(torch.zeros((2, 50)), taps)
        else:
            fir.fir_cmajor(x, taps.to(torch.float64))


def test_smem_bytes_fits_the_designs():
    from digiham_tpu_torch.ops.build import CSRC, SMEM_LIMIT

    # taps at [j + 3] rounded to 4 floats, the window with its halo and up
    # to 3 words of shift, the outputs
    assert fir.TILE == 1792
    assert fir.smem_bytes(81) == 4 * (84 + 1876 + 1792)
    assert fir.smem_bytes(161) == 4 * (164 + 1956 + 1792)
    # both stock designs leave room for 4 blocks and more on an SM
    assert 4 * fir.smem_bytes(161) < 227 * 1024 and \
        fir.smem_bytes(161) < 48 * 1024 < SMEM_LIMIT
    source = (CSRC / fir.SOURCE).read_text()
    assert f"constexpr int THREADS = {fir.THREADS};" in source
    assert f"constexpr int FIR_OUTPUTS = {fir.FIR_OUTPUTS};" in source


FIR_UNROLL = 8  # taps per step of the register window (csrc/fir_span.cuh)


def _fir_span(x, taps, R):
    """csrc/fir_span.cuh in numpy float32 for a batch of spans: x [n, R - 1
    + ntaps] -> acc [n, R], through the sliding window w of R - 1 +
    FIR_UNROLL registers: FIR_UNROLL taps a step, then one tap a step."""
    ntaps = len(taps)
    w = np.full((x.shape[0], R - 1 + FIR_UNROLL), np.nan, np.float32)
    w[:, :R] = x[:, :R]
    acc = taps[0] * w[:, :R]
    w[:, :R - 1] = w[:, 1:R]
    j = 1

    def step(j, U):
        nonlocal acc
        w[:, R - 1:R - 1 + U] = x[:, j + R - 1:j + R - 1 + U]
        for jj in range(U):
            acc = acc + taps[j + jj] * w[:, jj:jj + R]
        w[:, :R - 1] = w[:, U:U + R - 1].copy()

    while j + FIR_UNROLL <= ntaps:
        step(j, FIR_UNROLL)
        j += FIR_UNROLL
    while j < ntaps:
        step(j, 1)
        j += 1
    assert acc.dtype == np.float32
    return acc


def _tiled_fir(full, taps):
    """csrc/fir.cu's tiling in numpy: per tile of TILE outputs a window of
    n_out + ntaps - 1 staged inputs (NaN beyond), a span of FIR_OUTPUTS
    outputs per thread, spans past the tile's end skipped, a straddling
    span's surplus dropped."""
    R, halo = fir.FIR_OUTPUTS, len(taps) - 1
    T = full.shape[1] - halo
    y = np.full((full.shape[0], T), np.nan, np.float32)
    for c in range(full.shape[0]):
        for t0 in range(0, T, fir.TILE):
            n_out = min(fir.TILE, T - t0)
            win = np.full(fir.TILE + halo, np.nan, np.float32)
            win[:n_out + halo] = full[c, t0:t0 + n_out + halo]
            firsts = np.arange(0, n_out, R)
            idx = firsts[:, None] + np.arange(R - 1 + len(taps))[None, :]
            acc = _fir_span(win[idx], taps, R).reshape(-1)[:n_out]
            y[c, t0:t0 + n_out] = acc
    return y


@pytest.mark.parametrize("T", [1, fir.FIR_OUTPUTS - 1, fir.FIR_OUTPUTS,
                               fir.FIR_OUTPUTS + 1, fir.TILE - 1, fir.TILE,
                               fir.TILE + 1])
@pytest.mark.parametrize("ntaps", [1, 2, 9, 10, 81, 82, 129, 161])
def test_register_window_tiling_is_the_plain_version(ntaps, T):
    """The kernel's order of loads and sums, emulated, touches no value
    outside its window and equals the plain tap loop bit for bit."""
    rng = np.random.default_rng(ntaps * 10000 + T)
    taps = rng.normal(0, 0.3, ntaps).astype(np.float32)
    full = (rng.normal(size=(2, T + ntaps - 1)) * 2000).astype(np.float32)
    got = _tiled_fir(full, taps)
    want = fir.fir_cmajor_plain(torch.from_numpy(full),
                                torch.from_numpy(taps)).numpy()
    assert not np.isnan(got).any()
    assert np.array_equal(got, want)


def test_library_name_covers_the_shared_header(tmp_path):
    """A library is named by a hash of its source and of every header
    beside it: editing only fir_span.cuh renames the libraries of both
    sources that include it, so no stale build is ever loaded. Nothing is
    compiled here."""
    from digiham_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = {src: build.library_path(src, csrc, tmp_path).name
             for src in ("fir.cu", "demod_front.cu", "viterbi.cu")}
    assert names["fir.cu"] == build.library_path("fir.cu").name
    assert all(n.startswith(f"lib{src[:-3]}_") and n.endswith(".so")
               for src, n in names.items())
    header = csrc / "fir_span.cuh"
    assert '#include "fir_span.cuh"' in (csrc / "fir.cu").read_text()
    assert '#include "fir_span.cuh"' in (csrc / "demod_front.cu").read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    for src, name in names.items():
        assert build.library_path(src, csrc, tmp_path).name != name, src
    # and an edit to one source renames that source's library only
    shutil.copyfile(build.CSRC / "fir_span.cuh", header)
    (csrc / "fir.cu").write_text((csrc / "fir.cu").read_text() + "\n")
    assert build.library_path("fir.cu", csrc, tmp_path).name \
        != names["fir.cu"]
    assert build.library_path("viterbi.cu", csrc, tmp_path).name \
        == names["viterbi.cu"]


@pytest.mark.parametrize("design", ["wide", "narrow"])
def test_rrc_filter_np_equals_jax(design):
    """The per-sample float32 oracle, copied: equal, with and without a
    history."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=300) * 1000).astype(np.float32)
    hist = (rng.normal(size=DESIGNS[design].ntaps - 1) * 1000).astype(
        np.float32)
    jd = {"wide": j_rrc.WIDE_RRC, "narrow": j_rrc.NARROW_RRC}[design]
    for h in (None, hist):
        assert np.array_equal(rrc.rrc_filter_np(x, DESIGNS[design], h),
                              j_rrc.rrc_filter_np(x, jd, h))


@pytest.mark.parametrize("design", ["wide", "narrow"])
def test_rrc_stream_np_equals_jax_in_chunks(design):
    """The CLI's numpy stream: the same bytes chunk for chunk, and within
    the f32 envelope of the streaming torch filter."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=5000) * 1000).astype(np.float32)
    jd = {"wide": j_rrc.WIDE_RRC, "narrow": j_rrc.NARROW_RRC}[design]
    ours, theirs = rrc.RrcStreamNp(DESIGNS[design]), j_rrc.RrcStreamNp(jd)
    state = rrc.RrcState.init(1, DESIGNS[design], device="cpu")
    for lo, hi in ((0, 1), (1, 1700), (1700, 5000)):
        a, b = ours.process(x[lo:hi]), theirs.process(x[lo:hi])
        assert a.tobytes() == b.tobytes()
        y, state = rrc.rrc_filter(torch.from_numpy(x[None, lo:hi]), state,
                                  DESIGNS[design])
        np.testing.assert_allclose(y[0].numpy(), a, rtol=1e-4, atol=2e-2)
