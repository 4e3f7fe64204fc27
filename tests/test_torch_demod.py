"""The port's front end against the JAX package's: the FM discriminator,
the RRC filter (wide, narrow and an asymmetric 129-tap design), and the
plain versions of kernels K1 (FM + RRC + century demod), K2 (RRC +
century demod of FM audio) and K3 (century demod of filtered samples)
over three chained blocks, held against two references:

- the JAX package's unfused XLA chain (fm_discriminator, rrc_filter_block
  impl="xla", the XLA century scan);
- the Pallas kernels ``pallas_demod_fm_front_block``,
  ``pallas_demod_front_block`` and ``pallas_demod_block`` in interpret
  mode.

Decisions (dibits) and pos/offset must be equal. Floats differ only by
f32 rounding order, so they are held to stated tolerances: the random
streams are screened to be knife-edge free first.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp import rrc as j_rrc
from digiham_tpu.dsp.demod import DemodState as JDemodState
from digiham_tpu.dsp.demod import demod_init as j_demod_init
from digiham_tpu.dsp.demod import fsk_demod_block, gfsk_demod_block
from digiham_tpu.dsp.fm import fm_discriminator as j_fm
from digiham_tpu.ops.demod_pallas import (pallas_demod_block,
                                          pallas_demod_fm_front_block,
                                          pallas_demod_front_block)
from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.dsp.demod import (DemodState, demod_init,
                                         fm_rrc_demod_block, fold_sum,
                                         rrc_demod_block)
from digiham_tpu_torch.dsp.demod import fsk_demod_block as p_fsk_demod_block
from digiham_tpu_torch.dsp.demod import gfsk_demod_block as p_gfsk_demod_block
from digiham_tpu_torch.dsp.fm import fm_discriminator
from digiham_tpu_torch.ops import demod_front

from torch_parity import (FOUR_LEVELS, TWO_LEVELS, audio_knife_edge_free,
                          fsk_audio, fsk_iq, knife_edge_free)

torch.set_num_threads(1)

C, SPS, NC, BLOCKS = 8, 10, 3, 3
ADVANCE = NC * 100 * SPS - NC  # below the fewest samples a block consumes
L = 3040                       # >= max(pos) + NC*(100*SPS+1) + 1
N = (BLOCKS - 1) * ADVANCE + L
FM_SCALE = 5000.0
HALO = rrc.WIDE_RRC.ntaps - 1
DRIFT = 5e-4  # TX clock offset: about one slew every two centuries
# ring: volume means of ~5e2-sized filtered samples; 81-term f32 sums in
# another order differ by a few ulp (~1e-4), far below 1e-3
RING_ATOL = 1e-3
# RRC history: fm_scale * audio; the two atan2 implementations differ by
# <= 2 ulp of the audio, ~1e-4 at these deviations, below 1e-3
HIST_ATOL = 1e-3


def _complex(re, im):
    return jnp.asarray(re + 1j * im.astype(np.complex64))


def test_fm_discriminator_matches_jax():
    rng = np.random.default_rng(1)
    re = rng.normal(size=(C, 2000)).astype(np.float32)
    im = rng.normal(size=(C, 2000)).astype(np.float32)
    last = rng.normal(size=(2, C)).astype(np.float32)
    ours, (lre, lim) = fm_discriminator(
        *(torch.from_numpy(a) for a in (re, im, last[0], last[1])))
    ref, ref_last = j_fm(_complex(re, im), _complex(last[0], last[1]))
    # audio is a phase step / pi in [-1, 1]: the two atan2s differ by a
    # few ulp, and an f32 ulp below 1 is 6e-8
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-7)
    assert np.array_equal(lre.numpy(), np.asarray(ref_last).real)
    assert np.array_equal(lim.numpy(), np.asarray(ref_last).imag)


CUSTOM_129 = rrc.RrcDesign(
    "custom129", 3.0,
    tuple(float(t) for t in np.random.default_rng(129).normal(0, 0.3, 129)))


@pytest.mark.parametrize("name", ["wide", "narrow", "custom129"])
def test_rrc_filter_block_matches_jax(name):
    """Three chained blocks; the asymmetric design catches a flipped tap
    order (the stock designs are palindromes)."""
    design = {"wide": rrc.WIDE_RRC, "narrow": rrc.NARROW_RRC,
              "custom129": CUSTOM_129}[name]
    j_design = j_rrc.RrcDesign(design.name, design.gain, design.taps)
    rng = np.random.default_rng(2)
    st = rrc.RrcState.init(C, design, device="cpu")
    j_st = j_rrc.RrcState.init(C, j_design)
    for _ in range(3):
        x = (rng.normal(size=(C, 1500)) * 2000).astype(np.float32)
        hist0 = st.history.numpy().astype(np.float64)
        y, st = rrc.rrc_filter_block(torch.from_numpy(x), st, design)
        xf = np.concatenate([hist0, x], axis=1)
        j_y, j_st = j_rrc.rrc_filter_block(jnp.asarray(x), j_st, j_design,
                                           impl="xla")
        # two f32 sums of the same ntaps terms in different orders: each
        # is within ntaps * 2^-24 * sum|terms| of the exact sum
        # (recursive-summation bound), so they differ by at most twice that
        mag = np.stack([np.abs(design.scaled_taps) @ np.abs(
            xf[c, t:t + design.ntaps]) for c in range(C)
            for t in range(0, x.shape[1], 97)])
        bound = 2 * design.ntaps * 2.0 ** -24 * mag.max()
        assert np.abs(y.numpy() - np.asarray(j_y)).max() <= bound
        # the carry is raw input
        assert np.array_equal(st.history.numpy(), np.asarray(j_st.history))


def test_fold_sum_order():
    """fold_sum adds in the documented pairwise order (x[i] + x[i+h])."""
    x = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0]])
    assert fold_sum(x, -1).item() == 31.0
    big = torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32)
    # h=2: [1e8 + -1e8, 1.0] -> 0 + 1 = 1 (a left-to-right sum gives 0)
    assert fold_sum(big, 0).item() == 1.0


def _stream(mode, seed):
    """Knife-edge-free random FSK streams, one per channel."""
    levels = FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS
    rng = np.random.default_rng(seed)
    re, im = fsk_iq(rng, C, N, SPS, levels, drift=DRIFT)
    for c in range(C):
        while not knife_edge_free(re[c], im[c], BLOCKS * NC * 100, SPS,
                                  j_rrc.WIDE_RRC, mode=mode,
                                  invert=mode != "gfsk"):
            r1, i1 = fsk_iq(rng, 1, N, SPS, levels, drift=DRIFT)
            re[c], im[c] = r1[0], i1[0]
    return re, im


def _port_chain(re, im, mode, invert):
    re_t, im_t = torch.from_numpy(re), torch.from_numpy(im)
    rrc_st = rrc.RrcState.init(C, device="cpu")
    dm = demod_init(C, device="cpu")
    last = (torch.ones(C), torch.zeros(C))
    outs = []
    for b in range(BLOCKS):
        o = b * ADVANCE
        if b:  # rebase: history and carry from the samples before o
            audio, _ = fm_discriminator(re_t[:, o - HALO:o],
                                        im_t[:, o - HALO:o],
                                        re_t[:, o - HALO - 1],
                                        im_t[:, o - HALO - 1])
            rrc_st = rrc.RrcState(audio * FM_SCALE)
            dm = DemodState(dm.pos - ADVANCE, dm.offset, dm.volume_ring)
            last = (re_t[:, o - 1], im_t[:, o - 1])
        dib, new_rrc, dm, _ = fm_rrc_demod_block(
            re_t[:, o:o + L], im_t[:, o:o + L], *last, rrc_st, dm, NC, SPS,
            rrc.WIDE_RRC, mode=mode, invert=invert, fm_scale=FM_SCALE)
        outs.append((dib.numpy(), dm.pos.numpy(), dm.offset.numpy(),
                     dm.volume_ring.numpy(), new_rrc.history.numpy()))
    return outs


def _jax_chain(re, im, mode, invert, pallas):
    rrc_st = j_rrc.RrcState.init(C)
    dm = j_demod_init(C)
    last = (jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.float32))
    taps = j_rrc.WIDE_RRC.scaled_taps.tobytes()
    outs = []
    for b in range(BLOCKS):
        o = b * ADVANCE
        if b:
            audio, _ = j_fm(_complex(re[:, o - HALO:o], im[:, o - HALO:o]),
                            _complex(re[:, o - HALO - 1], im[:, o - HALO - 1]))
            rrc_st = j_rrc.RrcState(audio * FM_SCALE)
            dm = JDemodState(dm.pos - ADVANCE, dm.offset, dm.volume_ring)
            last = (jnp.asarray(re[:, o - 1]), jnp.asarray(im[:, o - 1]))
        blk_re, blk_im = re[:, o:o + L], im[:, o:o + L]
        # both references' RRC carry: the unfused chain's audio tail
        audio, _ = j_fm(_complex(blk_re, blk_im), _complex(*last))
        audio = audio * FM_SCALE
        filt, new_rrc = j_rrc.rrc_filter_block(audio, rrc_st,
                                               j_rrc.WIDE_RRC, impl="xla")
        if pallas:
            dib, dm = pallas_demod_fm_front_block(
                jnp.asarray(blk_re), jnp.asarray(blk_im), *last,
                rrc_st.history, dm, taps=taps, n_centuries=NC, sps=SPS,
                mode=mode, invert=invert, tile=8, interpret=True)
        elif mode == "gfsk":
            dib, dm = gfsk_demod_block(filt, dm, NC, SPS, impl="xla")
        else:
            dib, dm = fsk_demod_block(filt, dm, NC, SPS, invert, impl="xla")
        outs.append(tuple(np.asarray(a) for a in (
            dib, dm.pos, dm.offset, dm.volume_ring, new_rrc.history)))
    return outs


@pytest.mark.parametrize("mode,invert,seed", [("gfsk", False, 31),
                                              ("fsk", True, 32)])
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_plain_k1_matches_jax(mode, invert, seed, reference):
    re, im = _stream(mode, seed)
    ours = _port_chain(re, im, mode, invert)
    ref = _jax_chain(re, im, mode, invert, reference != "xla")
    slews = 0
    for b, (o, r) in enumerate(zip(ours, ref)):
        assert o[0].dtype == r[0].dtype == np.uint8
        assert np.array_equal(o[0], r[0]), b            # dibits
        assert np.array_equal(o[1], r[1]), b            # pos
        assert np.array_equal(o[2], r[2]), b            # offset
        assert np.abs(o[3] - r[3]).max() <= RING_ATOL, b
        assert np.abs(o[4] - r[4]).max() <= HIST_ATOL, b
        slews += int(np.abs(o[2]).sum())
    assert slews > 0  # the timing loop was exercised


def _lowpass_129():
    """An asymmetric 129-tap low-pass (a windowed sinc under a ramp): a
    design of neither stock length, whose flipped tap order would show."""
    n = np.arange(129) - 64
    taps = np.sinc(n / 8.0) * np.hamming(129) * (1.0 + 0.2 * n / 64.0)
    return rrc.RrcDesign("lowpass129", float(taps.sum()),
                         tuple(float(t) for t in taps))


# name -> (design or None for filtered input, sps, centuries, mode, invert)
AUDIO_CASES = {
    "wide81_sps10": (rrc.WIDE_RRC, 10, 3, "gfsk", False),
    "narrow161_sps20": (rrc.NARROW_RRC, 20, 2, "gfsk", False),
    "custom129_sps10": (_lowpass_129(), 10, 3, "gfsk", False),
    "fsk_inverted_sps40": (rrc.WIDE_RRC, 40, 2, "fsk", True),
}


def _audio_geometry(sps, nc, blocks=BLOCKS):
    advance = nc * 100 * sps - nc
    length = nc * (100 * sps + 1) + 1 + 2 * blocks * nc
    return advance, length, (blocks - 1) * advance + length


def _audio_stream(design, sps, nc, mode, invert, seed, channels=C,
                  blocks=BLOCKS):
    """Knife-edge-free FM audio [channels, N] and its filtered twin
    (float32, as the reference's streaming RRC from stream start gives
    it)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    levels = FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS
    n = _audio_geometry(sps, nc, blocks)[2]
    rng = np.random.default_rng(seed)
    x = fsk_audio(rng, channels, n, sps, levels, drift=DRIFT)
    filt = np.empty_like(x)
    for c in range(channels):
        while True:
            filt[c] = rrc_np(x[c], design)
            if audio_knife_edge_free(filt[c], blocks * nc * 100, sps, mode,
                                     invert):
                break
            x[c] = fsk_audio(rng, 1, n, sps, levels, drift=DRIFT)[0]
    return x, filt


def _j_design(design):
    return j_rrc.RrcDesign(design.name, design.gain, design.taps)


def _port_audio_chain(x, design, sps, nc, mode, invert, blocks=BLOCKS):
    """The port's rrc_demod_block (design given: K2's plain version) or
    gfsk/fsk_demod_block (filtered input: K3's) over chained blocks."""
    advance, length, _ = _audio_geometry(sps, nc, blocks)
    channels = x.shape[0]
    x_t = torch.from_numpy(x)
    dm = demod_init(channels, device="cpu")
    st = rrc.RrcState.init(channels, design or rrc.WIDE_RRC, device="cpu")
    halo = st.history.shape[-1]
    outs = []
    for b in range(blocks):
        o = b * advance
        if b:
            st = rrc.RrcState(x_t[:, o - halo:o])
            dm = DemodState(dm.pos - advance, dm.offset, dm.volume_ring)
        blk = x_t[:, o:o + length]
        if design is not None:
            dib, st, dm = rrc_demod_block(blk, st, dm, nc, sps, design,
                                          mode=mode, invert=invert)
        elif mode == "gfsk":
            dib, dm = p_gfsk_demod_block(blk, dm, nc, sps)
        else:
            dib, dm = p_fsk_demod_block(blk, dm, nc, sps, invert)
        outs.append((dib.numpy(), dm.pos.numpy(), dm.offset.numpy(),
                     dm.volume_ring.numpy(), st.history.numpy()))
    return outs


def _jax_audio_chain(x, design, sps, nc, mode, invert, pallas,
                     blocks=BLOCKS):
    advance, length, _ = _audio_geometry(sps, nc, blocks)
    jd = _j_design(design or rrc.WIDE_RRC)
    dm = j_demod_init(x.shape[0])
    st = j_rrc.RrcState.init(x.shape[0], jd)
    halo = jd.ntaps - 1
    kw = dict(mode=mode, invert=invert, tile=8, interpret=True)
    outs = []
    for b in range(blocks):
        o = b * advance
        if b:
            st = j_rrc.RrcState(jnp.asarray(x[:, o - halo:o]))
            dm = JDemodState(dm.pos - advance, dm.offset, dm.volume_ring)
        blk = jnp.asarray(x[:, o:o + length])
        filt = blk
        if design is not None:
            # the carry (raw input tail) comes from the unfused filter
            filt, new_st = j_rrc.rrc_filter_block(blk, st, jd, impl="xla")
        if pallas and design is not None:
            dib, dm = pallas_demod_front_block(
                blk, st.history, dm, taps=jd.scaled_taps.tobytes(),
                n_centuries=nc, sps=sps, **kw)
        elif pallas:
            dib, dm = pallas_demod_block(blk, dm, nc, sps, dma=True, **kw)
        elif mode == "gfsk":
            dib, dm = gfsk_demod_block(filt, dm, nc, sps, impl="xla")
        else:
            dib, dm = fsk_demod_block(filt, dm, nc, sps, invert, impl="xla")
        if design is not None:
            st = new_st
        outs.append(tuple(np.asarray(a) for a in (
            dib, dm.pos, dm.offset, dm.volume_ring, st.history)))
    return outs


@pytest.mark.parametrize("case", list(AUDIO_CASES))
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_plain_k2_k3_match_jax(kernel, reference, case):
    """K2's plain version on FM audio and K3's on the filtered stream,
    over 3 chained blocks: dibits, pos and offset equal; the volume ring
    within RING_ATOL; K2's RRC carry (the raw input tail) bitwise equal."""
    design, sps, nc, mode, invert = AUDIO_CASES[case]
    x, filt = _audio_stream(design, sps, nc, mode, invert,
                            seed=40 + list(AUDIO_CASES).index(case))
    if kernel == "k3":
        x, design = filt, None
    ours = _port_audio_chain(x, design, sps, nc, mode, invert)
    ref = _jax_audio_chain(x, design, sps, nc, mode, invert,
                           reference != "xla")
    slews = 0
    for b, (o, r) in enumerate(zip(ours, ref)):
        assert o[0].dtype == r[0].dtype == np.uint8
        assert np.array_equal(o[0], r[0]), b            # dibits
        assert np.array_equal(o[1], r[1]), b            # pos
        assert np.array_equal(o[2], r[2]), b            # offset
        assert np.abs(o[3] - r[3]).max() <= RING_ATOL, b
        assert np.array_equal(o[4], r[4]), b            # RRC history
        slews += int(np.abs(o[2]).sum())
    assert slews > 0  # the timing loop was exercised


def test_k2_k3_wrappers_route_cpu_to_plain():
    """On CPU tensors the K2 and K3 wrappers are their plain versions and
    launch nothing."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(fsk_audio(rng, 2, L, SPS, FOUR_LEVELS))
    state = [torch.zeros(2, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32), torch.zeros(2, 100)]
    front = [x, torch.zeros(2, 80), rrc.WIDE_RRC.taps_tensor(None), *state]
    before = dict(demod_front.LAUNCHES)
    for got, want in [
            (demod_front.demod_front(*front, n_centuries=NC, sps=SPS),
             demod_front.demod_front_plain(*front, n_centuries=NC, sps=SPS)),
            (demod_front.demod(x, *state, n_centuries=NC, sps=SPS),
             demod_front.demod_plain(x, *state, n_centuries=NC, sps=SPS))]:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert demod_front.LAUNCHES == before


def test_k1_wrapper_routes_cpu_to_plain():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    rng = np.random.default_rng(4)
    re, im = fsk_iq(rng, 2, L, SPS, FOUR_LEVELS)
    args = [torch.from_numpy(re), torch.from_numpy(im), torch.ones(2),
            torch.zeros(2), torch.zeros(2, 80), rrc.WIDE_RRC.taps_tensor(None),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, 100)]
    before = dict(demod_front.LAUNCHES)
    got = demod_front.demod_fm_front(*args, n_centuries=NC, sps=SPS)
    want = demod_front.demod_fm_front_plain(*args, n_centuries=NC, sps=SPS)
    assert demod_front.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_smem_budget_matches_kernel_carve_up():
    """The wrapper's shared-memory size for the main path (81 taps, sps
    10, 16 centuries) is the kernel's carve-up: two input slots of two
    planes for the widest window (1,033 samples + 80 of history + the
    sample before + slack), one discriminated and two filtered windows,
    the taps, the row-fold scratch, ring + volumes, mid means and two sets
    of column variances, sps each. Two blocks and more fit one SM."""
    need = demod_front.smem_bytes(81, 10, 16)
    assert need == 4 * (2 * 2 * 1124 + 1124 + 2 * 1036 + 84 + 500 + 1700
                        + 1600 + 2 * 10)
    assert 2 * need <= 232448
    assert need <= demod_front.SMEM_LIMIT


def test_smem_budget_of_the_audio_paths():
    """K2 and K3 at their bank shapes (YSF: 10 centuries at sps 10, 81
    taps; NXDN: 4 centuries at sps 20, 161 taps) and at the JAX throughput
    script's longer blocks (DMR 32, YSF 40, NXDN 16 centuries at sps 20):
    all fit, two blocks to an SM at least; nothing depends on the block
    length (it is no argument); the extremes still raise through
    SMEM_LIMIT."""
    ysf = demod_front.smem_bytes(81, 10, 10, "rrc")
    assert ysf == 4 * (2 * 1112 + 2 * 1024 + 84 + 500 + 1100 + 1000 + 2 * 10)
    nxdn = demod_front.smem_bytes(161, 20, 4, "rrc")
    assert nxdn == 4 * (2 * 2180 + 2 * 2012 + 164 + 1000 + 500 + 400 + 2 * 20)
    k3 = demod_front.smem_bytes(0, 40, 15, "none")
    assert k3 == demod_front.smem_bytes(161, 40, 15, "none")
    assert k3 == 4 * (2 * 4040 + 2000 + 1600 + 1500 + 2 * 40)
    bench = [demod_front.smem_bytes(81, 10, 32),          # K1, DMR 32
             demod_front.smem_bytes(81, 10, 32, "rrc"),
             demod_front.smem_bytes(81, 10, 40, "rrc"),   # YSF 40
             demod_front.smem_bytes(161, 20, 16, "rrc")]  # NXDN 16
    main = [demod_front.smem_bytes(81, 10, 16), ysf, nxdn,
            demod_front.smem_bytes(81, 10, 16, "rrc"),
            demod_front.smem_bytes(0, 10, 10, "none")]
    assert 2 * max(bench + main) <= 232448
    # the widest a block may ask for: sps up to 64 fits at 40 centuries
    # with 161 taps; K3 at the cap of 128 and K2 at POCSAG's 512 baud (sps
    # 94, 81 taps) at 4 centuries (its bank's); a thousand centuries in one
    # block do not
    assert demod_front.smem_bytes(161, 64, 40) <= demod_front.SMEM_LIMIT
    assert demod_front.smem_bytes(0, demod_front.MAX_SPS, 4, "none") \
        <= demod_front.SMEM_LIMIT
    assert demod_front.smem_bytes(81, 94, 4, "rrc") <= demod_front.SMEM_LIMIT
    assert demod_front.smem_bytes(81, 10, 1000, "rrc") \
        > demod_front.SMEM_LIMIT


def test_non_cpu_audio_path_raises_naming_k2():
    """Off the CPU rrc_demod_block launches kernel K2 (K3 unfiltered) or
    raises; it never runs the plain chain there. Meta tensors stand in for
    a device with no kernel."""
    x = torch.empty((2, L), device="meta")
    st = rrc.RrcState(torch.empty((2, 80), device="meta"))
    dm = DemodState(torch.empty(2, dtype=torch.int32, device="meta"),
                    torch.empty(2, dtype=torch.int32, device="meta"),
                    torch.empty((2, 100), device="meta"))
    with pytest.raises(ValueError, match="no K2 kernel"):
        rrc_demod_block(x, st, dm, NC, SPS, rrc.WIDE_RRC)
    with pytest.raises(ValueError, match="no K3 kernel"):
        rrc_demod_block(x, st, dm, NC, SPS, None)


# --- the windowed design of K1 and K2, held on the CPU ---------------------
# The kernels filter one century window at a time. The card is not here,
# so these tests hold the algorithm: the window arithmetic and a windowed
# emulation built from the plain parts.

def _reads(pos, offset, sps):
    """(lowest, highest) index _symbol_matrix reads for one century:
    pos + i*sps + k + (offset if i > 0 else 0), i < 100, k < sps."""
    low = min(pos, pos + sps + offset)
    high = max(pos + sps - 1, pos + 100 * sps - 1 + offset)
    return low, high


@pytest.mark.parametrize("sps", [3, 10, 20, 40, 64, 94, 128])
def test_century_window_holds_every_read(sps):
    """Every index century c reads lies inside century_window(c): over
    seeded random entry states and slew sequences, the two extreme
    sequences, and the sequences the plain demod produces on a drifting
    stream."""
    from digiham_tpu_torch.dsp.demod import _century

    n, nc = 100 * sps, 40
    rng = np.random.default_rng(sps)
    walks = [(int(rng.integers(0, 2 * sps)), rng.integers(-1, 2, nc))
             for _ in range(200)]
    walks += [(0, np.full(nc, -1)), (0, np.full(nc, 1)), (5, np.zeros(nc, int))]
    # what the plain demod does: a TX clock 2e-3 fast, then slow
    for drift in (2e-3, -2e-3):
        length = nc * (n + 1) + 2 * sps + 1
        sym = rng.integers(0, 4, (2, length // sps + 64))
        at = (np.arange(length) / (sps * (1.0 + drift))).astype(np.int64)
        x = torch.from_numpy((FOUR_LEVELS[sym][:, at] * 800.0 + rng.normal(
            0, 40.0, (2, length))).astype(np.float32))
        pos = torch.tensor([0, sps + 1], dtype=torch.int32)
        off = torch.tensor([1, -1], dtype=torch.int32)
        ring = torch.zeros(2, 100)
        seq = [(pos.clone(), off.clone())]
        for _ in range(nc - 1):
            _, pos, off, ring = _century(x, pos, off, ring, sps, "gfsk", False)
            seq.append((pos.clone(), off.clone()))
        for ch in range(2):
            offs = np.array([int(o[ch]) for _, o in seq])
            assert np.abs(offs).sum() > nc // 4  # the loop did slew
            walks.append((int(seq[0][0][ch]), offs))
    for pos0, offs in walks:
        pos = pos0
        for c in range(nc):
            start, length = demod_front.century_window(c, sps)
            low, high = _reads(pos, int(offs[c]), sps)
            assert pos0 + start <= low and high < pos0 + start + length, c
            pos += n + int(offs[c])
    # the widest window sizes the slots
    assert demod_front.century_window(nc - 1, sps)[1] == n + 2 * nc + 1


def _windowed_front(rows, last, hist, taps, pos, offset, ring, *, n_centuries,
                    sps, mode="gfsk", invert=False, fm_scale=5000.0):
    """K1 (rows = (re, im), last = (last_re, last_im)) or K2 (rows =
    (samples,), last = None) as the kernels compute them: per century the
    inputs of century_window(c) behind their history (0 outside the row,
    the carried history before it), that window filtered by the plain FIR
    and zeroed outside [0, L), one _century on that window alone; the new
    history from the row's tail.

    On the CPU torch.atan2 differs by an ulp between a slice and the whole
    row (vector and scalar paths), which the card's atan2f does not. So
    K1's window is discriminated here as the kernel does it (the sample
    before the window, the carry at row 0) and held to the whole row's
    audio within HIST_ATOL, and the chain then runs on that audio."""
    from digiham_tpu_torch.dsp.demod import _century
    from digiham_tpu_torch.ops.fir import rrc_filter_block_plain

    fm = last is not None
    L = rows[0].shape[1]
    if fm:
        whole = fm_discriminator(*rows, *last)[0] * fm_scale
    halo = taps.shape[0] - 1
    lead = 1 if fm else 0
    pos0 = pos.to(torch.int64)
    pos, offset = pos.clone(), offset.clone()

    def fetch(plane, r, before=None):
        """plane[:, r] with 0 outside the row (``before`` at r == -1)."""
        v = torch.gather(plane, 1, r.clamp(0, L - 1))
        v = torch.where((r >= 0) & (r < L), v, 0.0)
        if before is not None:
            v = torch.where(r == -1, before[:, None], v)
        return v

    out = []
    for c in range(n_centuries):
        start, length = demod_front.century_window(c, sps)
        first = pos0 + start - halo - lead
        r = first[:, None] + torch.arange(length + halo + lead)
        in_hist = (r < 0) & (r >= -halo)
        carried = torch.where(
            in_hist, torch.gather(hist, 1, (halo + r).clamp(0, halo - 1)), 0.0)
        if fm:
            re = fetch(rows[0], r, last[0])
            im = fetch(rows[1], r, last[1])
            audio, _ = fm_discriminator(re[:, 1:], im[:, 1:], re[:, 0],
                                        im[:, 0])
            inside = (r[:, 1:] >= 0) & (r[:, 1:] < L)
            exact = fetch(whole, r[:, 1:])
            assert (torch.where(inside, audio * fm_scale, 0.0) - exact) \
                .abs().max() <= HIST_ATOL
            slot = torch.where(inside, exact, carried[:, 1:])
        else:
            slot = torch.where(in_hist, carried, fetch(rows[0], r))
        # the whole window filtered, 0 outside the row; the century reads
        # it from pos - ws on, and a read outside it would meet a NaN
        ws = pos0 + start
        filt, _ = rrc_filter_block_plain(slot[:, halo:], slot[:, :halo], taps)
        assert filt.shape[1] == length
        idx = ws[:, None] + torch.arange(length)
        filt = torch.where((idx >= 0) & (idx < L), filt, 0.0)
        guard = torch.full((filt.shape[0], 4), float("nan"))
        sym, local, new_offset, ring = _century(
            torch.cat([guard, filt, guard], dim=1),
            (pos - ws + 4).to(torch.int32), offset, ring, sps, mode, invert)
        assert not torch.isnan(ring).any()
        pos = (local + ws - 4).to(torch.int32)
        offset = new_offset
        out.append(sym)
    if fm:
        tail, _ = fm_discriminator(rows[0][:, L - halo:], rows[1][:, L - halo:],
                                   rows[0][:, L - halo - 1],
                                   rows[1][:, L - halo - 1])
        new_hist = whole[:, L - halo:].clone()
        assert (tail * fm_scale - new_hist).abs().max() <= HIST_ATOL
    else:
        new_hist = rows[0][:, L - halo:].clone()
    return torch.cat(out, dim=-1), pos, offset, ring, new_hist


# name -> (front, design, sps, centuries, mode, invert, entry pos, slack of
# the block length over (or under) max(pos) + nc*(100*sps+1) + 1)
WINDOW_CASES = {
    "k2_wide81_sps10": ("rrc", rrc.WIDE_RRC, 10, 3, "gfsk", False, None, 8),
    "k2_narrow161_sps20": ("rrc", rrc.NARROW_RRC, 20, 2, "gfsk", False, None,
                           8),
    "k2_lowpass129_sps10": ("rrc", _lowpass_129(), 10, 3, "gfsk", False, None,
                            8),
    "k2_fsk_inverted_sps40": ("rrc", rrc.WIDE_RRC, 40, 2, "fsk", True, None,
                              8),
    "k2_pos_0": ("rrc", rrc.WIDE_RRC, 10, 3, "gfsk", False, 0, 8),
    "k2_last_window_past_the_row": ("rrc", rrc.WIDE_RRC, 10, 3, "gfsk", False,
                                    None, -40),
    "k2_row_much_longer": ("rrc", rrc.WIDE_RRC, 10, 2, "gfsk", False, None,
                           5000),
    "k2_one_century": ("rrc", rrc.WIDE_RRC, 10, 1, "gfsk", False, None, 8),
    "k2_40_centuries": ("rrc", rrc.WIDE_RRC, 10, 40, "gfsk", False, None, 8),
    "k1_wide81_sps10": ("fm_rrc", rrc.WIDE_RRC, 10, 3, "gfsk", False, None,
                        8),
    "k1_pos_0": ("fm_rrc", rrc.WIDE_RRC, 10, 2, "gfsk", False, 0, 8),
    "k1_fsk_inverted_sps20_161": ("fm_rrc", rrc.NARROW_RRC, 20, 2, "fsk",
                                  True, None, 8),
    "k1_last_window_past_the_row": ("fm_rrc", rrc.WIDE_RRC, 10, 2, "gfsk",
                                    False, None, -40),
    "k1_row_much_longer": ("fm_rrc", rrc.WIDE_RRC, 10, 1, "gfsk", False, None,
                           3000),
    "k1_32_centuries": ("fm_rrc", rrc.WIDE_RRC, 10, 32, "gfsk", False, None,
                        8),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_front_equals_plain(case):
    """Filtering one century window at a time gives the plain version's
    dibits, pos, offset, ring and history bit for bit, with random entry
    pos, pending slews of -1, 0 and +1, and a random carried history."""
    front, design, sps, nc, mode, invert, pos0, slack = WINDOW_CASES[case]
    channels = 3
    rng = np.random.default_rng(list(WINDOW_CASES).index(case))
    halo = design.ntaps - 1
    pos = (rng.integers(0, 2 * sps, channels) if pos0 is None
           else np.full(channels, pos0)).astype(np.int32)
    length = int(pos.max()) + nc * (100 * sps + 1) + 1 + slack
    levels = FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS
    state = [torch.from_numpy(pos),
             torch.tensor([-1, 0, 1], dtype=torch.int32),
             torch.from_numpy(rng.normal(0, 300, (channels, 100))
                              .astype(np.float32))]
    hist = torch.from_numpy(rng.normal(0, 300, (channels, halo))
                            .astype(np.float32))
    taps = design.taps_tensor("cpu")
    kw = dict(n_centuries=nc, sps=sps, mode=mode, invert=invert)
    if front == "fm_rrc":
        re, im = (torch.from_numpy(a) for a in fsk_iq(
            rng, channels, length, sps, levels, drift=2e-3))
        last = (torch.from_numpy(rng.normal(size=channels)
                                 .astype(np.float32)),
                torch.from_numpy(rng.normal(size=channels)
                                 .astype(np.float32)))
        want = demod_front.demod_fm_front_plain(re, im, *last, hist, taps,
                                                *state, **kw)
        got = _windowed_front((re, im), last, hist, taps, *state, **kw)
    else:
        x = torch.from_numpy(fsk_audio(rng, channels, length, sps, levels,
                                       drift=2e-3))
        want = demod_front.demod_front_plain(x, hist, taps, *state, **kw)
        got = _windowed_front((x,), None, hist, taps, *state, **kw)
    for what, g, w in zip(("dibits", "pos", "offset", "ring", "history"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what
    if nc > 2:
        assert len(set(want[0].flatten().tolist())) > 1


def test_plain_k2_at_the_40_century_ysf_shape_matches_jax():
    """K2's plain version at the JAX throughput script's YSF block (40
    centuries, sps 10, 81 taps) against the JAX XLA chain over 2 chained
    blocks, 2 channels: the block the earlier kernel refused."""
    blocks, nc, channels = 2, 40, 2
    x, _ = _audio_stream(rrc.WIDE_RRC, 10, nc, "gfsk", False, seed=77,
                         channels=channels, blocks=blocks)
    ours = _port_audio_chain(x, rrc.WIDE_RRC, 10, nc, "gfsk", False, blocks)
    ref = _jax_audio_chain(x, rrc.WIDE_RRC, 10, nc, "gfsk", False, False,
                           blocks)
    slews = 0
    for b, (o, r) in enumerate(zip(ours, ref)):
        assert o[0].shape == (channels, nc * 100)
        assert np.array_equal(o[0], r[0]), b            # dibits
        assert np.array_equal(o[1], r[1]), b            # pos
        assert np.array_equal(o[2], r[2]), b            # offset
        assert np.abs(o[3] - r[3]).max() <= RING_ATOL, b
        assert np.array_equal(o[4], r[4]), b            # RRC history
        slews += int(np.abs(o[2]).sum())
    assert slews > 0
