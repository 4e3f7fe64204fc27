"""The port's front end against the JAX package's: the FM discriminator,
the RRC filter (wide, narrow and an asymmetric 129-tap design), and the
plain version of kernel K1 (FM + RRC + century demod, gfsk and inverted
fsk) over three chained blocks, held against two references:

- the JAX package's unfused XLA chain (fm_discriminator, rrc_filter_block
  impl="xla", the XLA century scan);
- the Pallas kernel ``pallas_demod_fm_front_block`` in interpret mode.

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
from digiham_tpu.ops.demod_pallas import pallas_demod_fm_front_block
from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.dsp.demod import (DemodState, demod_init,
                                         fm_rrc_demod_block, fold_sum,
                                         rrc_demod_block)
from digiham_tpu_torch.dsp.fm import fm_discriminator
from digiham_tpu_torch.ops import demod_front

from torch_parity import FOUR_LEVELS, TWO_LEVELS, fsk_iq, knife_edge_free

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
    st = rrc.RrcState.init(C, design)
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
    rrc_st = rrc.RrcState.init(C)
    dm = demod_init(C)
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


def test_k1_wrapper_routes_cpu_to_plain():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    rng = np.random.default_rng(4)
    re, im = fsk_iq(rng, 2, L, SPS, FOUR_LEVELS)
    args = [torch.from_numpy(re), torch.from_numpy(im), torch.ones(2),
            torch.zeros(2), torch.zeros(2, 80), rrc.WIDE_RRC.taps_tensor(None),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, 100)]
    before = demod_front.LAUNCHES
    got = demod_front.demod_fm_front(*args, n_centuries=NC, sps=SPS)
    want = demod_front.demod_fm_front_plain(*args, n_centuries=NC, sps=SPS)
    assert demod_front.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_smem_budget_matches_kernel_carve_up():
    """The wrapper's shared-memory size for the main path (L=16128,
    81 taps, sps 10, 16 centuries) fits one Hopper block."""
    need = demod_front.smem_bytes(16128, 81, 10, 16)
    assert need == 4 * ((80 + 16128) + 16128 + 81 + 1000 + 400 + 1700
                        + 1600 + 10)
    assert need <= demod_front.SMEM_LIMIT


def test_non_cpu_audio_path_raises_naming_k2():
    """rrc_demod_block needs kernel K2 off the CPU: it raises instead of
    running the plain chain there (meta tensors stand in for a card)."""
    x = torch.empty((2, L), device="meta")
    st = rrc.RrcState(torch.empty((2, 80), device="meta"))
    dm = DemodState(torch.empty(2, dtype=torch.int32, device="meta"),
                    torch.empty(2, dtype=torch.int32, device="meta"),
                    torch.empty((2, 100), device="meta"))
    with pytest.raises(NotImplementedError, match="K2"):
        rrc_demod_block(x, st, dm, NC, SPS, rrc.WIDE_RRC)
    with pytest.raises(NotImplementedError, match="K3"):
        rrc_demod_block(x, st, dm, NC, SPS, None)
