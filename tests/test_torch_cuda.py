"""Kernels K1, K2, K3, K4 and K5 on the card: each builds, launches,
counts its launches and equals its plain version; what a kernel cannot
take raises; the audio pipelines (4FSK and 2FSK) and the streaming DMR,
YSF, NXDN, D-Star and POCSAG banks run on the card and equal their CPU
runs and fixtures.
Needs an NVIDIA GPU and nvcc (marker ``cuda``); without a card every test
here skips. Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which a machine with
the card need not have)."""
import numpy as np
import pytest
import torch

from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.dsp.demod import demod_init
from digiham_tpu_torch.fec.viterbi import (conv_encode, viterbi_decode,
                                           viterbi_decode_many,
                                           viterbi_decode_plain)
from digiham_tpu_torch import smoke
from digiham_tpu_torch.ops import demod_front, fir, recurrence, viterbi
from digiham_tpu_torch.pipeline import (DmrPipeline, FskPipeline,
                                        NxdnPipeline, YsfPipeline,
                                        nxdn_decode_frames)
from digiham_tpu_torch.protocols.dmr import make_decoder
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

import torch_bank
from torch_parity import FOUR_LEVELS, TWO_LEVELS, fsk_audio, fsk_iq

pytestmark = pytest.mark.cuda

C, SPS, NC = 8, 10, 3
L = NC * (100 * SPS + 1) + 8
CUSTOM_129 = rrc.RrcDesign(
    "custom129", 3.0,
    tuple(float(t) for t in np.random.default_rng(129).normal(0, 0.3, 129)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _state(rng, channels, halo=None):
    """Random (hist,) pos, offset, ring as CPU tensors."""
    t = [torch.from_numpy(rng.integers(0, 20, channels).astype(np.int32)),
         torch.from_numpy(rng.integers(-1, 2, channels).astype(np.int32)),
         torch.from_numpy(rng.normal(0, 300, (channels, 100))
                          .astype(np.float32))]
    if halo is not None:
        t.insert(0, torch.from_numpy(rng.normal(0, 300, (channels, halo))
                                     .astype(np.float32)))
    return t


def _args(dev, mode, seed=0):
    rng = np.random.default_rng(seed)
    re, im = fsk_iq(rng, C, L, SPS,
                    FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS,
                    drift=5e-4)
    hist, pos, off, ring = _state(rng, C, 80)
    t = [torch.from_numpy(re), torch.from_numpy(im),
         torch.from_numpy(re[:, 0]), torch.from_numpy(im[:, 0]), hist,
         rrc.WIDE_RRC.taps_tensor(None), pos, off, ring]
    return [x.to(dev) for x in t]


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode,invert", [("gfsk", False), ("fsk", False),
                                         ("fsk", True)])
def test_k1_equals_plain_on_card(dev, mode, invert):
    args = _args(dev, mode)
    before = demod_front.LAUNCHES["fm_rrc"]
    got = demod_front.demod_fm_front(*args, n_centuries=NC, sps=SPS,
                                     mode=mode, invert=invert)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["fm_rrc"] == before + 1
    _same(got, demod_front.demod_fm_front_plain(
        *args, n_centuries=NC, sps=SPS, mode=mode, invert=invert))


def test_k1_rejects_what_it_cannot_take(dev):
    args = _args(dev, "gfsk")
    with pytest.raises(ValueError, match="hist"):
        demod_front.demod_fm_front(*args[:4], args[4][:, :79], *args[5:],
                                   n_centuries=NC, sps=SPS)
    # shared memory no longer grows with the block length: a 40,000-sample
    # row, which one block could not hold before, runs and equals the plain
    # version
    rng = np.random.default_rng(40)
    big = [torch.from_numpy(a).to(dev)
           for a in fsk_iq(rng, C, 40000, SPS, FOUR_LEVELS, drift=5e-4)]
    before = demod_front.LAUNCHES["fm_rrc"]
    got = demod_front.demod_fm_front(*big, *args[2:], n_centuries=NC, sps=SPS)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["fm_rrc"] == before + 1
    _same(got, demod_front.demod_fm_front_plain(*big, *args[2:],
                                                n_centuries=NC, sps=SPS))
    # what is left to refuse: a carve-up over what a block may use
    need = demod_front.smem_bytes(81, SPS, 2000)
    with pytest.raises(ValueError, match=f"{need} B of shared memory"):
        demod_front.demod_fm_front(*big, *args[2:], n_centuries=2000, sps=SPS)
    assert demod_front.LAUNCHES["fm_rrc"] == before + 1


# 85 = 10 * 8 + 5: the FIR's register window ends on single-tap steps
CUSTOM_86 = rrc.RrcDesign(
    "custom86", 2.0,
    tuple(float(t) for t in np.random.default_rng(86).normal(0, 0.3, 86)))


@pytest.mark.parametrize("design,sps,nc,mode,invert", [
    (rrc.WIDE_RRC, 10, 3, "gfsk", False),
    (rrc.NARROW_RRC, 20, 2, "gfsk", False),
    (CUSTOM_129, 10, 3, "gfsk", False),
    (rrc.WIDE_RRC, 40, 2, "fsk", True),
    (CUSTOM_86, 10, 3, "gfsk", False),
], ids=["wide81", "narrow161", "custom129", "fsk_inverted_sps40", "custom86"])
def test_k2_equals_plain_on_card(dev, design, sps, nc, mode, invert):
    rng = np.random.default_rng(sps)
    length = nc * (100 * sps + 1) + 24
    x = fsk_audio(rng, C, length, sps,
                  FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS, drift=5e-4)
    args = [t.to(dev) for t in (
        torch.from_numpy(x), *_state(rng, C, design.ntaps - 1))]
    args.insert(2, design.taps_tensor(dev))
    kw = dict(n_centuries=nc, sps=sps, mode=mode, invert=invert)
    before = demod_front.LAUNCHES["rrc"]
    got = demod_front.demod_front(*args, **kw)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["rrc"] == before + 1
    _same(got, demod_front.demod_front_plain(*args, **kw))
    # the new history is the raw input tail
    assert torch.equal(got[4], args[0][:, length - design.ntaps + 1:])


@pytest.mark.parametrize("sps,nc,length,mode,invert", [
    (10, 3, 3 * 1001 + 24, "gfsk", False),
    (20, 2, 2 * 2001 + 24, "fsk", False),
    # a row longer than one block's shared memory could hold
    (40, 14, 60000, "fsk", True),
], ids=["gfsk_sps10", "fsk_sps20", "fsk_inverted_sps40_long_row"])
def test_k3_equals_plain_on_card(dev, sps, nc, length, mode, invert):
    rng = np.random.default_rng(sps + 1)
    x = fsk_audio(rng, C, length, sps,
                  FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS, drift=5e-4)
    args = [t.to(dev) for t in (torch.from_numpy(x), *_state(rng, C))]
    kw = dict(n_centuries=nc, sps=sps, mode=mode, invert=invert)
    before = demod_front.LAUNCHES["none"]
    got = demod_front.demod(*args, **kw)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["none"] == before + 1
    _same(got, demod_front.demod_plain(*args, **kw))


@pytest.mark.parametrize("sps,nc,invert", [
    (10, 4, False),    # dstar_bank
    (10, 32, False),   # dstar_audio
    (40, 4, True),     # pocsag_bank
    (40, 8, True),     # pocsag_audio
    (20, 4, True),     # POCSAG at 2400 baud
    (94, 4, True),     # POCSAG at 512 baud
    (128, 2, True),    # the widest symbol K3 takes
    (128, 2, False),
], ids=["dstar_4", "dstar_32", "pocsag_4", "pocsag_8", "pocsag_sps20",
        "pocsag_sps94", "sps128_inverted", "sps128"])
def test_k3_2fsk_shapes_on_card(dev, sps, nc, invert):
    """K3 at the 2FSK paths' shapes (D-Star sps 10, POCSAG sps 20/40/94
    inverted) and at sps 128, the JAX kernel's limit: one launch, equal to
    the plain version."""
    rng = np.random.default_rng(sps + nc)
    x = fsk_audio(rng, C, nc * (100 * sps + 1) + 24, sps, TWO_LEVELS,
                  drift=5e-4)
    args = [t.to(dev) for t in (torch.from_numpy(x), *_state(rng, C))]
    kw = dict(n_centuries=nc, sps=sps, mode="fsk", invert=invert)
    before = demod_front.LAUNCHES["none"]
    got = demod_front.demod(*args, **kw)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["none"] == before + 1
    _same(got, demod_front.demod_plain(*args, **kw))


def test_k3_refuses_past_its_widest_symbol(dev):
    rng = np.random.default_rng(3)
    args = [t.to(dev) for t in (torch.zeros((2, 2 * 12901 + 8)),
                                *_state(rng, 2))]
    with pytest.raises(ValueError, match="sps"):
        demod_front.demod(*args, n_centuries=1, sps=demod_front.MAX_SPS + 1,
                          mode="fsk")


def _front_case(dev, front, design, sps, nc, mode, invert, offset=None,
                extra=24, seed=0, channels=C):
    """(wrapper, plain version, counter, args on the card) of one front at
    one shape, on a drifting random stream; ``offset`` forces every
    channel's pending slew."""
    rng = np.random.default_rng(seed)
    levels = FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS
    length = 20 + nc * (100 * sps + 1) + extra
    halo = None if front == "none" else design.ntaps - 1
    state = _state(rng, channels, halo)
    if offset is not None:
        state[-2] = torch.full((channels,), offset, dtype=torch.int32)
    if front == "fm_rrc":
        re, im = fsk_iq(rng, channels, length, sps, levels, drift=5e-4)
        args = [torch.from_numpy(re), torch.from_numpy(im),
                torch.from_numpy(re[:, 1].copy()),
                torch.from_numpy(im[:, 1].copy()), state[0],
                design.taps_tensor(None), *state[1:]]
        fns = demod_front.demod_fm_front, demod_front.demod_fm_front_plain
    else:
        x = torch.from_numpy(fsk_audio(rng, channels, length, sps, levels,
                                       drift=5e-4))
        if front == "rrc":
            args = [x, state[0], design.taps_tensor(None), *state[1:]]
            fns = demod_front.demod_front, demod_front.demod_front_plain
        else:
            args = [x, *state]
            fns = demod_front.demod, demod_front.demod_plain
    return (*fns, [t.to(dev) for t in args])


def _runs_once_and_equals_plain(front, kernel, plain, args, **kw):
    before = dict(demod_front.LAUNCHES)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = dict(before)
    want[front] += 1
    assert demod_front.LAUNCHES == want
    _same(got, plain(*args, **kw))
    return got


@pytest.mark.parametrize("front,design,sps,nc", [
    ("rrc", rrc.WIDE_RRC, 10, 40),     # the YSF throughput block
    ("rrc", rrc.NARROW_RRC, 20, 16),   # the NXDN throughput block
    ("fm_rrc", rrc.WIDE_RRC, 10, 32),  # the DMR throughput block
    ("rrc", rrc.WIDE_RRC, 40, 14),     # 2FSK at sps 40, 56,000 samples
], ids=["k2_ysf_40", "k2_nxdn_16", "k1_dmr_32", "k2_sps40_14"])
def test_k2_overlong_block_runs(dev, front, design, sps, nc):
    """Blocks that one block's shared memory could not hold when K1 and K2
    kept their whole row there (they raised a ValueError) run in one
    launch and equal the plain version."""
    mode, invert = ("fsk", True) if sps == 40 else ("gfsk", False)
    kernel, plain, args = _front_case(dev, front, design, sps, nc, mode,
                                      invert, seed=nc)
    _runs_once_and_equals_plain(front, kernel, plain, args, n_centuries=nc,
                                sps=sps, mode=mode, invert=invert)


@pytest.mark.parametrize("offset", [-1, 1])
@pytest.mark.parametrize("sps,nc", [(3, 2), (64, 2), (10, 1), (20, 5)])
@pytest.mark.parametrize("front", ["fm_rrc", "rrc", "none"])
def test_fronts_at_the_edges_on_card(dev, front, sps, nc, offset):
    """K1, K2 and K3 at the lowest and highest sps, with one century, and
    with every channel entering on a pending slew of -1 or +1."""
    kernel, plain, args = _front_case(dev, front, rrc.WIDE_RRC, sps, nc,
                                      "gfsk", False, offset=offset,
                                      seed=sps + nc)
    _runs_once_and_equals_plain(front, kernel, plain, args, n_centuries=nc,
                                sps=sps)


@pytest.mark.parametrize("offset", [-1, 1])
@pytest.mark.parametrize("sps,nc", [(94, 4), (128, 1), (128, 2)])
@pytest.mark.parametrize("mode,invert", [("gfsk", False), ("fsk", True)])
def test_k3_at_the_widest_symbols_on_card(dev, sps, nc, mode, invert,
                                          offset):
    """K3 past the old cap of 64: the argmin over four column variances a
    lane, every channel entering on a pending slew of -1 or +1."""
    kernel, plain, args = _front_case(dev, "none", None, sps, nc, mode,
                                      invert, offset=offset, seed=sps + nc)
    _runs_once_and_equals_plain("none", kernel, plain, args, n_centuries=nc,
                                sps=sps, mode=mode, invert=invert)


def test_fronts_with_pos_at_zero_and_a_short_row_on_card(dev):
    """Entry pos 0 (the first window starts before the row: history and
    zeros) and a row shorter than the last window (reads past it give 0,
    and no read goes out of bounds), for the three fronts."""
    for front in ("fm_rrc", "rrc", "none"):
        kernel, plain, args = _front_case(dev, front, rrc.WIDE_RRC, 10, 3,
                                          "gfsk", False, extra=-60, seed=3)
        args[-3].zero_()  # pos
        _runs_once_and_equals_plain(front, kernel, plain, args,
                                    n_centuries=3, sps=10)


def test_every_channel_of_a_bank_is_resident(dev):
    """The runtime keeps two blocks or more of every front on an SM at the
    bank shapes, so 256 channels run at once on a card with 128 SMs or
    more."""
    for front, ntaps, sps, nc in (("fm_rrc", 81, 10, 16), ("rrc", 81, 10, 16),
                                  ("rrc", 81, 10, 40), ("rrc", 161, 20, 16),
                                  ("fm_rrc", 81, 10, 32), ("none", 0, 10, 10),
                                  ("none", 0, 10, 4), ("none", 0, 10, 32),
                                  ("none", 0, 40, 4), ("none", 0, 40, 8),
                                  ("none", 0, 94, 4)):
        blocks, sms = demod_front.occupancy(front, ntaps, sps, nc)
        assert blocks >= 2 and sms > 0, (front, ntaps, sps, nc, blocks)


def _k5_inputs(rng, batch, T, blocked):
    """Noisy encoded sequences, pure noise (ties) and all-equal
    observations, as int64 numpy arrays."""
    bits = rng.integers(0, 2, (batch, T))
    bits[:, :blocked] = 0
    noisy = conv_encode(bits)
    flips = rng.random(noisy.shape) < 0.12
    noisy = np.where(flips, noisy ^ rng.integers(1, 4, noisy.shape), noisy)
    return [noisy, rng.integers(0, 4, (batch, T)),
            np.zeros((batch, T), np.int64), np.full((batch, T), 3)]


@pytest.mark.parametrize("T,blocked", [(100, 0), (36, 4), (96, 4), (1, 0),
                                       (1, 4), (3, 4)])
@pytest.mark.parametrize("batch", [1, 2, 3, 129, 512, 4096])
def test_k5_equals_plain_on_card(dev, T, blocked, batch):
    rng = np.random.default_rng(T + batch)
    for obs in _k5_inputs(rng, batch, T, blocked):
        obs = torch.from_numpy(obs).to(dev)
        before = viterbi.LAUNCHES
        got = viterbi_decode(obs, 16, blocked)
        torch.cuda.synchronize()
        assert viterbi.LAUNCHES == before + 1
        _same(got, viterbi_decode_plain(obs, 16, blocked))


@pytest.mark.parametrize("T,blocked", [(100, 0), (36, 4), (96, 4)])
@pytest.mark.parametrize("layout", ["int32", "uint8", "strided",
                                    "strided_int64", "three_dims"])
def test_k5_reads_its_input_as_it_is_on_card(dev, layout, T, blocked):
    """uint8 dibits as the demod kernels write them, int32, rows of a wider
    array and a [.., .., T] batch go to the kernel without a copy."""
    rng = np.random.default_rng(T + len(layout))
    for obs in _k5_inputs(rng, 130, T, blocked):
        if layout.startswith("strided"):
            wide = np.concatenate([obs ^ 1, obs, obs ^ 2], axis=1)
            wide = wide.astype(np.uint8 if layout == "strided" else np.int64)
            x = torch.from_numpy(wide).to(dev)[:, T:2 * T]
            assert not x.is_contiguous()
        elif layout == "three_dims":
            x = torch.from_numpy(obs.astype(np.uint8)).to(dev).reshape(
                10, 13, T)
        else:
            x = torch.from_numpy(obs.astype(layout)).to(dev)
        before = viterbi.LAUNCHES
        got = viterbi_decode(x, 16, blocked)
        torch.cuda.synchronize()
        assert viterbi.LAUNCHES == before + 1
        _same(got, viterbi_decode_plain(x, 16, blocked))


def test_k5_at_the_most_steps_a_block_holds(dev):
    rng = np.random.default_rng(9)
    obs = torch.from_numpy(
        _k5_inputs(rng, 3, viterbi.MAX_STEPS, 0)[0].astype(np.uint8)).to(dev)
    got = viterbi.viterbi16(obs)
    torch.cuda.synchronize()
    _same(got, viterbi_decode_plain(obs, 16, 0))


@pytest.mark.parametrize("segments", [
    ((512, 100, 0), (512, 100, 0)),     # a YSF step: FICH and DCH
    ((512, 36, 4), (1024, 96, 4)),      # an NXDN decode: SACCH, 2 x FACCH1
    ((1, 1, 0), (3, 36, 4), (5, 100, 0), (129, 96, 4)),
    ((7, 100, 0),),
    ((1024, 100, 0), (1024, 100, 0)),   # a 256-channel YSF bank's round
    ((1024, 36, 4), (2048, 96, 4)),     # a 256-channel NXDN bank's round
], ids=["ysf_step", "nxdn_decode", "four_mixed", "one", "ysf_bank_round",
        "nxdn_bank_round"])
def test_k5_fused_entry_equals_plain_on_card(dev, segments):
    """Several batches, one launch: every segment equals the plain version
    on that segment alone."""
    rng = np.random.default_rng(len(segments))
    inputs = [_k5_inputs(rng, b, T, bl) for b, T, bl in segments]
    for case in range(4):
        ins = [(torch.from_numpy(inputs[n][case].astype(
                    np.uint8 if n % 2 else np.int32)).to(dev), bl)
               for n, (_, _, bl) in enumerate(segments)]
        before = viterbi.LAUNCHES
        got = viterbi_decode_many(ins)
        torch.cuda.synchronize()
        assert viterbi.LAUNCHES == before + 1
        for (obs, bl), g in zip(ins, got):
            _same(g, viterbi_decode_plain(obs, 16, bl))
    # an empty batch among them is not a segment of the launch
    empty = torch.zeros((0, 50), dtype=torch.uint8, device=dev)
    before = viterbi.LAUNCHES
    got = viterbi_decode_many([(empty, 0), ins[0]])
    assert viterbi.LAUNCHES == before + 1
    assert got[0][0].shape == (0, 50) and got[0][1].shape == (0,)
    _same(got[1], viterbi_decode_plain(*ins[0][:1], 16, ins[0][1]))
    assert viterbi_decode_many([(empty, 0)])[0][0].shape == (0, 50)
    assert viterbi.LAUNCHES == before + 1


def _k5_4_inputs(rng, batch, T, blocked):
    """4-state noisy, noise, zeros and threes."""
    bits = rng.integers(0, 2, (batch, T))
    bits[:, :blocked] = 0
    noisy = conv_encode(bits, 4)
    flips = rng.random(noisy.shape) < 0.1
    noisy = np.where(flips, noisy ^ rng.integers(1, 4, noisy.shape), noisy)
    return [noisy, rng.integers(0, 4, (batch, T)),
            np.zeros((batch, T), np.int64), np.full((batch, T), 3)]


@pytest.mark.parametrize("T,blocked", [(330, 0), (330, 2), (36, 2), (1, 0),
                                       (1, 2), (3, 2)])
@pytest.mark.parametrize("batch", [1, 3, 17, 256])
@pytest.mark.parametrize("layout", ["int64", "uint8", "strided"])
def test_k5_4_states_equals_plain_on_card(dev, T, blocked, batch, layout):
    """The 4-state instance (8 sequences a warp, 16 a block) at the D-Star
    header's T = 330 and the edges; one launch of the 4-state count."""
    rng = np.random.default_rng(T + batch + len(layout))
    for obs in _k5_4_inputs(rng, batch, T, blocked):
        if layout == "strided":
            wide = np.concatenate([obs ^ 1, obs, obs ^ 2], axis=1)
            x = torch.from_numpy(wide.astype(np.uint8)).to(dev)[:, T:2 * T]
        else:
            x = torch.from_numpy(obs.astype(layout)).to(dev)
        before = dict(viterbi.LAUNCHES_BY_STATES)
        got = viterbi_decode(x, 4, blocked)
        torch.cuda.synchronize()
        before[4] += 1
        assert viterbi.LAUNCHES_BY_STATES == before
        _same(got, viterbi_decode_plain(x, 4, blocked))


def test_k5_4_states_fused_and_longest_on_card(dev):
    rng = np.random.default_rng(44)
    segments = ((1, 330, 0), (256, 330, 2), (5, 36, 0), (129, 1, 2))
    inputs = [_k5_4_inputs(rng, b, T, bl) for b, T, bl in segments]
    for case in range(4):
        ins = [(torch.from_numpy(inputs[n][case].astype(
                    np.uint8 if n % 2 else np.int64)).to(dev), bl)
               for n, (_, _, bl) in enumerate(segments)]
        before = viterbi.LAUNCHES
        got = viterbi_decode_many(ins, num_states=4)
        torch.cuda.synchronize()
        assert viterbi.LAUNCHES == before + 1
        for (obs, bl), g in zip(ins, got):
            _same(g, viterbi_decode_plain(obs, 4, bl))
    longest = viterbi.max_steps(4)
    obs = torch.from_numpy(_k5_4_inputs(rng, 3, longest, 2)[0].astype(
        np.uint8)).to(dev)
    got = viterbi.viterbi16(obs, 2, num_states=4)
    torch.cuda.synchronize()
    _same(got, viterbi_decode_plain(obs, 4, 2))
    with pytest.raises(ValueError, match="steps"):
        viterbi.viterbi16(torch.zeros((2, longest + 1), dtype=torch.uint8,
                                      device=dev), num_states=4)
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi16(obs, 4, num_states=4)


def test_k5_rejects_what_it_cannot_take(dev):
    with pytest.raises(ValueError, match="steps"):
        viterbi.viterbi16(torch.zeros((2, viterbi.MAX_STEPS + 1),
                                      dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi16(torch.zeros((2, 10), dtype=torch.int32,
                                      device=dev), blocked_steps=2)
    ok = torch.zeros((4, 6, 40), dtype=torch.int32, device=dev)
    before = viterbi.LAUNCHES
    for bad, match in ((ok.float(), "uint8, int32 or int64"),
                       (ok.bool(), "uint8, int32 or int64"),
                       (ok[..., ::2], "unit stride"),
                       (ok[:, :4, :], "row stride")):
        with pytest.raises(ValueError, match=match):
            viterbi.viterbi16(bad)
        with pytest.raises(ValueError, match=match):
            viterbi_decode_many([(ok, 0), (bad, 0)])
    with pytest.raises(ValueError, match="segments a launch"):
        viterbi_decode_many([(ok, 0)] * (viterbi.MAX_SEGMENTS + 1))
    with pytest.raises(ValueError, match="segments on"):
        viterbi_decode_many([(ok, 0), (ok.cpu(), 0)])
    assert viterbi.LAUNCHES == before


def test_default_device_is_the_card(dev):
    assert DmrPipeline(channels=2).device.type == "cuda"
    assert demod_init(2).pos.device.type == "cuda"
    assert rrc.RrcState.init(2).history.device.type == "cuda"


def _launch_counts():
    return dict(demod_front.LAUNCHES, fir=fir.LAUNCHES,
                viterbi=viterbi.LAUNCHES)


@pytest.mark.parametrize("protocol", ["dmr", "ysf", "nxdn", "ysf_prefiltered"])
def test_audio_paths_run_on_card(dev, protocol):
    """The FM-audio entry points run on the card through their kernels
    and equal the same step on the CPU (the plain versions)."""
    kind, sps, nc, kw = {
        "dmr": (DmrPipeline, 10, 3, {}),
        "ysf": (YsfPipeline, 10, 5, {}),
        "nxdn": (NxdnPipeline, 20, 2, {}),
        "ysf_prefiltered": (YsfPipeline, 10, 5, {"use_rrc": False}),
    }[protocol]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(fsk_audio(rng, C, nc * (100 * sps + 1) + 8, sps,
                                   FOUR_LEVELS))
    outs = {}
    for where in ("cpu", dev):
        pipe = kind(C, sps, nc, device=where, **kw)
        before = _launch_counts()
        out, state = pipe.step(x.to(where), pipe.init_state())
        if protocol == "nxdn":
            out.update(nxdn_decode_frames(
                out["dibits"][:, :192].reshape(C, 1, 192), pipe.tables()))
        after = _launch_counts()
        outs[where] = {k: v.cpu() for k, v in out.items()}
        outs[where]["pos"] = state.demod.pos.cpu()
        outs[where]["history"] = state.rrc.history.cpu()
        launched = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(after, 0)
        if where != "cpu":
            want["none" if protocol == "ysf_prefiltered" else "rrc"] = 1
            want["viterbi"] = 0 if protocol == "dmr" else 1
        assert launched == want
    for k, v in outs["cpu"].items():
        assert torch.equal(outs[dev][k], v), k


# --- K4 and the streaming bank --------------------------------------------

@pytest.mark.parametrize("design", [rrc.WIDE_RRC, rrc.NARROW_RRC,
                                    CUSTOM_129], ids=lambda d: d.name)
@pytest.mark.parametrize("channels,T", [(1, 0), (1, 1), (3, 79), (3, 80),
                                        (129, 81), (8, 1024), (8, 1025),
                                        (5, 5003), (3, 4), (3, 5), (3, 6),
                                        (3, 7), (3, 8), (2, fir.TILE - 1),
                                        (2, fir.TILE), (2, fir.TILE + 1)])
def test_k4_equals_plain_on_card(dev, design, channels, T):
    """Output and new history equal the plain version bit for bit; one
    launch per non-empty block; the history is a copy."""
    rng = np.random.default_rng(T + channels)
    x = torch.from_numpy(rng.normal(0, 900, (channels, T))
                         .astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 900, (channels, design.ntaps - 1))
                            .astype(np.float32)).to(dev)
    taps = design.taps_tensor(dev)
    before = fir.LAUNCHES
    y, new = fir.rrc_filter_block_kernel(x, hist, taps)
    torch.cuda.synchronize()
    assert fir.LAUNCHES == before + (1 if T else 0)
    _same((y, new), fir.rrc_filter_block_plain(x, hist, taps))
    x.zero_()
    hist.zero_()
    assert new.abs().max() > 0
    # the public dispatch takes the same route
    before = fir.LAUNCHES
    rrc.rrc_filter_block(x, rrc.RrcState(hist), design)
    assert fir.LAUNCHES == before + (1 if T else 0)


@pytest.mark.parametrize("stream,design", [
    (smoke.DMR_BANK, rrc.WIDE_RRC), (smoke.YSF_BANK, rrc.WIDE_RRC),
    (smoke.NXDN_BANK, rrc.NARROW_RRC)], ids=lambda x: x.name)
def test_k4_at_the_bank_flush_tails(dev, stream, design):
    """K4 at the row a 256-channel bank's flush gives it (the NXDN tail
    with 161 taps): equal to the plain version bit for bit."""
    rng = np.random.default_rng(stream.flush_tail)
    x = torch.from_numpy(rng.normal(0, 900, (256, stream.flush_tail))
                         .astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 900, (256, design.ntaps - 1))
                            .astype(np.float32)).to(dev)
    taps = design.taps_tensor(dev)
    before = fir.LAUNCHES
    got = fir.rrc_filter_block_kernel(x, hist, taps)
    torch.cuda.synchronize()
    assert fir.LAUNCHES == before + 1
    _same(got, fir.rrc_filter_block_plain(x, hist, taps))


def test_k4_fir_cmajor_strided_and_chained(dev):
    """fir_cmajor on a strided view of a wider array, and three chained
    blocks of uneven length equal to one block over the whole row."""
    rng = np.random.default_rng(6)
    taps = rrc.WIDE_RRC.taps_tensor(dev)
    wide = torch.from_numpy(rng.normal(0, 900, (6, 4000))
                            .astype(np.float32)).to(dev)
    x = wide[:, 100:3100]
    assert not x.is_contiguous()
    _same((fir.fir_cmajor(x, taps),), (fir.fir_cmajor_plain(x, taps),))
    st = rrc.RrcState.init(6, rrc.WIDE_RRC)
    whole, _ = rrc.rrc_filter_block(wide, st, rrc.WIDE_RRC)
    parts = []
    for lo, hi in ((0, 37), (37, 2048), (2048, 4000)):
        y, st = rrc.rrc_filter_block(wide[:, lo:hi], st, rrc.WIDE_RRC)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)


def _random_taps(dev, ntaps):
    return torch.from_numpy(np.random.default_rng(ntaps).normal(
        0, 0.3, ntaps).astype(np.float32)).to(dev)


@pytest.mark.parametrize("ntaps", [1, 2, 9, 10, 82, 86])
@pytest.mark.parametrize("T", [1, 7, fir.TILE + 9])
def test_k4_short_and_odd_designs_on_card(dev, ntaps, T):
    """Tap counts around the register window's step of 8 (1, 2: single
    taps only; 9, 10: one step and a remainder) and even ones."""
    rng = np.random.default_rng(ntaps + T)
    x = torch.from_numpy(rng.normal(0, 900, (5, T)).astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 900, (5, ntaps - 1))
                            .astype(np.float32)).to(dev)
    taps = _random_taps(dev, ntaps)
    got = fir.rrc_filter_block_kernel(x, hist, taps)
    torch.cuda.synchronize()
    _same(got, fir.rrc_filter_block_plain(x, hist, taps))


@pytest.mark.parametrize("ntaps,width,start", [
    (82, 3001, 0), (82, 3001, 1), (81, 2999, 3), (10, fir.TILE + 3, 2),
    (161, 4097, 1)])
def test_k4_misaligned_rows_on_card(dev, ntaps, width, start):
    """fir_cmajor hands the kernel ``x[:, ntaps-1:]``: with 82 taps, a view
    that starts a float or three into its array, or an odd row stride, the
    sample pointer is off a 16-byte boundary, differently in every channel.
    The kernel shifts its window and keeps its 16-byte copies."""
    rng = np.random.default_rng(ntaps + width + start)
    wide = torch.from_numpy(rng.normal(0, 900, (7, width + 12))
                            .astype(np.float32)).to(dev)
    x = wide[:, start:start + width]
    assert wide.stride(0) % 2 == 1
    assert any(x[c, ntaps - 1:].data_ptr() % 16 for c in range(7))
    taps = _random_taps(dev, ntaps)
    before = fir.LAUNCHES
    got = fir.fir_cmajor(x, taps)
    torch.cuda.synchronize()
    assert fir.LAUNCHES == before + 1
    _same((got,), (fir.fir_cmajor_plain(x, taps),))


def test_k4_shares_an_sm_between_blocks(dev):
    for ntaps in (81, 161):
        blocks, sms = fir.occupancy(ntaps)
        assert blocks >= 2 and sms > 0, (ntaps, blocks)


def test_k4_feeds_k3_what_k2_consumes(dev):
    """K4 then K3 gives K2's dibits and carries on the same block."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(fsk_audio(rng, C, L, SPS, FOUR_LEVELS)).to(dev)
    hist, pos, off, ring = (t.to(dev) for t in _state(rng, C, 80))
    taps = rrc.WIDE_RRC.taps_tensor(dev)
    fused = demod_front.demod_front(x, hist, taps, pos, off, ring,
                                    n_centuries=NC, sps=SPS)
    filtered, new_hist = fir.rrc_filter_block_kernel(x, hist, taps)
    two_stage = demod_front.demod(filtered, pos, off, ring, n_centuries=NC,
                                  sps=SPS)
    _same((*two_stage, new_hist), fused)


def test_k4_rejects_what_it_cannot_take(dev):
    taps = rrc.WIDE_RRC.taps_tensor(dev)
    x = torch.zeros((2, 100), device=dev)
    hist = torch.zeros((2, 80), device=dev)
    with pytest.raises(ValueError, match="float32"):
        fir.rrc_filter_block_kernel(x.double(), hist, taps)
    with pytest.raises(ValueError, match="history"):
        fir.rrc_filter_block_kernel(x, hist[:, :10], taps)
    with pytest.raises(ValueError, match="tensors on"):
        fir.rrc_filter_block_kernel(x, hist.cpu(), taps)
    with pytest.raises(ValueError, match="shared memory"):
        fir.fir_cmajor(torch.zeros((1, 70000), device=dev),
                       torch.zeros(60000, device=dev))


def _bank(kind, where):
    fx = smoke.load(smoke.DMR_BANK)
    V = fx["tx_dibits"].shape[0]
    pipe = DmrPipeline(channels=V, sps=10, n_centuries=16, device=where)
    if kind == "tracked":
        return fx, TrackedChannelBank(pipe, device=where)
    return fx, ChannelBank(pipe, [make_decoder() for _ in range(V)],
                           device=where)


@pytest.mark.parametrize("kind", ["tracked", "plain"])
def test_bank_on_card_decodes_the_fixture(dev, kind):
    """The streaming bank with ``device=None`` runs on the card (K2 per
    step, K4 in the flush) and gives the fixture's bytes and events."""
    fx, bank = _bank(kind, None)
    assert bank.device.type == "cuda"
    before = dict(demod_front.LAUNCHES, fir=fir.LAUNCHES)
    voice, events = torch_bank.run(
        bank, PipelineMetaWriter, smoke.bank_audio(smoke.DMR_BANK, fx),
        fx["chunks"])
    assert demod_front.LAUNCHES["rrc"] - before["rrc"] == 5
    assert fir.LAUNCHES - before["fir"] == 1
    for v in range(len(voice)):
        assert (voice[v], events[v]) == smoke.bank_expected(fx, v), v
    with pytest.raises(RuntimeError, match="flushed"):
        bank.push(np.zeros((len(voice), 10), np.float32))


@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_bank_snapshot_crosses_devices(dev, src, dst):
    """A snapshot written on one device restores on the other and gives
    the same remainder."""
    fx, first = _bank("tracked", src)
    audio = smoke.bank_audio(smoke.DMR_BANK, fx)
    chunks = [int(n) for n in fx["chunks"]]
    torch_bank.run(first, PipelineMetaWriter, audio, chunks[:3],
                   flush=False)
    blob = first.snapshot()
    rest = audio[:, sum(chunks[:3]):]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[3:])
    _, second = _bank("tracked", dst)
    second.restore(blob)
    assert second.state.demod.pos.device.type == dst
    assert torch_bank.run(second, PipelineMetaWriter, rest,
                          chunks[3:]) == want
    with pytest.raises(ValueError, match="pipeline is on"):
        TrackedChannelBank(DmrPipeline(channels=2, device="cpu"))


@pytest.mark.parametrize("stream,kind,adapter,protocol", [
    (smoke.YSF_BANK, YsfPipeline, "YsfAdapter", "ysf"),
    (smoke.NXDN_BANK, NxdnPipeline, "NxdnAdapter", "nxdn")],
    ids=["ysf", "nxdn"])
def test_protocol_banks_on_card_decode_the_fixture(dev, stream, kind,
                                                   adapter, protocol):
    """The YSF and NXDN banks with ``device=None`` at 16 channels (the
    fixture's 8 variants twice) run on the card and give the fixture's
    bytes and events: K2 once per step, K5 once per decode round that found
    frames, K4 once (the flush)."""
    fx = smoke.load(stream)
    tile = np.arange(16) % fx["tx_dibits"].shape[0]
    pipe = kind(channels=16, sps=stream.sps, n_centuries=stream.n_centuries)
    adapter = getattr(tracked_bank, adapter)()
    rounds = []
    decode = adapter.decode_fields

    def counted(frames, pipeline):
        rounds.append(len(frames))
        return decode(frames, pipeline)

    adapter.decode_fields = counted
    bank = TrackedChannelBank(pipe, adapter=adapter)
    assert bank.device.type == "cuda"
    before = dict(demod_front.LAUNCHES, fir=fir.LAUNCHES,
                  viterbi=viterbi.LAUNCHES)
    steps = bank.steps
    voice, events = torch_bank.run(bank, PipelineMetaWriter,
                                   smoke.bank_audio(stream, fx)[tile],
                                   fx["chunks"])
    steps = bank.steps - steps
    assert steps >= 5 and rounds
    assert demod_front.LAUNCHES["rrc"] - before["rrc"] == steps
    assert viterbi.LAUNCHES - before["viterbi"] == len(rounds)
    assert fir.LAUNCHES - before["fir"] == 1
    for c, v in enumerate(tile):
        assert (voice[c], events[c]) == smoke.bank_expected(fx, v), c


# --- the 2FSK paths -------------------------------------------------------

@pytest.mark.parametrize("protocol,sps,nc,design", [
    ("dstar", 10, 4, None), ("pocsag", 40, 2, None), ("pocsag", 94, 2, None),
    ("dstar", 10, 3, rrc.WIDE_RRC)], ids=["dstar", "pocsag", "pocsag_sps94",
                                          "dstar_rrc"])
def test_fsk_paths_run_on_card(dev, protocol, sps, nc, design):
    """FskPipeline.step runs on the card through K3 (K2 with an RRC design)
    and equals the same step on the CPU: bits, sync distances, carries."""
    rng = np.random.default_rng(sps + nc)
    x = torch.from_numpy(fsk_audio(rng, C, nc * (100 * sps + 1) + 8, sps,
                                   TWO_LEVELS))
    outs = {}
    for where in ("cpu", dev):
        pipe = FskPipeline(C, protocol, n_centuries=nc, rrc=design, sps=sps,
                           device=where)
        before = _launch_counts()
        out, state = pipe.step(x.to(where), pipe.init_state())
        after = _launch_counts()
        outs[where] = {k: v.cpu() for k, v in out.items()}
        outs[where]["pos"] = state.demod.pos.cpu()
        outs[where]["ring"] = state.demod.volume_ring.cpu()
        launched = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(after, 0)
        if where != "cpu":
            want["none" if design is None else "rrc"] = 1
        assert launched == want
        assert (state.rrc is None) == (design is None)
    for k, v in outs["cpu"].items():
        assert torch.equal(outs[dev][k], v), k


@pytest.mark.parametrize("stream,protocol,adapter", [
    (smoke.DSTAR_BANK, "dstar", "DstarAdapter"),
    (smoke.POCSAG_BANK, "pocsag", "PocsagAdapter")], ids=["dstar", "pocsag"])
def test_fsk_banks_on_card_decode_the_fixture(dev, stream, protocol,
                                              adapter):
    """The D-Star and POCSAG banks with ``device=None`` at 16 channels run
    on the card and give the fixture's bytes and events: K3 once per step,
    no K4 (no RRC to flush through) and no K5."""
    fx = smoke.load(stream)
    tile = np.arange(16) % fx["tx_dibits"].shape[0]
    pipe = FskPipeline(16, protocol, n_centuries=stream.n_centuries)
    bank = TrackedChannelBank(pipe, adapter=getattr(tracked_bank, adapter)())
    assert bank.device.type == "cuda"
    before = _launch_counts()
    steps = bank.steps
    with smoke.function_bits(fx):
        voice, events = torch_bank.run(bank, PipelineMetaWriter,
                                       smoke.bank_audio(stream, fx)[tile],
                                       fx["chunks"])
    steps = bank.steps - steps
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    want = dict.fromkeys(launched, 0)
    want["none"] = steps
    assert steps >= 5 and launched == want
    for c, v in enumerate(tile):
        assert (voice[c], events[c]) == smoke.bank_expected(fx, v), c


# --- K6 and the command line's shapes -------------------------------------

# K6's tile edges (one, two and three tiles -1/+0/+1) and channel counts
# (a block's -1/+0/+1 among them)
_K6_TILE_EDGES = [(3, k * recurrence.TILE + d) for k in (1, 2, 3)
                  for d in (-1, 0, 1)]
_K6_CHANNELS = [(c, 700) for c in sorted(
    {1, 7, 31, 33, 255, 256, 257, recurrence.ROWS - 1, recurrence.ROWS,
     recurrence.ROWS + 1})]


def _iir_inputs(rng, channels, T, dtype=np.int16):
    if dtype == np.int16:
        pcm = rng.integers(-32768, 32768, (channels, T))
    else:  # past the int16 range, as the JAX function takes it
        pcm = np.round(rng.normal(0, 30000, (channels, T)))
    pcm = torch.from_numpy(pcm.astype(dtype))
    xv = torch.from_numpy(rng.normal(0, 0.05, (channels, 10))
                          .astype(np.float32))
    yv = torch.from_numpy(rng.normal(0, 0.2, (channels, 10))
                          .astype(np.float32))
    return pcm, xv, yv


@pytest.mark.parametrize("channels,T", [
    (1, 0), (1, 1), (1, 9), (1, 10), (1, 11), (2, 159), (2, 160), (2, 161),
    (31, 330), (33, 170), (256, 1600), (1, 32768), *_K6_TILE_EDGES,
    *_K6_CHANNELS])
def test_k6_iir_equals_plain_on_card(dev, channels, T):
    """K6's IIR equals its plain version bit for bit (the plain version on
    the CPU: every operation it takes is one correctly rounded float32
    operation, as on the card), state included; one launch per non-empty
    block."""
    from digiham_tpu_torch.dsp import audio
    from digiham_tpu_torch.ops import recurrence

    rng = np.random.default_rng(channels * 7 + T)
    pcm, xv, yv = _iir_inputs(rng, channels, T)
    coeffs = (audio._FORWARD, audio._FEEDBACK, audio.SHRT_MAX, audio.GAIN)
    before = recurrence.LAUNCHES["digitalvoice_iir"]
    got = recurrence.digitalvoice_iir(pcm.to(dev), xv.to(dev), yv.to(dev),
                                      *coeffs)
    torch.cuda.synchronize()
    assert recurrence.LAUNCHES["digitalvoice_iir"] == before + (1 if T else 0)
    want = recurrence.digitalvoice_iir_plain(pcm, xv, yv, *coeffs)
    _same([g.cpu() for g in got], want)
    if T and T <= 200:  # the plain version on the card, the same
        _same(got, recurrence.digitalvoice_iir_plain(
            pcm.to(dev), xv.to(dev), yv.to(dev), *coeffs))


@pytest.mark.parametrize("channels,T", [
    (1, 1), (1, 11), (3, 319), (3, 321), (17, 961), (256, 783), (257, 700),
    (1, 32768)])
def test_k6_iir_int32_equals_plain_on_card(dev, channels, T):
    """int32 PCM past the int16 range: the kernel's int32 entry equals the
    plain version bit for bit, state included."""
    from digiham_tpu_torch.dsp import audio
    from digiham_tpu_torch.ops import recurrence

    rng = np.random.default_rng(channels * 11 + T)
    pcm, xv, yv = _iir_inputs(rng, channels, T, np.int32)
    if pcm.numel() >= 300:  # the input passes the int16 range
        assert pcm.abs().max() > 32768
    coeffs = (audio._FORWARD, audio._FEEDBACK, audio.SHRT_MAX, audio.GAIN)
    before = recurrence.LAUNCHES["digitalvoice_iir"]
    got = recurrence.digitalvoice_iir(pcm.to(dev), xv.to(dev), yv.to(dev),
                                      *coeffs)
    torch.cuda.synchronize()
    assert recurrence.LAUNCHES["digitalvoice_iir"] == before + 1
    _same([g.cpu() for g in got],
          recurrence.digitalvoice_iir_plain(pcm, xv, yv, *coeffs))


def test_k6_iir_on_a_strided_block_and_chained(dev):
    """Rows of a wider array (row stride != T) and a stream cut into
    uneven blocks give the one-block result."""
    from digiham_tpu_torch.dsp import audio

    rng = np.random.default_rng(61)
    wide = torch.from_numpy(rng.integers(-20000, 20000, (5, 4000))
                            .astype(np.int16)).to(dev)
    pcm = wide[:, 100:3100]
    whole, _ = audio.digitalvoice_filter(
        pcm, audio.DigitalVoiceState.init(5))
    state, parts, o = audio.DigitalVoiceState.init(5), [], 0
    for n in (1, 159, 161, 1679, 1000):
        y, state = audio.digitalvoice_filter(pcm[:, o:o + n], state)
        parts.append(y)
        o += n
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), whole)
    want, _ = audio.digitalvoice_filter(
        pcm.cpu(), audio.DigitalVoiceState.init(5, device="cpu"))
    assert torch.equal(whole.cpu(), want)


@pytest.mark.parametrize("channels,T", [
    (1, 1), (3, 161), (256, 4800), (1, 32768), *_K6_TILE_EDGES,
    *_K6_CHANNELS])
def test_k6_dc_block_equals_plain_on_card(dev, channels, T):
    from digiham_tpu_torch.ops import recurrence

    rng = np.random.default_rng(T)
    x, x1, y1 = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                 for s in ((channels, T), (channels,), (channels,)))
    before = recurrence.LAUNCHES["dc_block"]
    got = recurrence.dc_block(x.to(dev), x1.to(dev), y1.to(dev), 0.999)
    torch.cuda.synchronize()
    assert recurrence.LAUNCHES["dc_block"] == before + 1
    _same([g.cpu() for g in got],
          recurrence.dc_block_plain(x, x1, y1, 0.999))


@pytest.mark.parametrize("sms_times,plus", [
    (1, 0), (1, 1), (2, 0), (2, 1), (16, -1), (16, 0), (16, 1)])
def test_k6_at_the_block_edges(dev, sms_times, plus):
    """Channel counts around the card's multiprocessors times 1, 2 and 16,
    where the channels a block takes (recurrence.block_rows) step, and past
    the most a block takes (more blocks than SMs): both entries equal their
    plain versions, state included."""
    from digiham_tpu_torch.dsp import audio

    channels = sms_times * recurrence.sm_count(
        torch.cuda.current_device()) + plus
    rng = np.random.default_rng(channels)
    pcm, xv, yv = _iir_inputs(rng, channels, 333)
    coeffs = (audio._FORWARD, audio._FEEDBACK, audio.SHRT_MAX, audio.GAIN)
    got = recurrence.digitalvoice_iir(pcm.to(dev), xv.to(dev), yv.to(dev),
                                      *coeffs)
    torch.cuda.synchronize()
    _same([g.cpu() for g in got],
          recurrence.digitalvoice_iir_plain(pcm, xv, yv, *coeffs))
    x, x1, y1 = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                 for s in ((channels, 333), (channels,), (channels,)))
    got = recurrence.dc_block(x.to(dev), x1.to(dev), y1.to(dev), 0.999)
    torch.cuda.synchronize()
    _same([g.cpu() for g in got], recurrence.dc_block_plain(x, x1, y1, 0.999))


def test_k6_dc_block_on_a_strided_view(dev):
    """Rows of a wider array (row stride != T), the view starting one float
    in: equal to the plain version on a contiguous copy."""
    from digiham_tpu_torch.ops import recurrence

    rng = np.random.default_rng(62)
    wide = torch.from_numpy(rng.normal(0, 1, (19, 2000))
                            .astype(np.float32)).to(dev)
    x = wide[:, 1:1700]
    x1, y1 = (torch.from_numpy(rng.normal(0, 1, 19).astype(np.float32))
              for _ in range(2))
    got = recurrence.dc_block(x, x1.to(dev), y1.to(dev), 0.999)
    torch.cuda.synchronize()
    _same([g.cpu() for g in got],
          recurrence.dc_block_plain(x.cpu().contiguous(), x1, y1, 0.999))


@pytest.mark.parametrize("sps,invert,mode", [(10, False, "gfsk"),
                                             (20, False, "gfsk"),
                                             (10, False, "fsk"),
                                             (40, True, "fsk")])
def test_k3_at_one_channel_one_century(dev, sps, invert, mode):
    """The demodulator tools' shape: StreamDriver(1, sps, n_centuries=1)."""
    rng = np.random.default_rng(sps)
    x = fsk_audio(rng, 1, 100 * sps + 1 + 8, sps,
                  FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS)
    args = [t.to(dev) for t in (torch.from_numpy(x), *_state(rng, 1))]
    kw = dict(n_centuries=1, sps=sps, mode=mode, invert=invert)
    before = demod_front.LAUNCHES["none"]
    got = demod_front.demod(*args, **kw)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES["none"] == before + 1
    _same(got, demod_front.demod_plain(*args, **kw))


@pytest.mark.parametrize("design", [rrc.WIDE_RRC, rrc.NARROW_RRC],
                         ids=lambda d: d.name)
def test_k4_at_the_tools_chunk(dev, design):
    """rrc_filter's shape: [1, 16,384] (one 65,536-byte chunk of f32)."""
    rng = np.random.default_rng(design.ntaps)
    x = torch.from_numpy(rng.normal(0, 900, (1, 16384)).astype(np.float32))
    state = rrc.RrcState(torch.from_numpy(
        rng.normal(0, 900, (1, design.ntaps - 1)).astype(np.float32)))
    got = rrc.rrc_filter(x.to(dev), rrc.RrcState(state.history.to(dev)),
                         design)
    _same([got[0].cpu(), got[1].history.cpu()],
          fir.rrc_filter_block_plain(x, state.history,
                                     design.taps_tensor("cpu")))


@pytest.mark.parametrize("chain", [c.name for c in smoke.CLI_CHAINS])
def test_cli_chain_on_card(dev, chain, tmp_path):
    """Each example chain through the port's tools in-process with
    --backend cuda: the DSP stages equal --backend cpu's bytes, and the
    decoder's bytes and metadata equal the fixture's (the JAX tools')."""
    from digiham_tpu_torch.cli import tools
    from torch_cli import run_tool

    ch = {c.name: c for c in smoke.CLI_CHAINS}[chain]
    with np.load(smoke.CLI_FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    data = smoke.cli_audio(ch).tobytes()
    dsp = {"rrc_filter", "fsk_demodulator", "gfsk_demodulator",
           "digitalvoice_filter"}
    meta = str(tmp_path / "meta")
    for tool, args in ch.tools():
        if tool == "mbe_synthesizer":
            break
        main = getattr(tools, f"{tool}_main")
        args = [a.format(meta=meta) for a in args]
        if tool in dsp:
            got = run_tool(main, [*args, "--backend", "cuda"], data)
            assert got == run_tool(main, [*args, "--backend", "cpu"], data)
            data = got
        else:
            data = run_tool(main, args, data)
    assert data == fx[f"{chain}_decoded"].tobytes()
    if ch.meta:
        assert open(meta, "rb").read() == fx[f"{chain}_meta"].tobytes()


# -- the soak programs (digiham_tpu_torch/soak) on the card -------------------

def test_soak_dmr_on_card_equals_the_cpu(dev):
    """The DMR soak at 16 channels x 40 frames: every channel's bytes and
    symbol counts on the card equal the plain versions' on the CPU; K2
    once a step, K4 once in the flush."""
    from digiham_tpu_torch.soak import dmr_soak

    card = dmr_soak.run(channels=16, frames=40, device=dev,
                        log=lambda text: None)
    cpu = dmr_soak.run(channels=16, frames=40, device="cpu",
                       log=lambda text: None)
    assert card["ok"] and card["outputs"] == cpu["outputs"]
    assert card["launches"] == {"rrc": card["steps"], "fir": 1}


@pytest.mark.parametrize("case", ["clean", "clock-150ppm", "urban_combo"])
def test_soak_impaired_on_card_equals_the_cpu(dev, case):
    """Paths A (K1) and B (K2, K4) of the impaired matrix at 8 channels:
    the frame counts of every channel equal the CPU's, nothing
    unclassified."""
    from digiham_tpu_torch.soak import impaired

    card = impaired.run(channels=8, frames=24, cases=[case], device=dev,
                        log=lambda text: None)
    cpu = impaired.run(channels=8, frames=24, cases=[case], device="cpu",
                       log=lambda text: None)
    assert card["ok"]
    for path in "AB":
        assert np.array_equal(card["counts"][case, path],
                              cpu["counts"][case, path])
    assert card["cases"][case]["A"]["launches"] == {
        "fm_rrc": card["cases"][case]["A"]["steps"]}


def test_soak_ser_equiv_cross_path_zero_on_card(dev):
    """K1, K2 and K4 -> K3 give the same symbols at every SNR."""
    from digiham_tpu_torch.soak import ser_equiv

    r = ser_equiv.run(channels=64, reps=1, device=dev, log=lambda text: None)
    assert r["ok"]
    assert all(p["cross_path_mismatch"] == 0 for p in r["points"])
    n = len(ser_equiv.SNRS)
    assert r["launches"] == {"fm_rrc": n, "rrc": n, "fir": n, "none": n}


@pytest.mark.parametrize("proto", ["dmr", "ysf", "nxdn", "dstar", "pocsag"])
def test_soak_fuzz_timesharded_on_card(dev, proto):
    from digiham_tpu_torch.soak import fuzz_timesharded

    # at 4 channels the POCSAG stream of seed 3 walks past the default
    # halo budget of 24 samples (the JAX bank raises there too): 64, as
    # chip_smoke.py's soak phase
    r = fuzz_timesharded.run(cases=1, seed0=3, channels=4, device=dev,
                             proto=proto, drift_budget=64,
                             log=lambda text: None)
    assert r["ok"] and r["launches"]
