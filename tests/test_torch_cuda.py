"""Kernels K1, K2, K3 and K5 on the card: each builds, launches, counts
its launches and equals its plain version; what a kernel cannot take
raises; the audio pipelines run on the card and equal their CPU runs.
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
                                           viterbi_decode_plain)
from digiham_tpu_torch.ops import demod_front, viterbi
from digiham_tpu_torch.pipeline import (DmrPipeline, NxdnPipeline,
                                        YsfPipeline, nxdn_decode_frames)

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
    with pytest.raises(ValueError, match="shared memory"):
        big = [torch.zeros((C, 40000), device=dev)] * 2
        demod_front.demod_fm_front(*big, *args[2:], n_centuries=NC, sps=SPS)


@pytest.mark.parametrize("design,sps,nc,mode,invert", [
    (rrc.WIDE_RRC, 10, 3, "gfsk", False),
    (rrc.NARROW_RRC, 20, 2, "gfsk", False),
    (CUSTOM_129, 10, 3, "gfsk", False),
    (rrc.WIDE_RRC, 40, 2, "fsk", True),
], ids=["wide81", "narrow161", "custom129", "fsk_inverted_sps40"])
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


def test_k2_overlong_block_raises_with_the_bytes_needed(dev):
    """K2 holds its row in shared memory: a block that does not fit
    raises a ValueError that names the bytes needed and the limit, and
    nothing runs in its place."""
    length = 40 * 1001 + 40  # 40 centuries at sps 10
    args = [torch.zeros((C, length), device=dev),
            torch.zeros((C, 80), device=dev), rrc.WIDE_RRC.taps_tensor(dev),
            *(t.to(dev) for t in _state(np.random.default_rng(0), C))]
    need = demod_front.smem_bytes(length, 81, 10, 40, "rrc")
    before = dict(demod_front.LAUNCHES)
    with pytest.raises(ValueError, match=f"{need} B of shared memory"):
        demod_front.demod_front(*args, n_centuries=40, sps=10)
    assert demod_front.LAUNCHES == before


@pytest.mark.parametrize("T,blocked", [(100, 0), (36, 4), (96, 4)])
@pytest.mark.parametrize("batch", [1, 129, 512])
def test_k5_equals_plain_on_card(dev, T, blocked, batch):
    rng = np.random.default_rng(T + batch)
    bits = rng.integers(0, 2, (batch, T))
    bits[:, :blocked] = 0
    noisy = conv_encode(bits)
    flips = rng.random(noisy.shape) < 0.12
    noisy = np.where(flips, noisy ^ rng.integers(1, 4, noisy.shape), noisy)
    cases = [noisy, rng.integers(0, 4, (batch, T)),
             np.zeros((batch, T), np.int64), np.full((batch, T), 3)]
    for obs in cases:
        obs = torch.from_numpy(obs).to(dev)
        before = viterbi.LAUNCHES
        got = viterbi_decode(obs, 16, blocked)
        torch.cuda.synchronize()
        assert viterbi.LAUNCHES == before + 1
        _same(got, viterbi_decode_plain(obs, 16, blocked))


def test_k5_rejects_what_it_cannot_take(dev):
    with pytest.raises(ValueError, match="steps"):
        viterbi.viterbi16(torch.zeros((2, viterbi.MAX_STEPS + 1),
                                      dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi16(torch.zeros((2, 10), dtype=torch.int32,
                                      device=dev), blocked_steps=2)


def test_default_device_is_the_card(dev):
    assert DmrPipeline(channels=2).device.type == "cuda"
    assert demod_init(2).pos.device.type == "cuda"
    assert rrc.RrcState.init(2).history.device.type == "cuda"


def _launch_counts():
    return dict(demod_front.LAUNCHES, viterbi=viterbi.LAUNCHES)


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
            want["viterbi"] = {"dmr": 0, "nxdn": 3}.get(protocol, 2)
        assert launched == want
    for k, v in outs["cpu"].items():
        assert torch.equal(outs[dev][k], v), k
