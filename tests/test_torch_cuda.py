"""Kernel K1 on the card: it builds, launches, counts its launches and
equals its plain version bit for bit; the CUDA paths that need unported
kernels raise. Needs an NVIDIA GPU and nvcc (marker ``cuda``); without a
card every test here skips. Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which a machine with
the card need not have)."""
import numpy as np
import pytest
import torch

from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.dsp.demod import DemodState, rrc_demod_block
from digiham_tpu_torch.ops import demod_front
from digiham_tpu_torch.pipeline import DmrPipeline

from torch_parity import FOUR_LEVELS, TWO_LEVELS, fsk_iq

pytestmark = pytest.mark.cuda

C, SPS, NC = 8, 10, 3
L = NC * (100 * SPS + 1) + 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 is CUDA C++ only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(dev, mode, seed=0):
    rng = np.random.default_rng(seed)
    re, im = fsk_iq(rng, C, L, SPS,
                    FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS,
                    drift=5e-4)
    t = [torch.from_numpy(re), torch.from_numpy(im),
         torch.from_numpy(re[:, 0]), torch.from_numpy(im[:, 0]),
         torch.from_numpy(rng.normal(0, 300, (C, 80)).astype(np.float32)),
         rrc.WIDE_RRC.taps_tensor(None),
         torch.from_numpy(rng.integers(0, 20, C).astype(np.int32)),
         torch.from_numpy(rng.integers(-1, 2, C).astype(np.int32)),
         torch.from_numpy(rng.normal(0, 300, (C, 100)).astype(np.float32))]
    return [x.to(dev) for x in t]


@pytest.mark.parametrize("mode,invert", [("gfsk", False), ("fsk", False),
                                         ("fsk", True)])
def test_k1_equals_plain_on_card(dev, mode, invert):
    args = _args(dev, mode)
    before = demod_front.LAUNCHES
    got = demod_front.demod_fm_front(*args, n_centuries=NC, sps=SPS,
                                     mode=mode, invert=invert)
    torch.cuda.synchronize()
    assert demod_front.LAUNCHES == before + 1
    want = demod_front.demod_fm_front_plain(*args, n_centuries=NC, sps=SPS,
                                            mode=mode, invert=invert)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_k1_rejects_what_it_cannot_take(dev):
    args = _args(dev, "gfsk")
    with pytest.raises(ValueError, match="hist"):
        demod_front.demod_fm_front(*args[:4], args[4][:, :79], *args[5:],
                                   n_centuries=NC, sps=SPS)
    with pytest.raises(ValueError, match="shared memory"):
        big = [torch.zeros((C, 40000), device=dev)] * 2
        demod_front.demod_fm_front(*big, *args[2:], n_centuries=NC, sps=SPS)


def test_audio_paths_raise_naming_k2(dev):
    x = torch.zeros((C, L), device=dev)
    st = DemodState(torch.zeros(C, dtype=torch.int32, device=dev),
                    torch.zeros(C, dtype=torch.int32, device=dev),
                    torch.zeros((C, 100), device=dev))
    with pytest.raises(NotImplementedError, match="K2"):
        rrc_demod_block(x, rrc.RrcState.init(C, device=dev), st, NC, SPS,
                        rrc.WIDE_RRC)
    pipe = DmrPipeline(C, SPS, NC, device=dev)
    with pytest.raises(NotImplementedError, match="K2"):
        pipe.step(x, pipe.init_state())
