"""Root-raised-cosine channel filters (port of ``digiham_tpu/dsp/rrc.py``).

The reference runs a per-sample direct-form FIR (src/rrc_filter/
rrc_filter.cpp:16-34). Here the same filter runs batched over
``[channels, block]`` with an explicit ``ntaps-1``-sample carry
(overlap-save), so a stream filters to the same values whatever its block
size.

Filter designs are interoperability data (mkshape designs recorded in the
reference):
- wide:   81 taps, gain 8.337797030, for 12.5 kHz channels
  (src/rrc_filter/rrc_filter.cpp:86-112)
- narrow: 161 taps, gain 16.67711971, for 6.25 kHz channels
  (src/rrc_filter/rrc_filter.cpp:36-84)
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import resolve_device
from ..ops.fir import rrc_filter_block_kernel


@dataclasses.dataclass(frozen=True)
class RrcDesign:
    name: str
    gain: float
    taps: tuple[float, ...]

    @property
    def ntaps(self) -> int:
        return len(self.taps)

    @functools.cached_property
    def scaled_taps(self) -> np.ndarray:
        """float32 taps with the gain folded in (the reference divides
        the accumulated sum by gain; scaling each tap keeps one op)."""
        return (np.asarray(self.taps, dtype=np.float64) / self.gain).astype(
            np.float32
        )

    def taps_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.scaled_taps, device=device)


# mkshape -r 6e-02 2.0e-01 81 -w -l  (rrc_filter.cpp:86-112)
WIDE_RRC = RrcDesign(
    "wide", 8.337797030e+00,
    (
        -0.0008938217, -0.0002609230, +0.0005898982, +0.0016095188,
        +0.0026805019, +0.0035892828, +0.0040255371, +0.0036242975,
        +0.0020553299, -0.0008516117, -0.0049736668, -0.0097942071,
        -0.0143781385, -0.0174576799, -0.0176417629, -0.0137316693,
        -0.0050921107, +0.0080011038, +0.0241300735, +0.0407081846,
        +0.0542175970, +0.0607228306, +0.0566126484, +0.0394623171,
        +0.0088613798, -0.0329693214, -0.0809351463, -0.1273151201,
        -0.1625361486, -0.1764143887, -0.1597076656, -0.1057455528,
        -0.0118628528, +0.1196309860, +0.2811569136, +0.4603559944,
        +0.6413467573, +0.8066010425, +0.9391765221, +1.0249723677,
        +1.0546584365, +1.0249723677, +0.9391765221, +0.8066010425,
        +0.6413467573, +0.4603559944, +0.2811569136, +0.1196309860,
        -0.0118628528, -0.1057455528, -0.1597076656, -0.1764143887,
        -0.1625361486, -0.1273151201, -0.0809351463, -0.0329693214,
        +0.0088613798, +0.0394623171, +0.0566126484, +0.0607228306,
        +0.0542175970, +0.0407081846, +0.0241300735, +0.0080011038,
        -0.0050921107, -0.0137316693, -0.0176417629, -0.0174576799,
        -0.0143781385, -0.0097942071, -0.0049736668, -0.0008516117,
        +0.0020553299, +0.0036242975, +0.0040255371, +0.0035892828,
        +0.0026805019, +0.0016095188, +0.0005898982, -0.0002609230,
        -0.0008938217,
    ),
)

# mkshape -r 3e-02 2.0e-01 161 -w -x -l  (rrc_filter.cpp:36-84)
NARROW_RRC = RrcDesign(
    "narrow", 1.667711971e+01,
    (
        -0.0008965127, -0.0006084266, -0.0002629259, +0.0001376901,
        +0.0005891423, +0.0010840181, +0.0016105739, +0.0021516457,
        +0.0026838327, +0.0031771176, +0.0035950725, +0.0038957679,
        +0.0040334554, +0.0039610403, +0.0036332901, +0.0030106572,
        +0.0020635228, +0.0007766025, -0.0008467956, -0.0027810092,
        -0.0049751193, -0.0073512625, -0.0098044779, -0.0122043473,
        -0.0143986008, -0.0162187503, -0.0174876896, -0.0180290597,
        -0.0176780431, -0.0162931143, -0.0137681562, -0.0100442577,
        -0.0051204456, +0.0009374242, +0.0079903670, +0.0158232514,
        +0.0241456376, +0.0325968938, +0.0407558163, +0.0481547523,
        +0.0542979823, +0.0586838603, +0.0608299644, +0.0603002781,
        +0.0567332283, +0.0498692532, +0.0395764841, +0.0258730951,
        +0.0089449258, -0.0108429006, -0.0329414440, -0.0566213193,
        -0.0809844704, -0.1049844817, -0.1274551627, -0.1471467396,
        -0.1627685874, -0.1730370678, -0.1767267207, -0.1727227994,
        -0.1600729711, -0.1380359261, -0.1061246612, -0.0641423317,
        -0.0122087987, +0.0492236806, +0.1193667582, +0.1971049660,
        +0.2810174958, +0.3694123940, +0.4603722307, +0.5518097911,
        +0.6415318736, +0.7273088884, +0.8069476569, +0.8783646253,
        +0.9396566353, +0.9891664557, +1.0255404526, +1.0477760738,
        +1.0552572221, +1.0477760738, +1.0255404526, +0.9891664557,
        +0.9396566353, +0.8783646253, +0.8069476569, +0.7273088884,
        +0.6415318736, +0.5518097911, +0.4603722307, +0.3694123940,
        +0.2810174958, +0.1971049660, +0.1193667582, +0.0492236806,
        -0.0122087987, -0.0641423317, -0.1061246612, -0.1380359261,
        -0.1600729711, -0.1727227994, -0.1767267207, -0.1730370678,
        -0.1627685874, -0.1471467396, -0.1274551627, -0.1049844817,
        -0.0809844704, -0.0566213193, -0.0329414440, -0.0108429006,
        +0.0089449258, +0.0258730951, +0.0395764841, +0.0498692532,
        +0.0567332283, +0.0603002781, +0.0608299644, +0.0586838603,
        +0.0542979823, +0.0481547523, +0.0407558163, +0.0325968938,
        +0.0241456376, +0.0158232514, +0.0079903670, +0.0009374242,
        -0.0051204456, -0.0100442577, -0.0137681562, -0.0162931143,
        -0.0176780431, -0.0180290597, -0.0174876896, -0.0162187503,
        -0.0143986008, -0.0122043473, -0.0098044779, -0.0073512625,
        -0.0049751193, -0.0027810092, -0.0008467956, +0.0007766025,
        +0.0020635228, +0.0030106572, +0.0036332901, +0.0039610403,
        +0.0040334554, +0.0038957679, +0.0035950725, +0.0031771176,
        +0.0026838327, +0.0021516457, +0.0016105739, +0.0010840181,
        +0.0005891423, +0.0001376901, -0.0002629259, -0.0006084266,
        -0.0008965127,
    ),
)


@dataclasses.dataclass
class RrcState:
    """Streaming carry: the last ``ntaps-1`` input samples per channel
    (zeros at stream start, like the reference's calloc'd delay line)."""

    history: torch.Tensor  # [channels, ntaps-1] float32

    @staticmethod
    def init(channels: int, design: RrcDesign = WIDE_RRC,
             device=None) -> "RrcState":
        """Stream-start carry; ``device=None`` is the card."""
        return RrcState(torch.zeros((channels, design.ntaps - 1),
                                    dtype=torch.float32,
                                    device=resolve_device(device)))


def rrc_filter_block(samples: torch.Tensor, state: RrcState,
                     design: RrcDesign = WIDE_RRC,
                     taps: torch.Tensor | None = None):
    """Filter one block. samples: [channels, block] float32.

    Returns (filtered [channels, block], new state):
    ``y[t] = sum_j taps[j] * x[t + j]`` over ``x = [history | samples]``,
    a cross-correlation with the taps unreversed (the newest sample meets
    ``taps[ntaps-1]``), as XLA's conv in the JAX package computes it. The
    new history is a copy of the last ``ntaps-1`` columns of ``x``.

    CUDA samples launch kernel K4 (ops/fir.py, csrc/fir.cu) or raise; CPU
    samples take its plain version. Both sum tap by tap in one fixed order,
    each product and each sum rounded to float32 on its own: the order of
    the FIR inside the fused CUDA fronts K1/K2 (ops/demod_front.py), so on
    the card this function, its plain version and K2's internal filtered
    row agree bit for bit. ``taps`` is the design's scaled taps on the
    samples' device (pipelines pass their registered buffer).
    """
    if taps is None:
        taps = design.taps_tensor(samples.device)
    y, history = rrc_filter_block_kernel(samples, state.history, taps)
    return y, RrcState(history)


def rrc_filter(samples: torch.Tensor, state: RrcState,
               design: RrcDesign = WIDE_RRC):
    """The streaming filter: :func:`rrc_filter_block` on one block (kernel
    K4 on the card), the carry passed on; the JAX package's jit wrapper of
    the same name."""
    return rrc_filter_block(samples, state, design)


def rrc_filter_np(samples: np.ndarray, design: RrcDesign = WIDE_RRC,
                  history: np.ndarray | None = None) -> np.ndarray:
    """Host-side oracle: per-sample delay-line semantics, float32 accumulate
    in the reference's summation order (rrc_filter.cpp:22-34)."""
    coeffs = np.asarray(design.taps, dtype=np.float32)
    n = design.ntaps
    samples = np.asarray(samples, dtype=np.float32)
    out = np.zeros_like(samples)
    delay = np.zeros(n, dtype=np.float32)
    if history is not None:
        delay[n - 1 - len(history):n - 1] = history
    for t in range(samples.shape[-1]):
        delay[:-1] = delay[1:]
        delay[-1] = samples[t]
        acc = np.float32(0)
        for j in range(n):
            acc = np.float32(acc + coeffs[j] * delay[j])
        out[t] = np.float32(acc / np.float32(design.gain))
    return out


class RrcStreamNp:
    """Fast host-side streaming RRC for single-channel CLI use.

    Vectorized correlation in float64, rounded to float32 once per output
    sample: within the f32 precision envelope of both the device path
    (``rrc_filter_block``) and the reference's sequential f32 accumulation
    (rrc_filter.cpp:22-34), without the per-sample Python loop of
    :func:`rrc_filter_np`. Starts in milliseconds.
    """

    def __init__(self, design: RrcDesign = WIDE_RRC):
        self.design = design
        self._taps64 = design.scaled_taps.astype(np.float64)
        self.history = np.zeros(design.ntaps - 1, np.float32)

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.concatenate([self.history,
                            np.asarray(samples, dtype=np.float32)])
        # y[t] = sum_j taps[j] * x[t + j]  (newest sample -> last tap),
        # same orientation as rrc_filter_block.
        y = np.correlate(x.astype(np.float64), self._taps64,
                         mode="valid").astype(np.float32)
        self.history = x[len(x) - (self.design.ntaps - 1):]
        return y
