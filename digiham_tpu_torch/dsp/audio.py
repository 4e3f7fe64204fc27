"""Digital-voice audio post-filter (port of ``digiham_tpu/dsp/audio.py``):
order-5 Butterworth bandpass 200-3400 Hz @ 8 kHz, expressed as the
reference's order-10 direct-form difference equation
(src/digitalvoice_filter/digitalvoice_filter.cpp:33-46), with the
empirical GAIN 5 (digitalvoice_filter.cpp:28-31) and short<->float scaling
by SHRT_MAX (digitalvoice_filter.cpp:6-10).

An IIR is sequential per sample. The JAX package runs it as a ``lax.scan``;
here it is kernel K6 on the card (``ops/recurrence.py``,
``csrc/recurrence.cu``: one chain lane per channel beside helper warps that
pre-compute the forward sums, one launch per block) and its plain version
on the CPU. The output saturates to the int16 range, as
the JAX function's does; the host oracle :class:`DigitalVoiceFilterNp`
keeps the reference's wrapping cast.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.recurrence import ORDER, digitalvoice_iir

GAIN = 5.0           # digitalvoice_filter.cpp:31
SHRT_MAX = 32767.0   # scaling (digitalvoice_filter.cpp:8)

# Feedback coefficients for yv[0..9] (digitalvoice_filter.cpp:38-45).
_FEEDBACK = np.array(
    [
        0.1254306222, 0.1285714097, -0.8106454980, -0.7664515771,
        2.1846187758, 1.8106678608, -3.1465011600, -2.0391991609,
        2.4873968618, 1.0249072542,
    ],
    dtype=np.float32,
)
# Feedforward: (x10 - x0) + 5*(x2 - x8) + 10*(x6 - x4)
_FORWARD = np.array(
    [-1.0, 0.0, 5.0, 0.0, -10.0, 0.0, 10.0, 0.0, -5.0, 0.0, 1.0],
    dtype=np.float32,
)


@dataclasses.dataclass
class DigitalVoiceState:
    xv: torch.Tensor  # [C, 10] last 10 scaled inputs, oldest first
    yv: torch.Tensor  # [C, 10] last 10 outputs, oldest first

    @staticmethod
    def init(channels: int, device=None) -> "DigitalVoiceState":
        """Stream-start carry; ``device=None`` is the card."""
        device = resolve_device(device)
        return DigitalVoiceState(
            torch.zeros((channels, ORDER), dtype=torch.float32,
                        device=device),
            torch.zeros((channels, ORDER), dtype=torch.float32,
                        device=device),
        )


def digitalvoice_filter(pcm: torch.Tensor, state: DigitalVoiceState):
    """Filter a block of PCM. pcm: [C, T] int16 or int32 (past the int16
    range too, as the JAX function takes it) on the state's device.

    Returns (filtered [C, T] int16, new state). CUDA tensors launch K6 or
    raise; CPU tensors take its plain version. Values beyond the int16
    range saturate."""
    out, xv, yv = digitalvoice_iir(pcm, state.xv, state.yv, _FORWARD,
                                   _FEEDBACK, SHRT_MAX, GAIN)
    return out, DigitalVoiceState(xv, yv)


class DigitalVoiceFilterNp:
    """Host oracle: per-sample loop identical to the reference expression
    order (digitalvoice_filter.cpp:33-46)."""

    def __init__(self):
        self.xv = np.zeros(11, np.float32)
        self.yv = np.zeros(11, np.float32)

    def process(self, pcm: np.ndarray) -> np.ndarray:
        out = np.zeros_like(pcm, dtype=np.int16)
        for i, s in enumerate(np.asarray(pcm)):
            xv, yv = self.xv, self.yv
            xv[:-1] = xv[1:]
            xv[10] = np.float32(s / SHRT_MAX) / np.float32(GAIN)
            yv[:-1] = yv[1:]
            yv[10] = (
                (xv[10] - xv[0]) + 5 * (xv[2] - xv[8]) + 10 * (xv[6] - xv[4])
                + _FEEDBACK[0] * yv[0] + _FEEDBACK[1] * yv[1]
                + _FEEDBACK[2] * yv[2] + _FEEDBACK[3] * yv[3]
                + _FEEDBACK[4] * yv[4] + _FEEDBACK[5] * yv[5]
                + _FEEDBACK[6] * yv[6] + _FEEDBACK[7] * yv[7]
                + _FEEDBACK[8] * yv[8] + _FEEDBACK[9] * yv[9]
            )
            out[i] = np.int16(np.float32(yv[10]) * SHRT_MAX)
        return out
