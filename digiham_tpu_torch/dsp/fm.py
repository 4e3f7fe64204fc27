"""IQ ingest front end: the FM quadrature discriminator and the DC blocker
(port of ``digiham_tpu/dsp/fm.py``).

The port takes I/Q as float32 planes, the layout the fused CUDA front
reads. The op order is the JAX package's complex form written out in real
arithmetic: ``prod = iq * conj(prev)`` as
``re*pre + im*pim`` and ``im*pre - re*pim``, then ``atan2``, then ``/ pi``,
each step rounded to float32 on its own. The CUDA front computes the same
sequence with ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn`` and ``atan2f``,
which is also what ``torch.atan2`` calls on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.recurrence import dc_block as _dc_block_kernel

PI_F32 = float(np.float32(np.pi))


def fm_discriminator(re: torch.Tensor, im: torch.Tensor,
                     last_re: torch.Tensor, last_im: torch.Tensor):
    """re, im: [C, T] float32 planes; last_re, last_im: [C] carry (the
    previous block's last sample, 1+0j at stream start).

    Returns (audio [C, T] float32 = phase step / pi, (new_last_re,
    new_last_im)).
    """
    pre = torch.cat([last_re[:, None], re[:, :-1]], dim=1)
    pim = torch.cat([last_im[:, None], im[:, :-1]], dim=1)
    prod_re = re * pre + im * pim
    prod_im = im * pre - re * pim
    # a 0-dim tensor on the same device, not a Python float: with a
    # Python scalar divisor the CUDA kernel multiplies by the rounded
    # reciprocal instead of dividing (torch.full fills on the device,
    # with no host-to-device copy)
    pi = torch.full((), PI_F32, dtype=torch.float32, device=re.device)
    audio = torch.atan2(prod_im, prod_re) / pi
    return audio, (re[:, -1].clone(), im[:, -1].clone())


@dataclasses.dataclass
class DcBlockState:
    x1: torch.Tensor  # [C] previous input
    y1: torch.Tensor  # [C] previous output

    @staticmethod
    def init(channels: int, device=None) -> "DcBlockState":
        """Stream-start carry; ``device=None`` is the card."""
        device = resolve_device(device)
        return DcBlockState(
            torch.zeros((channels,), dtype=torch.float32, device=device),
            torch.zeros((channels,), dtype=torch.float32, device=device),
        )


def dc_block(x: torch.Tensor, state: DcBlockState, alpha: float = 0.999):
    """Single-pole DC blocker y[n] = (x[n] - x[n-1]) + a*y[n-1] over
    x [C, T] float32, in sequence with float32 roundings (the JAX package
    takes an associative scan, another rounding order: the two agree
    within float32 accumulation). CUDA tensors launch kernel K6's
    ``dc_block`` entry or raise; CPU tensors take its plain version.

    Returns (y [C, T], new state)."""
    y, x1, y1 = _dc_block_kernel(x, state.x1, state.y1, alpha)
    return y, DcBlockState(x1, y1)
