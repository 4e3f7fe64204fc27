"""IQ ingest front end: the FM quadrature discriminator (port of
``digiham_tpu/dsp/fm.py::fm_discriminator``; ``dc_block`` is not ported
yet).

The port takes I/Q as float32 planes, the layout the fused CUDA front
reads. The op order is the JAX package's complex form written out in real
arithmetic: ``prod = iq * conj(prev)`` as
``re*pre + im*pim`` and ``im*pre - re*pim``, then ``atan2``, then ``/ pi``,
each step rounded to float32 on its own. The CUDA front computes the same
sequence with ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn`` and ``atan2f``,
which is also what ``torch.atan2`` calls on the card.
"""
from __future__ import annotations

import numpy as np
import torch

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
