"""Carry a stream across between the JAX package and the port.

For this system the filter designs and FEC tables are the "weights" (the
port holds its own copies) and the streaming carries are the state: the
RRC history, the demod's ``pos``/``offset``/``volume_ring`` and, on the
raw-IQ path only, the last I/Q sample. These functions move that state
between a JAX ``DmrPipelineState``, ``YsfPipelineState`` or
``NxdnPipelineState`` (all three are ``(rrc, demod)``) and the port's
:class:`~digiham_tpu_torch.pipeline.bank.PipelineState` through numpy, so
a stream can be handed from one to the other mid-way. Nothing here
imports JAX: JAX arrays are read with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .dsp.demod import DemodState
from .dsp.rrc import RrcState
from .pipeline.bank import PipelineState


def from_jax(state, carry=None, device=None):
    """A JAX pipeline state (anything with ``.rrc.history`` and
    ``.demod.pos/.offset/.volume_ring``) and, on the raw-IQ path, the I/Q
    carry ``(last_re, last_im)`` -> (port state, carry or None) on
    ``device`` (``None`` is the card)."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    port = PipelineState(
        rrc=RrcState(t(state.rrc.history, np.float32)),
        demod=DemodState(t(state.demod.pos, np.int32),
                         t(state.demod.offset, np.int32),
                         t(state.demod.volume_ring, np.float32)))
    if carry is None:
        return port, None
    return port, (t(carry[0], np.float32), t(carry[1], np.float32))


def to_numpy(state: PipelineState, carry=None) -> dict:
    """The port's state as numpy arrays in the JAX package's dtypes, keyed
    by their place in its pytree: ``rrc.history``, ``demod.pos``,
    ``demod.offset``, ``demod.volume_ring``; with an I/Q carry also
    ``last_re`` and ``last_im``."""
    def a(x, dtype):
        return x.detach().cpu().numpy().astype(dtype)

    out = {
        "rrc.history": a(state.rrc.history, np.float32),
        "demod.pos": a(state.demod.pos, np.int32),
        "demod.offset": a(state.demod.offset, np.int32),
        "demod.volume_ring": a(state.demod.volume_ring, np.float32),
    }
    if carry is not None:
        out["last_re"] = a(carry[0], np.float32)
        out["last_im"] = a(carry[1], np.float32)
    return out
