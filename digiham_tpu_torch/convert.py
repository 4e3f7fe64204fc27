"""Carry a stream across between the JAX package and the port.

For this system the filter designs and FEC tables are the "weights" (the
port holds its own copies) and the streaming carries are the state: the
RRC history, the demod's ``pos``/``offset``/``volume_ring``, and the last
I/Q sample. These functions move that state between a JAX
``digiham_tpu.pipeline.dmr.DmrPipelineState`` and the port's
:class:`~digiham_tpu_torch.pipeline.dmr.DmrPipelineState` through numpy,
so a stream can be handed from one to the other mid-way. Nothing here
imports JAX: JAX arrays are read with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .dsp.demod import DemodState
from .dsp.rrc import RrcState
from .pipeline.dmr import DmrPipelineState


def from_jax(state, carry, device=None):
    """A JAX ``DmrPipelineState`` (anything with ``.rrc.history`` and
    ``.demod.pos/.offset/.volume_ring``) plus the I/Q carry
    ``(last_re, last_im)`` -> (port state, (last_re, last_im)) on
    ``device``."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    port = DmrPipelineState(
        rrc=RrcState(t(state.rrc.history, np.float32)),
        demod=DemodState(t(state.demod.pos, np.int32),
                         t(state.demod.offset, np.int32),
                         t(state.demod.volume_ring, np.float32)))
    return port, (t(carry[0], np.float32), t(carry[1], np.float32))


def to_numpy(state: DmrPipelineState, carry) -> dict:
    """The port's state and I/Q carry as numpy arrays in the JAX package's
    dtypes, keyed by their place in its pytree: ``rrc.history``,
    ``demod.pos``, ``demod.offset``, ``demod.volume_ring``, ``last_re``,
    ``last_im``."""
    def a(x, dtype):
        return x.detach().cpu().numpy().astype(dtype)

    return {
        "rrc.history": a(state.rrc.history, np.float32),
        "demod.pos": a(state.demod.pos, np.int32),
        "demod.offset": a(state.demod.offset, np.int32),
        "demod.volume_ring": a(state.demod.volume_ring, np.float32),
        "last_re": a(carry[0], np.float32),
        "last_im": a(carry[1], np.float32),
    }
