"""Carry a stream across between the JAX package and the port.

For this system the filter designs and FEC tables are the "weights" (the
port holds its own copies) and the streaming carries are the state: the
RRC history, the demod's ``pos``/``offset``/``volume_ring`` and, on the
raw-IQ path only, the last I/Q sample. These functions move that state
between the JAX package's pipeline states and the port's through numpy, so
a stream can be handed from one to the other mid-way, and
:func:`from_jax_checkpoint` reads the pipeline state out of a JAX bank's
snapshot (:func:`from_jax_snapshot` the whole snapshot's state and pending
samples, :func:`multistream_shards_from_jax` a multi-process bank's
composite). Every JAX bank state is ``(rrc, demod)``, or the demod carry
alone for a time-sharded bank:

- ``DmrPipelineState``, ``YsfPipelineState``, ``NxdnPipelineState`` and an
  ``FskPipelineState`` built with an RRC design carry the RRC history: 4
  leaves, the port's :class:`~digiham_tpu_torch.pipeline.bank.PipelineState`;
- an ``FskPipelineState`` without an RRC (D-Star's and POCSAG's default)
  has ``rrc=None``: 3 leaves, the port's
  :class:`~digiham_tpu_torch.pipeline.fsk.FskPipelineState` with
  ``rrc=None``;
- a ``TimeShardedTrackedBank``'s ``DemodState``, for every protocol: the
  same 3 leaves, read the same way (the bank takes its ``.demod``).

The audio stages carry their own state: the digital-voice post-filter's
``(xv, yv)`` delay lines and the DC blocker's ``(x1, y1)``
(:func:`digitalvoice_state_from_jax`, :func:`dc_block_state_from_jax`).

Nothing here imports JAX: JAX arrays are read with ``np.asarray``.
"""
from __future__ import annotations

import io
import pickle
from types import SimpleNamespace

import numpy as np
import torch

from . import resolve_device
from .dsp.audio import DigitalVoiceState
from .dsp.demod import DemodState
from .dsp.fm import DcBlockState
from .dsp.rrc import RrcState
from .pipeline.bank import PipelineState
from .pipeline.fsk import FskPipelineState


def from_jax(state, carry=None, device=None):
    """A JAX pipeline state (anything with ``.rrc`` — ``None`` or with a
    ``.history`` — and ``.demod.pos/.offset/.volume_ring``) and, on the
    raw-IQ path, the I/Q carry ``(last_re, last_im)`` -> (port state,
    carry or None) on ``device`` (``None`` is the card). The port state is
    a ``PipelineState``, or an ``FskPipelineState`` with ``rrc=None`` when
    the JAX state has no RRC."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    demod = DemodState(t(state.demod.pos, np.int32),
                       t(state.demod.offset, np.int32),
                       t(state.demod.volume_ring, np.float32))
    if state.rrc is None:
        port = FskPipelineState(rrc=None, demod=demod)
    else:
        port = PipelineState(rrc=RrcState(t(state.rrc.history, np.float32)),
                             demod=demod)
    if carry is None:
        return port, None
    return port, (t(carry[0], np.float32), t(carry[1], np.float32))


def _f32(a, shape, name, device):
    a = np.array(a, dtype=np.float32)
    if a.shape != shape:
        raise ValueError(f"{name}: want {shape}, got {a.shape}")
    return torch.as_tensor(a, device=device)


def digitalvoice_state_from_jax(xv, yv, device=None) -> DigitalVoiceState:
    """The JAX package's ``DigitalVoiceState`` leaves ``xv``, ``yv``
    ([C, 10] each, as numpy or JAX arrays) -> the port's state on
    ``device`` (``None`` is the card), so a post-filter stream started by
    the JAX package continues in the port."""
    device = resolve_device(device)
    C = np.shape(xv)[0]
    return DigitalVoiceState(_f32(xv, (C, 10), "xv", device),
                             _f32(yv, (C, 10), "yv", device))


def dc_block_state_from_jax(x1, y1, device=None) -> DcBlockState:
    """The JAX package's ``DcBlockState`` leaves ``x1``, ``y1`` ([C] each)
    -> the port's state on ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    C = np.shape(x1)[0]
    return DcBlockState(_f32(x1, (C,), "x1", device),
                        _f32(y1, (C,), "y1", device))


class _Opaque:
    """Stands in for every class a JAX checkpoint names (its tree
    definition and the JAX package's state classes): built and called
    with anything, holds nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __setstate__(self, state):
        pass


class _LeavesOnly(pickle.Unpickler):
    """Unpickles a JAX checkpoint without importing what it names: every
    global but numpy's resolves to :class:`_Opaque`, so only the plain
    containers, numpy arrays and the npz bytes come through."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        return _Opaque


def from_jax_checkpoint(blob: bytes, device=None):
    """The payload of the JAX package's ``runtime.checkpoint.save_state``
    for a pipeline state (what a JAX bank's ``snapshot()`` holds under
    ``"pipeline_state"``) -> the port's state on ``device`` (``None`` is the
    card), as :func:`from_jax` gives it.

    The payload is a pickled tree definition beside an npz of the tree's
    leaves in flattening order: ``rrc.history``, ``demod.pos``,
    ``demod.offset``, ``demod.volume_ring`` (4 leaves), or without
    ``rrc.history`` for an ``FskPipelineState`` without an RRC (3 leaves:
    JAX flattens ``rrc=None`` to no leaf). The tree definition is JAX's
    and is not rebuilt; the leaves are checked by type and shape instead.
    With the snapshot's ``"samples"`` pushed into a port bank's buffer this
    hands a JAX bank's device carry and pending samples to a port bank.
    The snapshot's host machines (``"chans"`` or ``"decoders"``) are
    pickled by class path and do not cross packages: the port bank
    re-acquires sync with its own.
    """
    device = resolve_device(device)
    payload = _LeavesOnly(io.BytesIO(blob)).load()
    with np.load(io.BytesIO(payload["npz"])) as npz:
        leaves = [npz[k] for k in npz.files]
    if len(leaves) not in (3, 4):
        raise ValueError(f"want the 4 leaves of a pipeline state (3 without "
                         f"an RRC), got {len(leaves)}")
    history = leaves[0] if len(leaves) == 4 else None
    pos, offset, ring = leaves[-3:]
    C = pos.shape[0] if pos.ndim == 1 else -1
    want = [("demod.pos", pos, np.int32, 1, (C,)),
            ("demod.offset", offset, np.int32, 1, (C,)),
            ("demod.volume_ring", ring, np.float32, 2, (C, 100))]
    if history is not None:
        want.insert(0, ("rrc.history", history, np.float32, 2, None))
    for name, leaf, dtype, ndim, shape in want:
        if (leaf.dtype != dtype or leaf.ndim != ndim or leaf.shape[0] != C
                or (shape is not None and leaf.shape != shape)):
            raise ValueError(f"{name}: want {np.dtype(dtype)} "
                             f"{shape or (C, 'ntaps-1')}, got {leaf.dtype} "
                             f"{leaf.shape}")

    state = SimpleNamespace(
        rrc=None if history is None else SimpleNamespace(history=history),
        demod=SimpleNamespace(pos=pos, offset=offset, volume_ring=ring))
    return from_jax(state, device=device)[0]


def from_jax_snapshot(blob: bytes, device=None):
    """A JAX bank's ``snapshot()`` — its ``TrackedChannelBank``'s, its
    ``TimeShardedTrackedBank``'s, or one shard of its ``MultiStreamBank``'s
    composite — -> (the pipeline state as :func:`from_jax_checkpoint` gives
    it, on ``device``; the pending samples [C, n] float32). A time-sharded
    bank's state is its demod carry alone, 3 leaves for every protocol:
    it comes back as an ``FskPipelineState`` with ``rrc=None`` whose
    ``.demod`` the port's ``TimeShardedTrackedBank`` takes. The host
    machines (``"chans"``) stay behind: the banks' ``restore_jax`` keeps
    its own."""
    payload = _LeavesOnly(io.BytesIO(blob)).load()
    state = from_jax_checkpoint(payload["pipeline_state"], device)
    samples = np.asarray(payload["samples"], np.float32)
    if samples.ndim != 2 or samples.shape[0] != state.demod.pos.shape[0]:
        raise ValueError(f"pending samples {samples.shape} do not match "
                         f"{state.demod.pos.shape[0]} channels")
    return state, samples


def multistream_shards_from_jax(blob: bytes) -> dict:
    """A JAX ``MultiStreamBank.snapshot()`` composite -> its header
    (``protocol``, ``channels``, ``n_procs``) and ``shards``, one JAX bank
    snapshot per worker, for the port's ``MultiStreamBank.restore_jax`` to
    hand each to its worker."""
    payload = _LeavesOnly(io.BytesIO(blob)).load()
    if not isinstance(payload, dict) or "shards" not in payload:
        raise ValueError("not a MultiStreamBank snapshot")
    return {k: payload[k] for k in ("protocol", "channels", "n_procs",
                                    "shards")}


def to_numpy(state, carry=None) -> dict:
    """The port's state as numpy arrays in the JAX package's dtypes, keyed
    by their place in its pytree: ``rrc.history`` (absent when ``rrc`` is
    ``None``), ``demod.pos``, ``demod.offset``, ``demod.volume_ring``; with
    an I/Q carry also ``last_re`` and ``last_im``."""
    def a(x, dtype):
        return x.detach().cpu().numpy().astype(dtype)

    out = {} if state.rrc is None else {
        "rrc.history": a(state.rrc.history, np.float32)}
    out.update({
        "demod.pos": a(state.demod.pos, np.int32),
        "demod.offset": a(state.demod.offset, np.int32),
        "demod.volume_ring": a(state.demod.volume_ring, np.float32),
    })
    if carry is not None:
        out["last_re"] = a(carry[0], np.float32)
        out["last_im"] = a(carry[1], np.float32)
    return out
