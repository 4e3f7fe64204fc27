"""Stream-state checkpoint/resume (port of
``digiham_tpu/runtime/checkpoint.py``).

The reference has no persistence: restart = re-acquire sync. Here every
device-side stage keeps its state in explicit dataclasses of tensors
(``RrcState``, ``DemodState``, ``PipelineState``, ``FskPipelineState``), so
a whole channel bank can be snapshotted to a flat ``.npz`` blob and resumed
bit-exactly. Every tensor is stored as a numpy array under its dotted field
name (``rrc.history``, ``demod.pos``, ...), so a blob written on the card
loads on the CPU and the reverse. A state field that is ``None`` (the RRC
of a 2FSK pipeline without one) stores nothing and comes back ``None``.

Host-side phase machines (protocol decoders) are plain Python objects with
small integer/bytes state; they serialize via ``pickle`` alongside.

.. warning::
   Checkpoints deserialize with :mod:`pickle`, so loading a blob is
   arbitrary code execution. Only load checkpoints you produced yourself
   (same trust domain as the process); never accept them from the network
   or other untrusted sources. A checkpoint is operator data, not user
   data.
"""
from __future__ import annotations

import dataclasses
import io
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..dsp.demod import DemodState
from ..dsp.rrc import RrcState
from ..pipeline.bank import PipelineState
from ..pipeline.fsk import FskPipelineState

# the state classes a checkpoint may hold, and the class of each field
# that is itself a state (every other field is a tensor)
_NESTED = {
    PipelineState: {"rrc": RrcState, "demod": DemodState},
    FskPipelineState: {"rrc": RrcState, "demod": DemodState},
    RrcState: {},
    DemodState: {},
}
_KINDS = {cls.__name__: cls for cls in _NESTED}


def _flatten(state, prefix: str, out: dict) -> None:
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if value is None:
            continue
        if field.name in _NESTED[type(state)]:
            _flatten(value, f"{prefix}{field.name}.", out)
        else:
            out[prefix + field.name] = value.detach().cpu().numpy()


def _build(cls, arrays, prefix: str, device):
    values = {}
    for field in dataclasses.fields(cls):
        nested = _NESTED[cls].get(field.name)
        name = prefix + field.name
        if nested is None:
            values[field.name] = torch.as_tensor(np.array(arrays[name]),
                                                 device=device)
        elif any(k.startswith(name + ".") for k in arrays):
            values[field.name] = _build(nested, arrays, name + ".", device)
        else:  # a state field stored as None (a 2FSK pipeline's RRC)
            values[field.name] = None
    return cls(**values)


def save_state(state) -> bytes:
    """Serialize a ``PipelineState`` or ``FskPipelineState`` (or a bare
    ``RrcState``/``DemodState``) to bytes: its class name plus an npz of
    its tensors by field name."""
    if type(state) not in _NESTED:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    arrays: dict[str, np.ndarray] = {}
    _flatten(state, "", arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return pickle.dumps({"kind": type(state).__name__,
                         "npz": buf.getvalue()})


def load_state(blob: bytes, device=None):
    """Inverse of :func:`save_state`, with the tensors on ``device``
    (``None`` is the card)."""
    device = resolve_device(device)
    payload = pickle.loads(blob)
    with np.load(io.BytesIO(payload["npz"])) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return _build(_KINDS[payload["kind"]], arrays, "", device)


def save_decoder(decoder) -> bytes:
    """Snapshot a host-side protocol decoder (phase machine + buffers)."""
    return pickle.dumps(decoder)


def load_decoder(blob: bytes):
    return pickle.loads(blob)
