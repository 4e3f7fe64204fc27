"""A bank's decode round on the card as one replay of a captured CUDA graph.

A decode round (an adapter's ``decode_fields``) runs its protocol's
``*_decode_frames`` on the round's padded frame batch: a chain of hundreds
of small ops (687 launches a DMR round at 3,328 rows, 300 in YSF, 86 in
NXDN), the same launch sequence whatever the frames hold, then one
blocking copy per field. On the card the host's cost per op, not the rows,
sets the round's time. :func:`replayed` runs the chain there as one replay
of a captured ``torch.cuda.CUDAGraph``:

- the round's frames go into a pinned staging buffer, then with one
  non-blocking copy into the graph's static input;
- the graph ends by packing every field's bytes into one static buffer
  (:func:`pack`), which comes back in one copy to a pinned host buffer and
  one synchronize, counted as one of the tracer's ``fetches``;
- the host splits one numpy copy of those bytes (nothing it hands out
  aliases a buffer the next round overwrites) into the dict the eager path
  gives: the same keys, dtypes, shapes and values (:func:`unpack`).

When a call graphs depends only on what it can observe. A pipeline off the
card returns ``None`` (the caller runs the chain eagerly, as before). On
the card a (decode, device, tables, batch shape) is captured on its second
use, up to ``MAX_GRAPHS`` a pipeline; a shape used once stays eager. The
capture follows PyTorch's recipe: the chain runs once on a side stream
(the warm-up, whose fields are that round's answer), then is captured on
it. Capturing launches nothing on the device, so what it added to K5's
launch counters (``ops/viterbi.py``) is taken back, and every replay adds
the launches its graph holds. The graphs live in a table keyed weakly by
the pipeline, never on it: a pickled or deep-copied pipeline (a bank's
snapshot, the mesh bank's shards) carries none. ``graph_captures`` and
``graph_replays`` (``runtime/metrics.py``) count captures and the decode
calls a replay served.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..ops import viterbi
from ..ops.build import on_device
from .metrics import TRACER

MAX_GRAPHS = 4   # graphs one pipeline keeps
MAX_SEEN = 16    # shapes one pipeline remembers having seen

# pipeline -> _Graphs
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pack(fields: dict):
    """The graph's last step: every field's bytes in one uint8 tensor, and
    the layout that :func:`unpack` splits them by: per field, in the
    dict's order, (key, numpy dtype, shape, byte offset, bytes). Fields
    lie by element size, widest first, so each starts aligned to its own."""
    order = sorted(fields, key=lambda k: -fields[k].element_size())
    offsets, at = {}, 0
    for k in order:
        offsets[k] = at
        at += fields[k].numel() * fields[k].element_size()
    layout = tuple(
        (k, torch.empty(0, dtype=t.dtype).numpy().dtype, tuple(t.shape),
         offsets[k], t.numel() * t.element_size())
        for k, t in fields.items())
    packed = torch.cat([fields[k].contiguous().view(torch.uint8).reshape(-1)
                        for k in order])
    return packed, layout


def unpack(buf: np.ndarray, layout) -> dict:
    """The field dict of ``buf`` (the bytes :func:`pack` made), as views
    of it."""
    return {k: buf[at:at + n].view(dtype).reshape(shape)
            for k, dtype, shape, at, n in layout}


class _Graph:
    """One captured decode: the graph, the tables it reads, its pinned
    staging and static input, its static packed output, the pinned host
    buffer it comes back to, the layout, and the K5 launches it holds."""

    __slots__ = ("graph", "tables", "staging", "frames", "packed", "host",
                 "layout", "launches")


class _Graphs:
    """One pipeline's graphs by key, and the keys it has seen."""

    __slots__ = ("captured", "seen")

    def __init__(self):
        self.captured: dict = {}
        self.seen: set = set()


def replayed(fn, frames: np.ndarray, pipeline):
    """The round's fields as ``fn(frames, pipeline.tables())`` gives them,
    on the host, through a captured graph; ``None`` where the call stays
    eager: a pipeline off the card, or a shape's first use."""
    dev = pipeline.device
    if dev.type != "cuda":
        return None
    tables = pipeline.tables()
    tensors = [getattr(tables, f.name) for f in dataclasses.fields(tables)]
    key = (fn, dev, tuple(t.data_ptr() for t in tensors), frames.shape,
           frames.dtype.str)
    graphs = _GRAPHS.get(pipeline)
    if graphs is None:
        graphs = _GRAPHS[pipeline] = _Graphs()
    g = graphs.captured.get(key)
    if g is not None:
        return _replay(g, frames, dev)
    if key in graphs.seen and len(graphs.captured) < MAX_GRAPHS:
        g, host = _capture(fn, frames, tables, dev)
        graphs.captured[key] = g
        return host
    if len(graphs.seen) < MAX_SEEN:
        graphs.seen.add(key)
    return None


def _capture(fn, frames: np.ndarray, tables, dev):
    """Capture ``fn`` at this round's shape: (the graph, the round's
    fields from the warm-up run)."""
    g = _Graph()
    g.tables = tables
    g.staging = torch.from_numpy(frames).pin_memory()
    with on_device(dev):
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        g.frames = g.staging.to(dev, non_blocking=True)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            packed, g.layout = pack(fn(g.frames, tables))
        before = dict(viterbi.LAUNCHES_BY_STATES)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, stream=side):
            g.packed, _ = pack(fn(g.frames, tables))
        g.launches = {s: n - before[s]
                      for s, n in viterbi.LAUNCHES_BY_STATES.items()}
        viterbi.count_launches(g.launches, -1)
        g.host = torch.empty(g.packed.shape, dtype=torch.uint8,
                             pin_memory=True)
        current.wait_stream(side)
        host = _fetch(g, packed, current)
    TRACER.counts.graph_captures += 1
    return g, host


def _replay(g: _Graph, frames: np.ndarray, dev) -> dict:
    g.staging.numpy()[...] = frames
    with on_device(dev):
        current = torch.cuda.current_stream(dev)
        g.frames.copy_(g.staging, non_blocking=True)
        g.graph.replay()
        viterbi.count_launches(g.launches)
        host = _fetch(g, g.packed, current)
    TRACER.counts.graph_replays += 1
    return host


def _fetch(g: _Graph, packed: torch.Tensor, stream) -> dict:
    """``packed`` to the host in one copy, counted as a fetch, split by the
    graph's layout."""
    T = TRACER
    T.counts.fetches += 1
    with T.span("bank.fetch"):
        g.host.copy_(packed, non_blocking=True)
        stream.synchronize()
    return unpack(g.host.numpy().copy(), g.layout)
