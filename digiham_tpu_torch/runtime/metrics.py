"""Spans and counters of the streaming banks, and profiling hooks.

The reference has no profiling at all (SURVEY.md §5). A many-channel
deployment needs to know where a bank step's time goes and how much work
it did, so the banks carry one process-wide :data:`TRACER`:

- **Counters** (:data:`COUNTERS`), always kept: the code that does the work
  adds to ``TRACER.counts`` in place, once a step or a decode round (inside
  per-channel loops a local is summed first, never the tracer per
  channel; ``emb_lcs``, ``sacch_sfs`` and the ``dstar_*`` counters alone
  are counted where a machine checks an embedded LC, completes a SACCH
  superframe or decodes a D-Star header, a few to a few hundred times a
  step).
- **Spans**, off by default. Off, a span site costs one attribute check
  and a shared no-op context manager: no clock read, no allocation.
  :meth:`Tracer.start` turns them on: each span then keeps its name, its
  start and end by ``time.perf_counter_ns()``, its parent and its step in
  a bounded ring (an operator's long run holds its newest spans), and a
  step's span carries what the counters added since the previous step.
- **The shared clock.** ``start`` and ``write`` read
  ``time.perf_counter_ns()`` and ``time.time_ns()`` back to back (the
  record's anchors). ``torch.profiler``'s Kineto events are in Unix time,
  so :meth:`Tracer.unix_ns` maps every span onto a device trace's timeline;
  the program opens no ``record_function`` range, which Kineto would show
  as a device annotation.

``DIGIHAM_METRICS_EVERY=<seconds>`` turns on a periodic report on stderr,
one JSON line of the counters over the interval: channel-samples a second,
steps, decode rounds, frames, NXDN's SACCH superframes, D-Star's headers
(from the air, failed, from slow data), the decode graphs captured and
replayed, the sample store's uploads and the uploads that waited for their
staging slot, and the fast-skip and decode-fill ratios.
:func:`torch_trace` writes a Chrome trace of the host, the card and the
program's spans.
"""
from __future__ import annotations

import collections
import contextlib
import json
import operator
import os
import sys
import time

# samples: channel-samples a device step took in; steps: device steps;
# rounds: decode rounds that sent a batch; rows_sent: the rows of those
# batches, padding included; frames: the rows that held a frame; fetches:
# blocking device-to-host copies; hunting: channels a device step appended
# dibits to while they hunted with no tracker; fast_skips: those of them
# the device gate let skip; locks, losses: trackers made and lost;
# voice_frames: voice frames handed to on_output; emb_lcs: embedded LCs
# the DMR trackers reassembled and checked (one a voice superframe a slot);
# sacch_sfs: SACCH superframes the NXDN trackers assembled (one every four
# frames of a call); graph_captures: decode chains captured as CUDA graphs;
# graph_replays: decode calls a graph's replay served
# (runtime/decode_graph.py); uploads: chunks a push wrote into the tracked
# bank's sample store, one a device's row range (on the card each one copy
# into pinned staging and one asynchronous upload); upload_waits: those
# whose staging slot was still in flight (runtime/stream.py);
# dstar_headers, dstar_header_fails: D-Star radio headers a header sync's
# 660 bits gave (Viterbi and CRC passed) and did not give (the Viterbi's
# metric over 10 or the CRC failed), by the hunts and the per-channel
# machines alike; dstar_slow_headers: headers the D-Star voice machines and
# trackers took from a superframe's slow data, their CRC passed
COUNTERS = ("samples", "steps", "rounds", "rows_sent", "frames", "fetches",
            "hunting", "fast_skips", "locks", "losses", "voice_frames",
            "emb_lcs", "sacch_sfs", "graph_captures", "graph_replays",
            "uploads", "upload_waits", "dstar_headers", "dstar_header_fails",
            "dstar_slow_headers")
_values = operator.attrgetter(*COUNTERS)


def _anchor() -> tuple[int, int]:
    """(perf_counter_ns, time_ns), read back to back."""
    return time.perf_counter_ns(), time.time_ns()


class Counts:
    """The counters since the process started, summed in place."""

    __slots__ = COUNTERS

    def __init__(self):
        for k in COUNTERS:
            setattr(self, k, 0)

    def values(self) -> tuple:
        return _values(self)


class _Off:
    """The shared no-op span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_OFF = _Off()


class Span:
    """One timed region: ``name``; ``start_ns`` and ``end_ns`` by
    ``time.perf_counter_ns()``; ``id``, in order of opening; ``parent``,
    the id of the span it opened in (-1 at the top); ``step``, the steps
    begun before it opened, its own included (so the bookkeeping after a
    step shares that step's number); for a step, ``counts``: what the
    counters added since the previous step closed."""

    __slots__ = ("tracer", "name", "is_step", "id", "parent", "step",
                 "start_ns", "end_ns", "counts")

    def __init__(self, tracer: "Tracer", name: str, is_step: bool):
        self.tracer, self.name, self.is_step = tracer, name, is_step
        self.counts = None

    def __enter__(self):
        t = self.tracer
        self.id = t._ids
        t._ids += 1
        self.parent = t._open[-1].id if t._open else -1
        if self.is_step:
            t._step += 1
        self.step = t._step
        t._open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        self.end_ns = time.perf_counter_ns()
        t = self.tracer
        t._open.pop()
        if self.is_step:
            now = t.counts.values()
            self.counts = dict(zip(COUNTERS, (a - b for a, b in
                                              zip(now, t._last))))
            t._last = now
        t.ring.append(self)
        t.closed += 1
        return False

    def as_dict(self) -> dict:
        out = {"id": self.id, "name": self.name, "parent": self.parent,
               "step": self.step, "start_ns": self.start_ns,
               "end_ns": self.end_ns}
        if self.counts is not None:
            out["counts"] = self.counts
        return out


class Tracer:
    """The process's spans and counters (see the module docstring). One
    thread's: spans nest by the order they open and close."""

    def __init__(self, capacity: int = 1 << 17, report_every=None,
                 sink=None):
        self.on = False
        self.capacity = capacity
        self.counts = Counts()
        # an explicit report_every wins over DIGIHAM_METRICS_EVERY
        self.report_every = report_every
        self.sink = sink or (lambda line: print(line, file=sys.stderr))
        self._reported = (time.monotonic(), self.counts.values())
        self._open: list = []
        self._clear()

    def _clear(self) -> None:
        self.ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.closed = 0       # spans closed since start: ring + dropped
        self.anchor = None
        self._ids = 0
        self._step = 0
        self._last = self.counts.values()

    def start(self) -> None:
        """Record spans from now on, into an empty ring."""
        self._clear()
        self.anchor = _anchor()
        self.on = True

    def stop(self) -> None:
        self.on = False

    def span(self, name: str, step: bool = False):
        """A context manager over one region; ``step`` marks a bank step,
        whose span carries its counts."""
        if not self.on:
            return _OFF
        return Span(self, name, step)

    def spans(self) -> list:
        """The recorded spans, in order of closing (children first)."""
        return list(self.ring)

    def unix_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` time in Unix nanoseconds, as Kineto's
        events are, through the anchor ``start`` read."""
        perf0, unix0 = self.anchor
        return unix0 + perf_ns - perf0

    def write(self, path: str) -> None:
        """The record as JSON lines: a header (both anchors, the
        counters, the spans kept and dropped), then a line a span."""
        header = {"anchor": self.anchor, "anchor_end": _anchor(),
                  "counts": dict(zip(COUNTERS, self.counts.values())),
                  "spans": len(self.ring),
                  "dropped": self.closed - len(self.ring)}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for s in self.ring:
                f.write(json.dumps(s.as_dict()) + "\n")

    # ------------------------------------------------------------------
    def stepped(self, samples: int) -> None:
        """A device step took in ``samples`` channel-samples: count it, and
        report when a report is due."""
        c = self.counts
        c.steps += 1
        c.samples += samples
        every = self._every()
        if every and time.monotonic() - self._reported[0] >= every:
            self.report()

    def _every(self) -> float:
        # DIGIHAM_METRICS_EVERY is read at each step, so that setting it
        # after import (tests, embedding apps) still takes effect
        if self.report_every is not None:
            return self.report_every
        try:
            return float(os.environ.get("DIGIHAM_METRICS_EVERY") or 0)
        except ValueError:
            return 0.0

    def report(self) -> None:
        """One JSON line to the sink: the counters since the last report."""
        now, values = time.monotonic(), self.counts.values()
        t0, before = self._reported
        self._reported = (now, values)
        d = dict(zip(COUNTERS, (a - b for a, b in zip(values, before))))
        seconds = now - t0

        def ratio(a, b):
            return round(d[a] / d[b], 4) if d[b] else None

        self.sink(json.dumps({
            "report": "bank", "seconds": round(seconds, 6),
            "channel_samples_per_s":
                round(d["samples"] / seconds, 1) if seconds else 0.0,
            "steps": d["steps"], "rounds": d["rounds"],
            "frames": d["frames"], "sacch_sfs": d["sacch_sfs"],
            "graph_captures": d["graph_captures"],
            "graph_replays": d["graph_replays"],
            "uploads": d["uploads"], "upload_waits": d["upload_waits"],
            "dstar_headers": d["dstar_headers"],
            "dstar_header_fails": d["dstar_header_fails"],
            "dstar_slow_headers": d["dstar_slow_headers"],
            "fast_skip_ratio": ratio("fast_skips", "hunting"),
            "decode_fill_ratio": ratio("frames", "rows_sent")}))


TRACER = Tracer()


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Wrap a region in a torch.profiler trace of the host and, where
    there is one, the card; on exit the region's Chrome trace is written
    to ``logdir/trace.json`` (view with chrome://tracing or Perfetto),
    with the program's spans of the region as rows of their own, placed
    through the tracer's anchor. Spans are recorded for the region if the
    tracer was off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    tracer = TRACER
    was_on = tracer.on
    if not was_on:
        tracer.start()
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter_ns()
            yield
    finally:
        if not was_on:
            tracer.stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"] += [
        {"name": s.name, "ph": "X", "cat": "digiham_tpu_torch",
         "pid": "digiham_tpu_torch spans", "tid": "bank",
         "ts": (tracer.unix_ns(s.start_ns) - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"step": s.step, **(s.counts or {})}}
        for s in tracer.ring if s.start_ns >= t0]
    with open(path, "w") as f:
        json.dump(trace, f)
