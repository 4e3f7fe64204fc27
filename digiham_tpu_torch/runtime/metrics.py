"""Rate instrumentation and profiling hooks.

The reference has no profiling at all (SURVEY.md §5); its only
observability is the metadata fifo. A production many-channel deployment
needs first-class rate counters — the headline metric is Msamples/s/chip —
plus torch.profiler integration for kernel-level traces (port of
``digiham_tpu/runtime/metrics.py``).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time



class StageMeter:
    """Throughput/latency counter for one pipeline stage."""

    __slots__ = ("name", "unit", "items", "seconds", "calls", "_t0")

    def __init__(self, name: str, unit: str = "samples"):
        self.name = name
        self.unit = unit
        self.items = 0
        self.seconds = 0.0
        self.calls = 0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> None:
        self.seconds += time.perf_counter() - self._t0
        self.items += items
        self.calls += 1

    @contextlib.contextmanager
    def measure(self, items: int):
        self.start()
        try:
            yield
        finally:
            self.stop(items)

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def snapshot(self) -> dict:
        return {
            "stage": self.name,
            "unit": self.unit,
            "items": self.items,
            "seconds": round(self.seconds, 6),
            "calls": self.calls,
            "rate_per_s": round(self.rate, 1),
        }


class MetricsRegistry:
    """Process-wide stage meters + periodic reporting."""

    def __init__(self, report_every: float | None = None, sink=None):
        self.meters: dict[str, StageMeter] = {}
        self.report_every = report_every
        self.sink = sink or (lambda line: print(line, file=sys.stderr))
        self._last_report = time.monotonic()

    def meter(self, name: str, unit: str = "samples") -> StageMeter:
        if name not in self.meters:
            self.meters[name] = StageMeter(name, unit)
        return self.meters[name]

    def _effective_every(self) -> float:
        # Production wiring: DIGIHAM_METRICS_EVERY=<seconds> turns on
        # periodic rate_per_s reports (one JSON line per stage on stderr)
        # from every StreamDriver / TrackedChannelBank in the process —
        # the SURVEY §5 first-class rate instrumentation, observable
        # without code changes. Read lazily so setting the env var after
        # import (tests, embedding apps) still takes effect; an explicit
        # report_every on the registry wins over the env var.
        if self.report_every is not None:
            return self.report_every
        env = os.environ.get("DIGIHAM_METRICS_EVERY")
        if env:
            try:
                return float(env)
            except ValueError:
                pass
        return 0.0

    def maybe_report(self) -> None:
        if not self._effective_every():
            return
        now = time.monotonic()
        if now - self._last_report >= self._effective_every():
            self._last_report = now
            self.report()

    def report(self) -> None:
        for m in self.meters.values():
            self.sink(json.dumps(m.snapshot()))

    def snapshot(self) -> list[dict]:
        return [m.snapshot() for m in self.meters.values()]


REGISTRY = MetricsRegistry()


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Wrap a region in a torch.profiler trace of the host and, where
    there is one, the card; on exit the region's Chrome trace is written
    to ``logdir/trace.json`` (view with chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
