"""The timed window over the program: ``digiham_tpu_torch``'s
``TrackedChannelBank`` on the configuration's pipeline and adapter, with
``on_output`` and a metadata writer on every channel, pushed the cell's
traffic.

A closed loop (``push: closed``) pushes the next chunk as soon as
``push`` returns; an open loop (``push: open``) pushes chunk ``k`` of
``chunk_samples`` when it is due, ``(k + 1) * chunk_samples /
sample_rate`` after the window opened, whatever the bank does, and notes
how late each push started. Before the window, set-up pushes
``warm_up_blocks`` blocks of the same stream; after it, ``drain_blocks``
more, untimed, so that every frame whose samples the window pushed comes
out before the comparison.

:class:`Probe` wraps, on the instances the harness built, the pipeline's
``step_symbols`` (every run: it counts the steps, which a window's
throughput is made of) and, in a traced run, times it and the adapter's
``decode_fields`` by the host clock, the step closed by a synchronize (the
bank synchronizes there anyway: it fetches the step's outputs next).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import resource
import time

import numpy as np
import torch


class Outputs:
    """What the bank handed over: per channel, each voice frame and each
    metadata event with the host clock's time it came."""

    def __init__(self, channels: int):
        self.frames = [[] for _ in range(channels)]
        self.events = [[] for _ in range(channels)]

    def on_output(self, channel: int, voice: bytes) -> None:
        self.frames[channel].append((time.perf_counter(), bytes(voice)))

    def sink(self, channel: int):
        events = self.events[channel]
        return lambda e: events.append((time.perf_counter(), bytes(e)))


def build_bank(cell, device, outputs: Outputs):
    """The program's bank of the cell's configuration on ``device``."""
    from digiham_tpu_torch import pipeline as pipelines
    from digiham_tpu_torch.runtime import tracked_bank
    from digiham_tpu_torch.runtime.meta import PipelineMetaWriter

    cfg = cell.config
    pipe = getattr(pipelines, cfg["pipeline"])(
        cfg["channels"], sps=cfg["sps"], n_centuries=cfg["n_centuries"],
        device=device)
    bank = tracked_bank.TrackedChannelBank(
        pipe, on_output=outputs.on_output, slot_filter=cfg["slot_filter"],
        adapter=getattr(tracked_bank, cfg["adapter"])(), device=device)
    for c in range(cfg["channels"]):
        bank.set_meta_writer(c, PipelineMetaWriter(outputs.sink(c)))
    return bank


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """Counts the bank's steps; with ``spans``, times its steps and frame
    decodes and counts each decode's frames (its rows not left zero: a
    frame starts with a sync or a CACH, never 144 or 480 zero dibits).
    ``label`` names the calls for the profiler while a session is open."""

    def __init__(self, bank, device, spans: bool):
        self.steps = 0
        self.spans = spans
        self.label = False
        self.step_s: list = []      # (step index, seconds)
        self.decode_s: list = []    # (step index, seconds, frames)
        pipe, adapter = bank.pipeline, bank.adapter
        step, decode = pipe.step_symbols, adapter.decode_fields

        def timed(name, fn, *args):
            if self.label:
                with torch.profiler.record_function(name):
                    return fn(*args)
            return fn(*args)

        def step_symbols(samples, state):
            self.steps += 1
            if not spans:
                return step(samples, state)
            t = time.perf_counter()
            out = timed("bench.step_symbols", step, samples, state)
            synchronize(device)
            self.step_s.append((self.steps, time.perf_counter() - t))
            return out

        def decode_fields(frames, pipeline):
            if not spans:
                return decode(frames, pipeline)
            t = time.perf_counter()
            out = timed("bench.decode_fields", decode, frames, pipeline)
            self.decode_s.append((self.steps, time.perf_counter() - t,
                                  int(frames.any(axis=1).sum())))
            return out

        pipe.step_symbols = step_symbols
        adapter.decode_fields = decode_fields


class Symbols:
    """The symbols each bank step hands the bank's host side (K2's
    output), of the checked channels: wraps the bank instance's
    ``_consume_dibits``, which every step calls with the step's [C, S]
    symbols, and keeps a copy of the checked rows."""

    def __init__(self, bank, channels):
        self.rows = [[] for _ in channels]
        idx = np.asarray(channels)
        consume = bank._consume_dibits

        def consume_and_keep(dibits, block_hits=None):
            for kept, row in zip(self.rows, np.asarray(dibits)[idx]):
                kept.append(row)
            return consume(dibits, block_hits)

        bank._consume_dibits = consume_and_keep

    def channel(self, i: int) -> np.ndarray:
        """The ``i``-th checked channel's symbols, in stream order."""
        return (np.concatenate(self.rows[i]) if self.rows[i]
                else np.zeros(0, np.uint8))


@dataclasses.dataclass
class Window:
    """One timed window: host-clock times, the probe's step count before
    it, the samples pushed before and through it, the steps it made, each
    push's (start, end, steps of the window after it), for an open loop
    the schedule and its lateness, and the pushes inside profiler
    slices."""

    t_start: float
    t_end: float
    steps_before: int
    n_start: int
    n_end: int
    steps: int
    pushes: list
    schedule_t0: float | None = None
    lateness_s: list = dataclasses.field(default_factory=list)
    profiled: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


def chunk_samples(cell) -> int:
    return cell.mix["chunk_samples"] or cell.block_samples


def warm_up(bank, traffic, cell) -> int:
    """Set-up's pushes: ``warm_up_blocks`` blocks of the stream. Returns
    the samples pushed."""
    n = cell.mix["warm_up_blocks"] * cell.block_samples
    bank.push(traffic.chunk(0, n))
    return n


def drain(bank, traffic, cell, n_pushed: int) -> int:
    """After the window: ``drain_blocks`` blocks more, untimed. Returns
    the samples pushed in all."""
    for _ in range(cell.mix["drain_blocks"]):
        bank.push(traffic.chunk(n_pushed, cell.block_samples))
        n_pushed += cell.block_samples
    return n_pushed


def run(cell, bank, traffic, probe: Probe, seconds: float, n_pushed: int,
        slicer=None) -> Window:
    """The timed window from sample ``n_pushed`` on. ``slicer`` (a traced
    run's :class:`devtrace.Slicer`) opens and closes its profiler sessions
    between pushes; the window's end (and an open loop's schedule) moves
    on by the time a session's opening or closing took, so that the
    profiler's pauses neither shorten the window nor make a backlog."""
    chunk = chunk_samples(cell)
    rate = cell.config["sample_rate"]
    open_loop = cell.mix["push"] == "open"
    pushes, lateness = [], []
    steps0 = probe.steps
    n_start = n_pushed
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t0 = t_start  # the open loop's schedule: chunk k due at t0 + (k+1) dt
    k = 0
    while True:
        if open_loop:
            due = t0 + (k + 1) * chunk / rate
            if due > deadline:
                break
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            start = time.perf_counter()
            lateness.append(start - due)
        else:
            start = time.perf_counter()
            if start >= deadline and k:
                break
        if probe.label:
            with torch.profiler.record_function("bench.push"):
                bank.push(traffic.chunk(n_pushed, chunk))
        else:
            bank.push(traffic.chunk(n_pushed, chunk))
        end = time.perf_counter()
        n_pushed += chunk
        k += 1
        pushes.append((start, end, probe.steps - steps0))
        if slicer is not None:
            paused = slicer.between(end - t_start, len(pushes))
            t0 += paused
            deadline += paused
    t_end = pushes[-1][1]
    if slicer is not None:
        slicer.close(len(pushes))
    return Window(t_start=t_start, t_end=t_end, steps_before=steps0,
                  n_start=n_start, n_end=n_pushed,
                  steps=probe.steps - steps0, pushes=pushes,
                  schedule_t0=t_start if open_loop else None,
                  lateness_s=lateness,
                  profiled=[] if slicer is None else slicer.pushes())


def throughput_msps(cell, window: Window) -> float:
    """Channel-samples the window's steps demodulated and decoded, over
    the window's wall time, in MS/s: each step takes ``n_centuries`` x 100
    symbols of ``sps`` samples from every channel, and its frames are
    decoded and handed over before its ``push`` returns."""
    cfg = cell.config
    per_step = cfg["channels"] * cfg["n_centuries"] * 100 * cfg["sps"]
    return window.steps * per_step / window.seconds / 1e6


def lateness_summary(window: Window) -> dict:
    """How late the open loop's pushes started (the generator ran
    behind while the bank held the thread)."""
    late = np.asarray(window.lateness_s) * 1e3
    if not late.size:
        return {}
    return {"pushes": int(late.size), "late_ms_p50": float(np.median(late)),
            "late_ms_p95": float(np.percentile(late, 95)),
            "late_ms_max": float(late.max())}


class HostMeter:
    """What the host gave the process over the window, to tell a slower
    host from a slower program: CPU seconds of the process and of its
    main thread, involuntary context switches, seconds in Python's garbage
    collector, the machine's steal time (``/proc/stat``), and after the
    window the best of three timings of a fixed pure-Python loop."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self.start = self._now()
        self.threads = self._threads()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t

    @staticmethod
    def _steal_s() -> float:
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()
            return int(fields[8]) / 100.0  # USER_HZ
        except (OSError, IndexError, ValueError):
            return float("nan")

    @staticmethod
    def _threads() -> dict:
        """CPU seconds of each of the process's threads, by (id, name)."""
        out = {}
        try:
            for tid in os.listdir("/proc/self/task"):
                with open(f"/proc/self/task/{tid}/stat") as f:
                    stat = f.read()
                name = stat[stat.index("(") + 1:stat.rindex(")")]
                fields = stat[stat.rindex(")") + 2:].split()
                out[(tid, name)] = (int(fields[11]) + int(fields[12])) / 100.0
        except (OSError, ValueError, IndexError):
            pass
        return out

    def _now(self) -> dict:
        return {"cpu_s": time.process_time(),
                "thread_cpu_s": time.thread_time(),
                "nivcsw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw,
                "steal_s": self._steal_s()}

    @staticmethod
    def probe_ms() -> float:
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            x = 0
            for i in range(1_000_000):
                x += i & 7
            best = min(best, time.perf_counter() - t)
        return best * 1e3

    def stop(self) -> dict:
        end = self._now()
        gc.callbacks.remove(self._on_gc)
        out = {k: end[k] - self.start[k] for k in end}
        out["gc_s"] = self.gc_s
        threads = self._threads()
        busy = sorted(((cpu - self.threads.get(key, 0.0), key[1])
                       for key, cpu in threads.items()), reverse=True)
        out["threads"] = len(threads)
        out["busiest_threads"] = [[name, cpu] for cpu, name in busy[:4]]
        out["probe_ms"] = self.probe_ms()
        return {"host": out}
