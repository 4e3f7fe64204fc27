"""The device trace of a traced run: torch.profiler sessions over slices
of the window, checked complete, read for the device's busy time (the
union of its operations' intervals), the program's kernels by name, the
operations that took most time and the longest idle gaps with what the
host was doing in them.

A session is the copy of ``digiham_tpu_torch/bench/common.py``'s
``Session``, which the repository found sound on the card: Kineto drops
the device records of a session's first operations as "Out-of-range" the
older the process is, so a session opens ``margin_s`` before its work and
closes ``margin_s`` after it, and counts as complete only when every launch
it saw has its device record: each runtime launch, copy and fill matched
by its correlation id, and the program's own kernels (whose libraries link
the CUDA runtime statically) counted against the program's launch
counters. A slice whose session is not complete is taken again later in
the window while there is room."""
from __future__ import annotations

import time

import torch

MARGIN_S = 0.25
# the program's kernels, as the device trace names them
PORT_KERNELS = ("demod_kernel", "fir_kernel", "viterbi_kernel",
                "iir_split_kernel", "dc_split_kernel")
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
    "cudaMemset"))
LABELS = ("bench.decode_fields", "bench.step_symbols", "bench.push")
NAME_CHARS = 120  # a device operation's name in the breakdown, at most


def port_launches() -> int:
    """The program's kernel launches so far in this process, from its
    launch counters."""
    from digiham_tpu_torch.ops import demod_front, fir, recurrence, viterbi

    return (sum(demod_front.LAUNCHES.values()) + fir.LAUNCHES
            + viterbi.LAUNCHES + sum(recurrence.LAUNCHES.values()))


def _unmatched(prof) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == cuda}
    out: dict = {}
    for e in events:
        if (e.device_type() != cuda and e.name() in LAUNCH_CALLS
                and e.correlation_id() not in recorded):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


class Session:
    """One profiler session (CPU and CUDA activity) around a slice. After
    it: ``device`` (name, start us, end us) of every device operation,
    ``labels`` (name, start us, end us) of the harness's host ranges,
    ``lost`` launches without a device record, ``complete``."""

    def __init__(self, device, margin_s: float = MARGIN_S):
        from torch.profiler import ProfilerActivity, profile

        self.dev = device
        self.margin_s = margin_s
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        torch.cuda.synchronize(self.dev)
        self.before = port_launches()
        self.prof.__enter__()
        time.sleep(self.margin_s)
        torch.cuda.synchronize(self.dev)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            torch.cuda.synchronize(self.dev)
            time.sleep(self.margin_s)
        self.prof.__exit__(*exc)
        self.complete = False
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        events = list(self.prof.events())
        # the harness's ranges show on the device's timeline too, as
        # annotations that cover the work; they are not device operations
        device = sorted(((e.name, e.time_range.start, e.time_range.end)
                         for e in events if e.device_type == cuda
                         and e.name not in LABELS),
                        key=lambda x: x[1])
        self.labels = [(e.name, e.time_range.start, e.time_range.end)
                       for e in events
                       if e.device_type != cuda and e.name in LABELS]
        ours = sum(1 for d in device if any(k in d[0] for k in PORT_KERNELS))
        self.lost_by = _unmatched(self.prof)
        port_lost = port_launches() - self.before - ours
        if port_lost:
            self.lost_by["the program's kernels"] = port_lost
        self.lost = sum(self.lost_by.values())
        self.complete = self.lost == 0
        self.device = device
        return False


class Slicer:
    """The traced run's profiler slices inside the window: one opens at
    ``at`` of the window's length and spans ``length_s``; while its session
    is not complete and there is room, another opens after it. Between
    pushes the window asks :meth:`between` what to do; it returns the
    seconds a session's opening or closing took."""

    def __init__(self, device, probe, window_s: float, at: float = 0.2,
                 length_s: float = 4.0, tries: int = 3):
        self.dev = device
        self.probe = probe
        self.window_s = window_s
        self.length_s = min(length_s, 0.3 * window_s)
        self.next_at = at * window_s
        self.tries = tries
        self.session = None
        self.slices: list = []  # (session, wall s, first push, end push)
        self.paused = 0.0  # seconds its sessions' openings and closings took

    def between(self, elapsed: float, pushes: int) -> float:
        """``elapsed``: the window's seconds so far, pauses included."""
        paused = self._between(elapsed - self.paused, pushes)
        self.paused += paused
        return paused

    def _between(self, elapsed: float, pushes: int) -> float:
        t = time.perf_counter()
        if self.session is None:
            done = any(s.complete for s, *_ in self.slices)
            room = elapsed + self.length_s + 1.0 < self.window_s
            if (not done and len(self.slices) < self.tries and room
                    and elapsed >= self.next_at):
                self.session = Session(self.dev).__enter__()
                self.first = pushes
                self.probe.label = True
                self.opened = time.perf_counter()
                return self.opened - t
            return 0.0
        if time.perf_counter() - self.opened >= self.length_s:
            return self._close(pushes)
        return 0.0

    def close(self, pushes: int) -> None:
        """Close a session still open after the window's last push."""
        self._close(pushes)

    def _close(self, pushes: int) -> float:
        if self.session is None:
            return 0.0
        torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        wall = t - self.opened
        self.probe.label = False
        self.session.__exit__(None, None, None)
        self.slices.append((self.session, wall, self.first, pushes))
        self.session = None
        self.next_at = 0.0
        return time.perf_counter() - t

    def best(self):
        """(session, wall s, first push, end push) of the complete slice,
        else of the one that lost fewest launches; None without a
        slice."""
        if not self.slices:
            return None
        return min(self.slices, key=lambda s: (not s[0].complete, s[0].lost))

    def pushes(self) -> list:
        """Indices of the pushes inside any slice (the profiler slows the
        host there: their spans are left out)."""
        return sorted({i for _, _, a, b in self.slices for i in range(a, b)})


def start_profiler(device) -> None:
    """Start and stop the profiler once on a small operation: its first
    start in a process (CUPTI's) takes seconds, which set-up pays rather
    than the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_seconds(session: Session, name: str) -> tuple[int, float]:
    """(launches, device seconds) of the device operations whose name
    holds ``name``."""
    mine = [(s, e) for n, s, e in session.device if name in n]
    return len(mine), sum(e - s for s, e in mine) / 1e6


def breakdown(session: Session, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps between device operations, each named by the
    innermost harness range that holds its middle (or "between pushes")."""
    by_name: dict = {}
    for n, s, e in session.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS - 3] + "...", v)
           for n, v in ops]
    gaps, last_end = [], None
    for _, s, e in session.device:
        if last_end is not None and s > last_end:
            gaps.append((last_end, s))
        last_end = e if last_end is None else max(last_end, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        holding = [lab for lab in session.labels if lab[1] <= mid <= lab[2]]
        inner = min(holding, key=lambda lab: lab[2] - lab[1])[0] \
            if holding else "between pushes"
        named.append([inner.removeprefix("bench."), (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
