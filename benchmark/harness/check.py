"""The comparison that decides ``correct``: every checked channel's voice
frames and metadata events from the program against the plain reference
(:mod:`benchmark.reference`) on the same samples, and the latencies of the
frames that pass.

The reference demodulates every channel's whole pushed stream (warm-up,
window and drain) on the run's device in plain PyTorch, then decodes the
checked channels' symbols with digiham's phase machines on the host, the
channels spread over worker processes. It gives every frame and event the
stream sample after which a causal receiver could have it (its ``end``).
From every channel's century starts it counts the steps the bank can have
made on the samples pushed: a step runs once the samples reach the
farthest channel's start plus a block and two (``TrackedChannelBank.push``'s
rule).

For each checked channel the symbols of the bank's steps (K2's output)
must equal the reference's, and there must be as many as those steps
hand over: every symbol that differs, and every one short of or beyond
that count, is ``symbols_wrong``. A frame or event is due
when its end lies inside what set-up and the window pushed; the drain
after the window makes the bank hand over every due one. The bank's
frames must equal the reference's, in order, as far as the bank's go (a
frame that differs is ``wrong``; one the bank gives beyond all the
reference's is ``wrong`` too), and none that is due may be absent
(``missing``); the same for events. Each number's limit is 0: the
comparison is exact.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent  # the checkout
# channels demodulated at once on the device
GROUP = 128
# numbers compared and their limits: the comparison is exact
LIMITS = {"symbols_wrong": 0, "frames_wrong": 0, "frames_missing": 0,
          "events_wrong": 0, "events_missing": 0}


@dataclasses.dataclass
class Reference:
    """Per checked channel: its symbols, and ``frames`` and ``events``,
    each a list of (end sample, bytes); the symbols a channel's bank steps
    hand over on the samples pushed (``symbols_due``); the seconds its two
    stages took."""

    channels: list
    dibits: list
    frames: list
    events: list
    symbols_due: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)


def checked_channels(cell, seed: int) -> list:
    """The channels compared: all of them, or ``checked_channels`` of them
    drawn from the seed."""
    C = cell.config["channels"]
    k = min(C, cell.mix["checked_channels"])
    if k == C:
        return list(range(C))
    rng = np.random.default_rng([seed, 1])
    return sorted(int(c) for c in rng.choice(C, k, replace=False))


def workers() -> int:
    """Worker processes for the symbol decode: the cores this process may
    use, less one."""
    return max(1, len(os.sched_getaffinity(0)) - 1)


def _symbol_decode(protocol: str, dibits: list, n_workers: int) -> list:
    """:func:`benchmark.reference.stream.decode_channel` of every
    channel's symbols, the channels split over ``n_workers`` worker
    processes (``python3 -m benchmark.reference.stream``, pickles over
    pipes; each is waited for)."""
    from benchmark.reference import stream

    tasks = [(protocol, d) for d in dibits]
    if n_workers <= 1:
        return stream.decode_many(tasks)
    # channel i goes to worker i % n; every worker starts before any is
    # fed, so that their starts overlap (a worker reads all of its input
    # before it writes)
    n = min(n_workers, len(tasks))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.reference.stream"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in range(n)]
    out = [None] * len(tasks)
    try:
        for k, proc in enumerate(procs):
            pickle.dump(tasks[k::n], proc.stdin,
                        protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.close()
        for k, proc in enumerate(procs):
            part = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"a reference worker exited with "
                                   f"{proc.returncode}")
            out[k::n] = pickle.loads(part)
    finally:
        for proc in procs:  # none outlives the run, whatever happened
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return out


def steps_due(first_needs: list, n_samples: int) -> int:
    """Bank steps that ``n_samples`` pushed samples allow: step ``j`` runs
    once ``n_samples`` reaches ``first_needs[g][j]`` in every group ``g``
    of channels (each the samples step ``j`` needs, an array by step)."""
    n = min(len(f) for f in first_needs)
    need = np.max([f[:n] for f in first_needs], axis=0)
    ok = need <= n_samples
    return int(n if ok.all() else np.argmin(ok))


def reference(cell, traffic, channels: list, n_samples: int, device,
              dtype=torch.float32, n_workers: int = 1) -> Reference:
    """The reference's frames and events of ``channels`` over samples
    [0, n_samples), its arithmetic in ``dtype``; the front runs over
    every channel, for the count of the bank's steps."""
    from benchmark.harness import spec
    from benchmark.reference import dsp

    cfg = cell.config
    nc = cfg["n_centuries"]
    mode, invert = spec.slicer(cell.protocol)
    t0 = time.perf_counter()
    dibits, ends, first_needs = {}, {}, []
    keep = set(channels)
    everyone = list(range(cfg["channels"]))
    for i in range(0, len(everyone), GROUP):
        group = everyone[i:i + GROUP]
        audio = torch.from_numpy(traffic.rows(group, n_samples)).to(device)
        d, e, starts = dsp.demodulate(audio, cfg["sps"], cfg["rrc"], dtype,
                                      mode=mode, invert=invert)
        del audio
        first_needs.append(starts[:, ::nc].max(0, initial=0)
                           + cell.block_samples + 2)
        for c, dc, ec in zip(group, d, e):
            if c in keep:
                dibits[c], ends[c] = dc, ec
    dibits = [dibits[c] for c in channels]
    ends = [ends[c] for c in channels]
    due = steps_due(first_needs, n_samples) * nc * 100
    t1 = time.perf_counter()
    decoded = _symbol_decode(cell.protocol, dibits, n_workers)
    t2 = time.perf_counter()
    frames, events = [], []
    for (fr, ev), end in zip(decoded, ends):
        frames.append([(int(end[max(s, 1) - 1]), b) for s, b in fr])
        events.append([(int(end[max(s, 1) - 1]), b) for s, b in ev])
    return Reference(channels, dibits, frames, events, due,
                     {"front_s": t1 - t0, "symbol_decode_s": t2 - t1})


@dataclasses.dataclass
class Check:
    """The compared numbers, the frames attempted and failed, and each
    passing due frame's (end sample, time handed over)."""

    numbers: dict
    attempted: int
    failed: int
    on_time: list

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= lim for k, lim in LIMITS.items())

    def lines(self) -> dict:
        return {k: {"value": self.numbers[k], "limit": lim}
                for k, lim in LIMITS.items()}


def _side(got: list, want: list, due_by: int):
    """(wrong, missing, due, failed due, indices of due items that
    passed) of one channel's items: ``got`` (time, bytes) from the bank,
    ``want`` (end, bytes) from the reference."""
    n = min(len(got), len(want))
    same = [got[k][1] == want[k][1] for k in range(n)]
    wrong = same.count(False) + max(0, len(got) - len(want))
    due = [k for k, (end, _) in enumerate(want) if end <= due_by]
    missing = sum(1 for k in due if k >= len(got))
    passed = [k for k in due if k < n and same[k]]
    return wrong, missing, len(due), len(due) - len(passed), passed


def compare(outputs, symbols, ref: Reference, due_by: int) -> Check:
    """The program's ``outputs`` (:class:`window.Outputs`) and step
    symbols (:class:`window.Symbols`) against the reference on its
    checked channels; frames and events due when their end is at most
    ``due_by``. The program's symbols of a channel must be the start of
    the reference's (the reference demodulates at least as far), as many
    as the bank's steps hand over."""
    numbers = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    on_time = []
    for i, c in enumerate(ref.channels):
        got, want = symbols.channel(i), ref.dibits[i]
        n = min(len(got), len(want))
        numbers["symbols_wrong"] += (int(np.count_nonzero(got[:n] != want[:n]))
                                     + abs(len(got) - ref.symbols_due))
        w, m, due, bad, passed = _side(outputs.frames[c], ref.frames[i],
                                       due_by)
        numbers["frames_wrong"] += w
        numbers["frames_missing"] += m
        attempted += due
        failed += bad
        on_time += [(ref.frames[i][k][0], outputs.frames[c][k][0])
                    for k in passed]
        w, m, _, _, _ = _side(outputs.events[c], ref.events[i], due_by)
        numbers["events_wrong"] += w
        numbers["events_missing"] += m
    return Check(numbers, attempted, failed, on_time)


def latency_ms(check: Check, window, rate: int) -> np.ndarray:
    """Each frame due inside an open-loop window, from the moment its end
    sample was due on the air (the schedule: sample ``n`` at ``t0 + (n -
    n_start) / rate``) to the moment the bank handed it over, in ms;
    a due frame that failed counts as infinitely late."""
    lat = [(t_out - (window.schedule_t0 + (end - window.n_start) / rate))
           * 1e3 for end, t_out in check.on_time
           if window.n_start < end <= window.n_end]
    return np.asarray(lat, np.float64)


def due_in_window(ref: Reference, window) -> int:
    """The reference's frames due inside the window, on the checked
    channels."""
    return sum(1 for fr in ref.frames for end, _ in fr
               if window.n_start < end <= window.n_end)
