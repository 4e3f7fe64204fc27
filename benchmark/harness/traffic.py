"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a protocol's TX module (``synth/<protocol>.py``) into every channel's
FM-discriminator audio, from the run's seed.

A base stream is a loop of ``calls_per_loop`` calls and as many gaps
(nothing on the air but the receiver's noise). Every seed gets the same
set of sizes: the calls' lengths spread evenly over ``call_seconds``,
call ``i`` of the set as the TX module's variant ``i`` (YSF: its mode),
and the gaps spread over ``gap_seconds``, stretched so that the loop is
``calls_per_loop`` times the mean call and gap; the seed orders the calls
and the gaps, fills them (voice, addresses, callsigns), and replaces
``dibit_error_rate`` of each call's symbols by symbols drawn at random.
So each seed's traffic is the same amount of work. A symbol is a rect
pulse of ``sps`` samples at its level times ``amplitude``: the TX
module's ``LEVELS`` (the level of each symbol value; 2FSK ``[-1, +1]``,
or POCSAG's inverted ``[+1, -1]``), or where it has none the 4FSK table
:data:`LEVELS`. A TX module gives ``SYMBOL_RATE`` and ``call(rng,
seconds, variant)``, a call's symbols. Channel ``c`` plays base
``c % base_streams`` from a seeded offset, plus its own Gaussian noise of
``noise_sigma``, and replays its loop when a run outlasts it. The base
streams come from numpy with the seed; the noise and the channels' loops
are made on the run's device from the seed in a few large calls, then
kept on the host, where the bank takes its input."""
from __future__ import annotations

import importlib

import numpy as np
import torch

# 4FSK level of each dibit value (digiham's gfsk_demodulator slicer:
# 1 = +3, 0 = +1, 2 = -1, 3 = -3)
LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3


def synth_module(protocol: str):
    return importlib.import_module(f"benchmark.synth.{protocol}")


def loop_samples(mix: dict, rate: int) -> int:
    """A loop's length: ``calls_per_loop`` times the mean call and gap."""
    mean = (sum(mix["call_seconds"]) + sum(mix["gap_seconds"])) / 2
    return int(round(mix["calls_per_loop"] * mean * rate))


def base_stream(rng, tx, mix: dict, sps: int, length: int) -> np.ndarray:
    """One base stream [length] float32: a gap, a call, a gap, ... of the
    mix's set of sizes in the seed's order."""
    levels = np.asarray(getattr(tx, "LEVELS", LEVELS), np.float64)
    n = mix["calls_per_loop"]
    q = (np.arange(n) + 0.5) / n
    lo, hi = mix["call_seconds"]
    calls = []
    for i in range(n):
        dibits = tx.call(rng, lo + (hi - lo) * q[i], i)
        k = int(round(mix["dibit_error_rate"] * len(dibits)))
        hit = rng.choice(len(dibits), k, replace=False)
        dibits[hit] = rng.integers(0, len(levels), k)
        calls.append(np.repeat(levels[dibits], sps) * mix["amplitude"])
    lo, hi = mix["gap_seconds"]
    gaps = lo + (hi - lo) * q
    room = length - sum(len(c) for c in calls)
    if room < 0:
        raise ValueError("the mix's calls do not fit its loop")
    cuts = np.round(np.cumsum(gaps) / gaps.sum() * room).astype(int)
    gap_n = np.diff(np.concatenate([[0], cuts]))
    parts = []
    for g, c in zip(rng.permutation(n), rng.permutation(n)):
        parts += [np.zeros(gap_n[g]), calls[c]]
    return np.concatenate(parts).astype(np.float32)


class Traffic:
    """Every channel's audio: ``loop`` [C, P] float32 on the host; sample
    ``n`` of channel ``c`` is ``loop[c, n % P]``."""

    def __init__(self, loop: np.ndarray):
        self.loop = loop

    @property
    def period(self) -> int:
        return self.loop.shape[1]

    def chunk(self, start: int, n: int) -> np.ndarray:
        """Samples [start, start + n) of every channel: a view of the loop
        unless the chunk wraps."""
        a = start % self.period
        if a + n <= self.period:
            return self.loop[:, a:a + n]
        idx = (a + np.arange(n)) % self.period
        return self.loop[:, idx]

    def rows(self, channels, n: int) -> np.ndarray:
        """Samples [0, n) of the given channels [len(channels), n]."""
        idx = np.arange(n) % self.period
        return self.loop[np.asarray(channels)][:, idx]


def make(cell, seed: int, device) -> Traffic:
    """The cell's traffic for ``seed``, its loops made on ``device``."""
    cfg, mix = cell.config, cell.mix
    tx = synth_module(cell.protocol)
    rng = np.random.default_rng(seed)
    C = cfg["channels"]
    P = loop_samples(mix, cfg["sample_rate"])
    bases = np.stack([base_stream(rng, tx, mix, cfg["sps"], P)
                      for _ in range(mix["base_streams"])])
    offsets = rng.integers(0, P, C)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    base = torch.from_numpy(bases).to(device)
    loop = torch.empty((C, P), dtype=torch.float32, device=device)
    for c in range(C):
        loop[c] = torch.roll(base[c % mix["base_streams"]],
                             -int(offsets[c]))
    loop += mix["noise_sigma"] * torch.randn((C, P), generator=gen,
                                             device=device)
    return Traffic(loop.cpu().numpy())
