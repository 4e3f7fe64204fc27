"""Random streams through the time-sharded bank against the unsharded
bank (the port of tools/fuzz_timesharded.py).

Each case draws a protocol (all five unless ``proto`` pins one) and a
random stream of it (:mod:`.synth`: voice bursts, noise gaps, sparse
symbol corruption, optional clock skew up to 120 ppm), then pushes it in
random chunks through a ``TimeShardedTrackedBank`` over a
``TimeShardedPipeline`` on a (2, 2) (channel, time) mesh that names the
device four times, and through a ``TrackedChannelBank`` over the
protocol's single-device pipeline; a quarter of the cases snapshot and
restore the sharded bank mid-stream (which must change nothing). Both
flush; every channel's bytes and metadata events must be identical. This
runs K2, K3, K4 and K5 on random streams; the JAX tool's seeds give the
JAX tool's streams.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device, smoke
from ..parallel import make_mesh
from ..parallel.streaming import TimeShardedPipeline
from ..pipeline import PROTOCOLS
from ..runtime.meta import PipelineMetaWriter
from ..runtime.tracked_bank import (ADAPTERS, TimeShardedTrackedBank,
                                    TrackedChannelBank)
from . import synth

# protocol -> (symbol synth, levels, centuries a step of the unsharded
# bank's pipeline); the rest is the protocol's record and adapter
PROTOS = {
    "dmr": (synth.dmr_dibits, synth.FOUR_LEVELS, 4),
    "ysf": (synth.ysf_dibits, synth.FOUR_LEVELS, 5),
    "nxdn": (synth.nxdn_dibits, synth.FOUR_LEVELS, 3),
    "dstar": (synth.dstar_bits, synth.DSTAR_LEVELS, 2),
    "pocsag": (synth.pocsag_bits, synth.POCSAG_LEVELS, 2),
}


def make_samples(rng, proto: str, channels: int,
                 symbols: np.ndarray | None = None) -> np.ndarray:
    """One case's audio [channels, n] float32: the protocol's random
    symbols (``symbols`` when given, else drawn from ``rng``), sparse
    corruption (40% of the cases), the levels times 1,000 at its sps,
    Gaussian noise of a random sigma in [20, 70) on each channel, and
    clock skew up to 120 ppm (half the cases)."""
    make, lev, _ = PROTOS[proto]
    sps = PROTOCOLS[proto].sps
    dibits = make(rng) if symbols is None else symbols
    if rng.random() < 0.4:  # sparse symbol corruption
        nsym = int(lev.shape[0])
        idx = rng.random(dibits.size) < 0.005
        dibits = dibits.copy()
        dibits[idx] = rng.integers(0, nsym, int(idx.sum()))
    base = np.repeat(lev[dibits], sps) * 1000
    noise = rng.uniform(20, 70)
    samples = np.stack([base + rng.normal(0, noise, base.shape)
                        for _ in range(channels)]).astype(np.float32)
    if rng.random() < 0.5:  # clock skew up to 120 ppm
        skew = rng.uniform(-1.2e-4, 1.2e-4)
        n = samples.shape[1]
        t = np.arange(int(n / (1 + abs(skew)))) * (1 + skew)
        t = np.clip(t, 0, n - 1)
        samples = np.stack([np.interp(t, np.arange(n), samples[c])
                            for c in range(channels)]).astype(np.float32)
    return samples


class Collected:
    """One bank's outputs: bytes and metadata events per channel."""

    def __init__(self, bank, channels: int):
        self.bytes = [b""] * channels
        self.events = [[] for _ in range(channels)]
        bank.on_output = self._on_output
        for c in range(channels):
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, e=self.events[c]: e.append(b.decode())))

    def _on_output(self, c, data):
        self.bytes[c] += bytes(data)

    def same(self, other) -> bool:
        return self.bytes == other.bytes and self.events == other.events


def make_banks(mesh, proto: str, channels: int, dev, drift_budget=None):
    """(time-sharded bank, unsharded bank) for ``proto``; ``drift_budget``
    None keeps the time-sharded pipeline's own."""
    kw = {} if drift_budget is None else {"drift_budget": drift_budget}
    sp = TimeShardedPipeline(mesh, channels=channels, protocol=proto, **kw)
    bank_s = TimeShardedTrackedBank(sp, adapter=ADAPTERS[proto](),
                                    device=dev)
    bank_p = TrackedChannelBank(
        PROTOCOLS[proto].pipeline(channels, n_centuries=PROTOS[proto][2],
                                  device=dev),
        adapter=ADAPTERS[proto](), device=dev)
    return bank_s, bank_p


def run_case(mesh, seed: int, names, channels: int, dev,
             drift_budget=None) -> dict:
    rng = np.random.default_rng(seed)
    proto = names[int(rng.integers(0, len(names)))]
    samples = make_samples(rng, proto, channels)
    bank_s, bank_p = make_banks(mesh, proto, channels, dev, drift_budget)
    out_s, out_p = Collected(bank_s, channels), Collected(bank_p, channels)
    chunk = int(rng.integers(2048, 16384))
    snap_at = (int(rng.integers(1, samples.shape[1]))
               if rng.random() < 0.25 else None)
    restored = snap_at is not None
    fed = 0
    t0 = time.perf_counter()
    try:
        for lo in range(0, samples.shape[1], chunk):
            blk = samples[:, lo:lo + chunk]
            bank_s.push(blk)
            bank_p.push(blk)
            fed += blk.shape[1]
            if snap_at is not None and fed >= snap_at:
                bank_s.restore(bank_s.snapshot())  # must be a no-op
                snap_at = None
        bank_s.flush()
        bank_p.flush()
    except RuntimeError as e:  # name the case, then fail
        raise RuntimeError(f"fuzz_timesharded case seed {seed} ({proto}, "
                           f"{samples.shape[1]} samples, {channels} "
                           f"channels, chunk {chunk}): {e}") from e
    return {"seed": seed, "proto": proto, "chunk": chunk,
            "wall_s": time.perf_counter() - t0,
            "samples": samples.shape[1], "restored": restored,
            "bytes": sum(map(len, out_p.bytes)),
            "events": sum(map(len, out_p.events)),
            "same": out_s.same(out_p)}


def run(cases: int = 100, seed0: int = 0, channels: int = 2, device=None,
        proto: str | None = None, drift_budget: int | None = None,
        log=print) -> dict:
    """``cases`` cases from seed ``seed0`` on. ``device=None`` is the card
    (the mesh names it four times). ``drift_budget``: the time-sharded
    pipeline's halo headroom (None: its default, 24 samples, as the JAX
    tool runs); the pipeline raises when a channel's timing leaves it."""
    dev = resolve_device(device)
    slot = torch.device("cuda", 0) if dev.type == "cuda" else dev
    mesh = make_mesh(2, 2, devices=[slot] * 4)
    names = [proto] if proto else list(PROTOS)
    smoke.reset_launch_counts()
    done = []
    t0 = time.perf_counter()
    for i in range(cases):
        r = run_case(mesh, seed0 + i, names, channels, dev, drift_budget)
        done.append(r)
        if not r["same"]:
            log(f"  DIVERGENCE proto={r['proto']} seed={r['seed']} "
                f"chunk={r['chunk']}")
    wall = time.perf_counter() - t0
    bad = [r for r in done if not r["same"]]
    return {"program": "fuzz_timesharded", "ok": not bad, "cases": cases,
            "seed0": seed0, "channels": channels,
            "drift_budget": drift_budget,
            "case_wall_s": [r["wall_s"] for r in done],
            "protocols": {p: sum(r["proto"] == p for r in done)
                          for p in PROTOS},
            "divergences": [{k: r[k] for k in ("seed", "proto", "chunk")}
                            for r in bad],
            "bytes": sum(r["bytes"] for r in done),
            "events": sum(r["events"] for r in done),
            "restored": sum(r["restored"] for r in done),
            "launches": {k: v for k, v in smoke.launch_counts().items()
                         if v},
            "wall_s": wall}
