"""Ingest to voice-frame-out latency per frame (the port of
tools/bench_latency.py).

    python3 -m digiham_tpu_torch.bench.bench_latency [--channels 2]
        [--driver streamdriver|tracked|multistream|timesharded ...]
        [--block N ...] [--nc N ...] [--device cpu]

For every DMR voice frame a streaming driver hands to ``on_output``, the
algorithmic latency is the samples ingested when the frame's 27 bytes
surfaced minus the stream index of the frame's last sample: how much more
signal had to arrive after the frame ended. It is printed in ms of air at
48 kS/s (sps 10 x 4,800 symbols/s) beside the wall cost of each push.
Frames identify themselves: each synthesized burst carries a unique random
108-dibit payload, and emitted bytes are matched to it (at most 16 of 216
bits flipped: a burst's first frame may carry a few symbol errors while
timing settles).

Rows, as the JAX tool's ``main``: ``streamdriver`` (the one-century demod
alone, latency to the symbols) at blocks 1,024 / 4,800 / 16,384;
``tracked`` (``TrackedChannelBank``, the whole stack) at 2, 4 and 16
centuries x those blocks, over ``--channels`` channels (2 by default, as
the JAX tool; 256 is the bank users run); ``multistream``
(``MultiStreamBank``, 16 centuries, 8 processes, 8 channels, block
16,384); ``timesharded`` (``TimeShardedTrackedBank`` on a (2, 2) mesh of
the card named four times, 36 centuries a shard, blocks 16,384 and
65,536). ``--driver``, ``--block`` and ``--nc`` pick a subset. Before the
rows, the DMR bank fixture (``data/dmr_bank_smoke.npz``) runs through a
``TrackedChannelBank`` and every channel's voice bytes and events must
equal the JAX bank's. One JSON line per row.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

from ..pipeline import DMR
from . import common

METRIC = "dmr_voice_frame_latency"
LEVELS = np.array([1.0, 3.0, -1.0, -3.0], np.float32) / 3.0
SPS = DMR.sps
RATE = 4800 * SPS  # samples/s per channel
SAMPLES_PER_MS = RATE / 1000.0
DRIVERS = ("streamdriver", "tracked", "multistream", "timesharded")
BLOCKS = {"streamdriver": (1024, 4800, 16384), "tracked": (1024, 4800, 16384),
          "multistream": (16384,), "timesharded": (16384, 65536)}
TRACKED_NC = (2, 4, 16)
MULTISTREAM = {"channels": 8, "n_procs": 8, "nc": 16}
TIMESHARDED_CPS = 36
MESH = (2, 2)
MAX_FLIPPED_BITS = 16
WARMUP_SAMPLES = 80_000


def synth_stream(seed, n_bursts=5, frames_per_burst=8, tail=2000):
    """One channel of dibits: dotting gaps and voice bursts with unique
    payloads. Returns (dibits, {voice bytes: index of the frame's last
    dibit}) for the slot-0 frames only: the tracker forwards voice of one
    active slot at a time, so slot-1 bursts never reach on_output."""
    from ..protocols.dmr.phases import pack_dibits
    from .dmr_synth import voice_frame

    rng = np.random.default_rng(seed)
    parts, ends = [], {}
    pos = 0
    for _ in range(n_bursts):
        # a dotting gap of a whole even number of frames: the tracker keeps
        # the TDMA grid and the slot parity through short gaps; short and
        # long gaps exercise both the locked and the re-hunt paths
        gap_frames = 2 * int(rng.integers(2, 7))
        gap = np.tile(np.array([0, 2], np.uint8), 72 * gap_frames)
        parts.append(gap)
        pos += len(gap)
        for s in range(frames_per_burst):
            payload = rng.integers(0, 4, 108).astype(np.uint8)
            fr = voice_frame(s % 2, payload, sync=True)
            parts.append(fr)
            pos += len(fr)
            if s % 2 == 0:  # slot 0 = the active voice slot
                ends[pack_dibits(payload)] = pos - 1
    # a tail long enough that the most buffered row still decodes the last
    # burst without a flush
    parts.append(np.tile(np.array([0, 2], np.uint8), tail // 2))
    return np.concatenate(parts), ends


def modulate(dibits):
    return np.repeat(LEVELS[dibits], SPS) * 1000.0


def percentiles(xs) -> dict:
    if not xs:
        return {"p50": None, "p99": None, "max": None, "n": 0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max()),
            "n": len(xs)}


def drive(make_bank, samples, ends_per_chan, block):
    """Push ``block``-sample chunks; returns (latency in samples of each
    matched frame, wall seconds of each push, frames never matched)."""
    emitted = []
    pushed = [0]

    def on_output(c, voice):
        v = bytes(voice)
        ends = ends_per_chan[c]
        end = ends.pop(v, None)
        if end is None:
            for k in list(ends):
                if sum((a ^ b).bit_count() for a, b in zip(v, k)) \
                        <= MAX_FLIPPED_BITS:
                    end = ends.pop(k)
                    break
        if end is not None:
            emitted.append(pushed[0] - ((end + 1) * SPS))

    bank = make_bank(on_output)
    n = samples.shape[1]
    walls = []
    try:
        for lo in range(0, n, block):
            chunk = samples[:, lo:lo + block]
            pushed[0] = lo + chunk.shape[1]
            t0 = time.perf_counter()
            bank.push(chunk)
            walls.append(time.perf_counter() - t0)
    finally:
        if hasattr(bank, "close"):  # MultiStreamBank owns processes
            bank.close()
    unmatched = sum(len(e) for e in ends_per_chan)
    return emitted, walls, unmatched


def _streams(first_seed, channels, tail):
    """Every channel's stream padded with dotting to the longest (never
    cut: a cut tail strands a channel's last burst), as FM audio."""
    streams = [synth_stream(first_seed + c, tail=tail)
               for c in range(channels)]
    n = max(len(s[0]) for s in streams)
    dots = np.tile(np.array([0, 2], np.uint8), (n + 1) // 2)
    samples = np.stack([
        modulate(np.concatenate([s[0], dots[:n - len(s[0])]]))
        for s in streams])
    return samples, streams


def _timed(make, samples, streams, block):
    """A warm-up drive over a prefix (first launches stay out of the
    walls), then the measured drive."""
    n = samples.shape[1]
    drive(make, samples[:, :min(n, WARMUP_SAMPLES)],
          [dict(s[1]) for s in streams], block)
    return drive(make, samples, [dict(s[1]) for s in streams], block)


def bench_tracked(channels, n_centuries, block, device, mesh=None,
                  cps=None, tail=2000):
    """The tracked bank (or, with ``mesh`` and ``cps``, the time-sharded
    one) over ``channels`` synthesized streams (seeds 1000 + c)."""
    from ..pipeline import DmrPipeline
    from ..runtime.tracked_bank import (TimeShardedTrackedBank,
                                        TrackedChannelBank)

    samples, streams = _streams(1000, channels, tail)
    if cps is not None:
        from ..parallel.streaming import TimeShardedPipeline

        sp = TimeShardedPipeline(mesh, channels=channels, protocol="dmr",
                                 centuries_per_shard=cps)

        def make(cb):
            return TimeShardedTrackedBank(sp, on_output=cb, device=device)
    else:
        def make(cb):
            return TrackedChannelBank(
                DmrPipeline(channels=channels, sps=SPS,
                            n_centuries=n_centuries, device=device),
                on_output=cb, device=device)
    return _timed(make, samples, streams, block)


def bench_multistream(channels, n_procs, n_centuries, block, device,
                      tail=2000):
    """``MultiStreamBank`` at the serving point: a push's wall is the
    slowest worker's step and the gather."""
    from ..runtime.multistream import MultiStreamBank

    samples, streams = _streams(3000, channels, tail)

    def make(cb):
        return MultiStreamBank(
            "dmr", channels=channels, n_procs=n_procs, on_output=cb,
            pipeline_kwargs={"n_centuries": n_centuries, "sps": SPS},
            device=device)
    return _timed(make, samples, streams, block)


def bench_streamdriver(block, device, n_centuries=1):
    """Demod only: latency from sample ingest to symbol availability."""
    from ..dsp.demod import demod_init, gfsk_demod_block
    from ..runtime.stream import StreamDriver

    dev = common.resolve_device(device)
    dib, _ = synth_stream(7)
    samples = modulate(dib)[None, :]
    drv = StreamDriver(1, SPS, functools.partial(gfsk_demod_block, sps=SPS),
                       demod_init(1, dev), n_centuries=n_centuries,
                       device=dev)
    lat, walls = [], []
    emitted_symbols = 0
    for lo in range(0, samples.shape[1], block):
        chunk = samples[:, lo:lo + block]
        t0 = time.perf_counter()
        blocks = drv.push(chunk)
        walls.append(time.perf_counter() - t0)
        pushed = lo + chunk.shape[1]
        for b in blocks:
            emitted_symbols += np.asarray(b).shape[1]
            # the newest symbol's last sample is about symbol * SPS
            lat.append(pushed - emitted_symbols * SPS)
    return lat, walls


def row(name, block, lat_samples, walls, dev, extra=None, missed=0):
    lat_ms = [max(0.0, x) / SAMPLES_PER_MS for x in lat_samples]
    out = {"metric": METRIC, "driver": name, "block": block,
           "block_ms": block / SAMPLES_PER_MS,
           "algo_latency_ms": percentiles(lat_ms),
           "push_wall_ms": percentiles([w * 1000 for w in walls]),
           "frames_matched": len(lat_samples), "frames_missed": missed,
           "backend": common.backend(dev)}
    if extra:
        out.update(extra)
    return out


def gate_bank(channels: int, dev) -> dict:
    """The DMR bank fixture (its variants tiled over ``channels``)
    through ``TrackedChannelBank(DmrPipeline(channels, 10, 16))`` in the
    fixture's push chunks, then ``flush()``: every channel's voice bytes
    and metadata events must equal the JAX bank's."""
    from .. import smoke
    from ..pipeline import DmrPipeline
    from ..runtime.meta import PipelineMetaWriter
    from ..runtime.tracked_bank import TrackedChannelBank

    stream = smoke.DMR_BANK
    fx = smoke.load(stream)
    variants = fx["tx_dibits"].shape[0]
    variant = np.arange(channels) % variants
    audio = np.ascontiguousarray(smoke.bank_audio(stream, fx)[variant])
    voice = [b""] * channels
    events = [[] for _ in range(channels)]

    def on_output(c, data):
        voice[c] += data

    bank = TrackedChannelBank(
        DmrPipeline(channels=channels, sps=stream.sps,
                    n_centuries=stream.n_centuries, device=dev),
        on_output=on_output, device=dev)
    for c in range(channels):
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events[c]: ev.append(b.decode())))
    start = 0
    for n in fx["chunks"]:
        bank.push(audio[:, start:start + int(n)])
        start += int(n)
    bank.flush()
    for c in range(channels):
        if (voice[c], "".join(events[c])) != smoke.bank_expected(
                fx, variant[c]):
            raise common.GateFailed(
                f"dmr_bank channel {c} (variant {variant[c]}): voice bytes "
                f"or events differ from the JAX bank's")
    return {"fixture": f"digiham_tpu_torch/data/{stream.fixture.name}",
            "path": "TrackedChannelBank.push + flush", "channels": channels,
            "n_centuries": stream.n_centuries, "sps": stream.sps,
            "voice_bytes": sum(len(v) for v in voice)}


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m digiham_tpu_torch.bench.bench_latency",
        description="ingest to voice-frame-out latency per frame")
    p.add_argument("--channels", type=int, default=2,
                   help="channels of the tracked rows")
    p.add_argument("--driver", action="append", choices=DRIVERS,
                   help="a driver's rows (repeatable; default all four)")
    p.add_argument("--block", action="append", type=int,
                   help="push size in samples (repeatable; default each "
                        "driver's own)")
    p.add_argument("--nc", action="append", type=int,
                   help="centuries of the tracked rows (repeatable; "
                        "default 2, 4, 16)")
    common.add_arguments(p, reps=False)
    return p.parse_args(argv)


def body(argv=None) -> int:
    args = parse(argv)
    dev = common.open_device(args.device)
    prov = common.provenance(dev)
    checked = gate_bank(max(args.channels, 8), dev)
    extra = {"correct": True, "gate": checked, **prov}
    drivers = args.driver or DRIVERS
    for name in DRIVERS:
        if name not in drivers:
            continue
        for block in args.block or BLOCKS[name]:
            if name == "streamdriver":
                lat, walls = bench_streamdriver(block, dev)
                print(json.dumps(row("streamdriver[nc=1]", block, lat, walls,
                                     dev, extra)), flush=True)
            elif name == "tracked":
                for nc in args.nc or TRACKED_NC:
                    lat, walls, missed = bench_tracked(args.channels, nc,
                                                       block, dev)
                    print(json.dumps(row(
                        f"tracked[nc={nc}]", block, lat, walls, dev,
                        dict(extra, channels=args.channels), missed)),
                        flush=True)
            elif name == "multistream":
                m = MULTISTREAM
                lat, walls, missed = bench_multistream(
                    m["channels"], m["n_procs"], m["nc"], block, args.device)
                print(json.dumps(row(
                    f"multistream[nc={m['nc']},procs={m['n_procs']}]", block,
                    lat, walls, dev, dict(extra, channels=m["channels"],
                                          n_procs=m["n_procs"]), missed)),
                    flush=True)
            else:
                from ..parallel import make_mesh

                mesh = make_mesh(*MESH, devices=[dev] * (MESH[0] * MESH[1]))
                # 2 time shards x 36 centuries x 1,000 samples buffered: the
                # tail must outlast about 72,000 samples
                lat, walls, missed = bench_tracked(
                    2, None, block, dev, mesh=mesh, cps=TIMESHARDED_CPS,
                    tail=16000)
                print(json.dumps(row(
                    f"timesharded[cps={TIMESHARDED_CPS},mesh=2x2]", block,
                    lat, walls, dev, dict(extra, channels=2), missed)),
                    flush=True)
    return 0


def main(argv=None) -> int:
    return common.run_main(METRIC, body, argv)


if __name__ == "__main__":
    import sys

    # the package's module, not this __main__: MultiStreamBank's workers
    # are spawned
    from digiham_tpu_torch.bench import bench_latency

    sys.exit(bench_latency.main())
