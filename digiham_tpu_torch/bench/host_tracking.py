"""Host control-plane capacity: real-time channels a CPU core tracks, per
protocol (the port of tools/bench_host_tracking.py).

    python3 -m digiham_tpu_torch.bench.host_tracking [--channels 64 256 1024]
        [--device cpu]

Three parts, the JAX tool's, with its JSON keys:

- ``dmr_host_tracking_steady_state``: 60 DMR frames (4 voice-LC headers,
  then voice with sync) hunted to frame lock, the aligned frames tiled 20
  times; one ``DmrAdapter.decode_fields`` of all of them, then
  ``field_row`` and ``process_fields`` timed over every row: µs a frame,
  and the channels a core tracks in real time at 33.3 frames a second.
- ``dmr_host_bank_scaling``: ``TrackedChannelBank(DmrPipeline(C, 10, 2))``
  fed 40 voice frames a channel, the same on every channel, through
  ``push_dibits`` in chunks of 400 (the first 1,600 symbols a warm-up), at
  each C of ``--channels``: µs a channel-frame (whether the host loop
  grows faster than the channels do).
- ``{protocol}_host_control_plane`` for DMR, YSF, NXDN, D-Star and POCSAG:
  one channel, six transmissions of each (:mod:`.host_synth`, seed
  12345), ``push_dibits`` in chunks of 800; the first quarter a warm-up
  (its last chunk overlaps the first timed one, as in the JAX tool). The
  adapter's ``decode_fields`` is timed and subtracted: on the card it runs
  the frame decode there (YSF and NXDN through K5) and fetches the fields
  (``_fetch``), so the subtracted time includes the copy back
  (``device_decode_includes_copy_back``). What is left is the host's
  seconds per second of air. The dibit path gets no device sync gating, so
  this includes the full host hunt over the noise gaps.

Where the port differs from the JAX tool: each protocol's bank runs with
that protocol's adapter (the JAX tool leaves the adapter at its default,
DMR's, for all five, so its YSF, NXDN, D-Star and POCSAG rows timed the DMR
hunt over foreign symbols); every channel has a metadata writer; and the
voice bytes and events of every part are counted and held to the JAX
package's, ``data/host_tracking_smoke.npz`` (built by ``PYTHONPATH=.
python tests/test_torch_host_tracking.py`` with the JAX package on the
CPU). A row prints ``"correct": true`` only when they are equal; the first
that differs ends the program with the failure line. The dibit path
never reaches the sample buffer or the RRC history (``push_dibits`` goes
straight to the trackers). Every line carries the card's name and power
limit; with no card (and no ``--device cpu``) the program prints the
failure line and exits 1.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from .. import smoke
from ..pipeline import DMR
from . import common, host_synth

METRIC = "host_control_plane"
FIXTURE = Path(__file__).resolve().parent.parent / "data" / \
    "host_tracking_smoke.npz"
SCALING_CHANNELS = (64, 256, 1024)
STEADY_FRAMES, STEADY_TILES, STEADY_HEADERS = 60, 20, 4
SCALING_FRAMES, SCALING_CHUNK, SCALING_WARM = 40, 400, 4
CHUNK = 800
CENTURIES = {"dmr": 2, "ysf": 5, "nxdn": 2, "dstar": 2, "pocsag": 2}
FRAME = DMR.frame_size
FRAMES_PER_S = 48000 / (FRAME * DMR.sps)  # 33.3 DMR frames a second
PAYLOAD = np.tile([1, 3, 0, 2], 27)
LC = (2300042, 2623317)  # group_lc(target, source)


class Outputs:
    """Each channel's voice bytes (``on_output``) and events (a
    ``PipelineMetaWriter`` a channel)."""

    def __init__(self, channels: int):
        self.voice = [bytearray() for _ in range(channels)]
        self.events = [[] for _ in range(channels)]

    def on_output(self, c: int, data: bytes) -> None:
        self.voice[c] += data

    def attach(self, bank) -> None:
        from ..runtime.meta import PipelineMetaWriter

        for c, sink in enumerate(self.events):
            bank.set_meta_writer(c, PipelineMetaWriter(sink.append))

    def channel(self, c: int) -> tuple[bytes, bytes]:
        return bytes(self.voice[c]), b"".join(self.events[c])


def tracked_bank(protocol: str, channels: int, dev, out: Outputs):
    """The JAX tool's bank of ``protocol`` with that protocol's adapter
    (``MultiStreamBank``'s worker bank): DMR 2 centuries at sps 10, YSF 5
    at 10, NXDN 2 at 20, D-Star and POCSAG 2 at their own sps; ``out``
    takes its voice bytes and events."""
    from ..runtime.multistream import _build_bank

    bank = _build_bank(protocol, channels,
                       {"n_centuries": CENTURIES[protocol]}, 3,
                       out.on_output, dev)
    out.attach(bank)
    return bank


def push_plan(n: int, chunk: int = CHUNK) -> tuple[list, list]:
    """The JAX tool's chunks over a stream of ``n`` symbols: (the warm-up's
    starts, from 0 below n // 4; the timed ones, from n // 4 below
    n - chunk). Each pushes ``[lo, lo + chunk)``."""
    warm_end = n // 4
    return (list(range(0, warm_end, chunk)),
            list(range(warm_end, n - chunk, chunk)))


def steady_stream(frames: int = STEADY_FRAMES) -> np.ndarray:
    """The steady state's DMR stream: voice-LC headers, then voice frames
    with sync, slots alternating."""
    from ..protocols.dmr.components import DATA_TYPE_VOICE_LC
    from .dmr_synth import data_frame, group_lc, voice_frame

    lc = group_lc(*LC)
    return np.concatenate([
        data_frame(s % 2, DATA_TYPE_VOICE_LC, lc) if s < STEADY_HEADERS
        else voice_frame(s % 2, PAYLOAD, sync=True)
        for s in range(frames)]).astype(np.uint8)


def aligned_frames(stream: np.ndarray, tiles: int = STEADY_TILES):
    """(the hunt's next phase at lock, the frames from lock on as [n, 144],
    tiled ``tiles`` times)."""
    from ..protocols.dmr.phases import SyncPhase

    hunt, off, nxt = SyncPhase(), 0, None
    while nxt is None:
        nxt, c = hunt.process(stream[off:], None)
        off += c
    n = (len(stream) - off) // FRAME
    return nxt, np.tile(stream[off:off + n * FRAME].reshape(n, FRAME),
                        (tiles, 1))


def steady_state(dev) -> tuple[dict, tuple[bytes, bytes]]:
    """The isolated steady-state cost a frame. Returns (the row, the
    tracker's (voice bytes, events))."""
    from ..pipeline import DmrPipeline
    from ..runtime.meta import PipelineMetaWriter
    from ..runtime.tracked_bank import DmrAdapter

    nxt, aligned = aligned_frames(steady_stream())
    n = aligned.shape[0]
    ad = DmrAdapter()
    host = ad.decode_fields(aligned, DmrPipeline(1, sps=10, n_centuries=2,
                                                 device=dev))
    rows = [ad.field_row(host, r) for r in range(n)]
    t0 = time.perf_counter()
    for r in range(n):
        ad.field_row(host, r)
    dt_fr = (time.perf_counter() - t0) / n
    events = []
    meta = ad.make_meta()
    meta.set_writer(PipelineMetaWriter(events.append))
    tr = ad.make_tracker(meta, 3, nxt)
    t0 = time.perf_counter()
    outs = [tr.process_fields(f) for f in rows]
    dt_pf = (time.perf_counter() - t0) / n
    per_frame_us = (dt_fr + dt_pf) * 1e6
    row = {"metric": "dmr_host_tracking_steady_state",
           "field_row_us_per_frame": dt_fr * 1e6,
           "process_fields_us_per_frame": dt_pf * 1e6,
           "total_us_per_frame": per_frame_us,
           "realtime_channels_per_core":
               round(1e6 / (per_frame_us * FRAMES_PER_S)),
           "frames_measured": n}
    return row, (b"".join(o[0] for o in outs), b"".join(events))


def scaling_stream(frames: int = SCALING_FRAMES) -> np.ndarray:
    """One channel of the scaling part: voice frames with sync, slots
    alternating."""
    from .dmr_synth import voice_frame

    return np.concatenate([voice_frame(s % 2, PAYLOAD, sync=True)
                           for s in range(frames)]).astype(np.uint8)


def bank_scaling(dev, channels: int) -> tuple[dict, Outputs]:
    """The host cost a channel-frame of a ``channels``-channel DMR bank fed
    through ``push_dibits``. Returns (the row, every channel's outputs)."""
    out = Outputs(channels)
    bank = tracked_bank("dmr", channels, dev, out)
    stream = np.tile(scaling_stream(), (channels, 1))
    chunk = SCALING_CHUNK
    bank.push_dibits(stream[:, :chunk * SCALING_WARM])
    before = smoke.launch_counts()
    t0 = time.perf_counter()
    n_sym = 0
    for lo in range(chunk * SCALING_WARM, stream.shape[1] - chunk, chunk):
        bank.push_dibits(stream[:, lo:lo + chunk])
        n_sym += chunk
    dt = time.perf_counter() - t0
    us_pcf = dt / (channels * (n_sym // FRAME)) * 1e6
    return {"metric": "dmr_host_bank_scaling", "channels": channels,
            "us_per_channel_frame": us_pcf,
            "realtime_channels_per_core":
                round(1e6 / (us_pcf * FRAMES_PER_S)),
            "launches": common.launches_since(before, 1)}, out


def control_plane(name: str, stream: np.ndarray, rate: int,
                  dev) -> tuple[dict, tuple[bytes, bytes]]:
    """One channel of ``name`` through its tracked bank, the decode
    subtracted. Returns (the row, the channel's (voice bytes, events))."""
    out = Outputs(1)
    bank = tracked_bank(name, 1, dev, out)
    spent = [0.0]
    decode = bank.adapter.decode_fields

    def timed(frames, pipe):
        t0 = time.perf_counter()
        fields = decode(frames, pipe)
        spent[0] += time.perf_counter() - t0
        return fields

    bank.adapter.decode_fields = timed
    warm, measured = push_plan(len(stream))
    for lo in warm:
        bank.push_dibits(stream[None, lo:lo + CHUNK])
    spent[0] = 0.0
    before = smoke.launch_counts()
    t0 = time.perf_counter()
    for lo in measured:
        bank.push_dibits(stream[None, lo:lo + CHUNK])
    wall = time.perf_counter() - t0
    host = wall - spent[0]
    n_sym = (len(stream) - CHUNK - len(stream) // 4) // CHUNK * CHUNK
    air = n_sym / rate
    return {"metric": f"{name}_host_control_plane",
            "includes_acquisition_no_device_gating": True,
            "host_seconds_per_air_second": host / air,
            "realtime_channels_per_core": round(air / host),
            "device_decode_seconds_subtracted": spent[0],
            "device_decode_includes_copy_back": dev.type == "cuda",
            "symbols": int(n_sym),
            "launches": common.launches_since(before, 1)}, out.channel(0)


def load_fixture() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def expected(fx: dict, part: str) -> tuple[bytes, bytes]:
    """A part's (voice bytes, events) in the fixture: ``steady``,
    ``scaling`` (one channel's) or a protocol."""
    return fx[f"{part}_voice"].tobytes(), fx[f"{part}_events"].tobytes()


def hold(part: str, got: tuple[bytes, bytes], want: tuple[bytes, bytes],
         where: str = "") -> dict:
    """The counts of ``got``; raises :class:`common.GateFailed` unless it
    equals ``want``."""
    if got != want:
        raise common.GateFailed(
            f"{part}{where}: {len(got[0])} voice bytes and {len(got[1])} "
            f"bytes of events, the JAX package's {len(want[0])} and "
            f"{len(want[1])}; equal: voice {got[0] == want[0]}, events "
            f"{got[1] == want[1]}")
    return {"voice_bytes": len(got[0]), "event_bytes": len(got[1]),
            "events": got[1].count(b"\n") if got[1] else 0}


def run(dev, channels=SCALING_CHANNELS, emit=print) -> list:
    """The three parts on ``dev``, every row held to the fixture; each row
    goes to ``emit`` as it is done. Returns the rows."""
    fx = load_fixture()
    rows = []

    def done(row, counts):
        row.update(counts, correct=True, backend=common.backend(dev))
        rows.append(row)
        emit(row)

    row, got = steady_state(dev)
    done(row, hold("steady", got, expected(fx, "steady")))
    want = expected(fx, "scaling")
    for C in channels:
        row, out = bank_scaling(dev, C)
        counts = None
        for c in range(C):
            counts = hold("scaling", out.channel(c), want,
                          f" channel {c} of {C}")
        done(row, counts)
    for name, stream, rate in host_synth.protocol_streams():
        row, got = control_plane(name, stream, rate, dev)
        done(row, hold(name, got, expected(fx, name)))
    return rows


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m digiham_tpu_torch.bench.host_tracking",
        description=__doc__.split("\n")[0])
    p.add_argument("--channels", type=int, nargs="+",
                   default=list(SCALING_CHANNELS),
                   help="the bank sizes of the scaling part")
    common.add_arguments(p, reps=False)
    return p.parse_args(argv)


def body(argv=None) -> int:
    args = parse(argv)
    dev = common.open_device(args.device)
    prov = common.provenance(dev)
    run(dev, args.channels,
        lambda row: print(json.dumps({**row, **prov}), flush=True))
    return 0


def main(argv=None) -> int:
    return common.run_main(METRIC, body, argv)


if __name__ == "__main__":
    raise SystemExit(main())
