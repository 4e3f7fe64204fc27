"""The host control-plane program (``digiham_tpu_torch/bench/
host_tracking.py``, the port of tools/bench_host_tracking.py) and its
traffic (``bench/host_synth.py``) on the CPU:

- the generators equal tools/fuzz_tracked.py's ``synth_dibit``,
  ``synth_dstar`` and ``synth_pocsag`` and the three tracked-bank tests'
  ``make_streams`` on 5 seeds, bit for bit;
- each protocol's stream, shortened, through the JAX package's
  ``TrackedChannelBank.push_dibits`` (XLA on the CPU) and the port's
  (``device="cpu"``) in the program's chunks gives equal bytes and events;
- the steady state's field rows and tracker outputs equal the JAX
  adapter's;
- the scaling bank at 2 and 4 channels equals JAX's on every channel;
- ``main(["--device", "cpu", "--channels", "2", "4"])`` prints the JAX
  tool's keys with ``"correct": true``; without a card it exits 1;
- the dibit path never reaches ``rrc_rebase_history``;
- the committed fixture ``data/host_tracking_smoke.npz`` equals a fresh
  build; ``PYTHONPATH=. python tests/test_torch_host_tracking.py``
  rebuilds it.
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))

import jax.numpy as jnp  # noqa: E402

import dmr_synth as j_dmr  # noqa: E402
import fuzz_tracked as ft  # noqa: E402
import test_tracked_bank as j_dmr_bank  # noqa: E402
import test_tracked_bank_nxdn as j_nxdn_bank  # noqa: E402
import test_tracked_bank_ysf as j_ysf_bank  # noqa: E402
from digiham_tpu.pipeline import (DmrPipeline as JDmr,  # noqa: E402
                                  FskPipeline as JFsk,
                                  NxdnPipeline as JNxdn,
                                  YsfPipeline as JYsf)
from digiham_tpu.protocols.dmr.components import \
    DATA_TYPE_VOICE_LC  # noqa: E402
from digiham_tpu.protocols.dmr.phases import SyncPhase as JSyncPhase  # noqa
from digiham_tpu.runtime import tracked_bank as jtb  # noqa: E402
from digiham_tpu.runtime.meta import \
    PipelineMetaWriter as JWriter  # noqa: E402
from digiham_tpu_torch.bench import host_synth, host_tracking  # noqa: E402
from digiham_tpu_torch.bench.host_tracking import (CHUNK, FRAME,  # noqa
                                                   Outputs, push_plan)

torch.set_num_threads(1)

PROTOCOLS = ("dmr", "ysf", "nxdn", "dstar", "pocsag")
# tools/bench_host_tracking.py :79-92, :142-149, :185-191
STEADY_KEYS = {"metric", "field_row_us_per_frame",
               "process_fields_us_per_frame", "total_us_per_frame",
               "realtime_channels_per_core", "frames_measured"}
SCALING_KEYS = {"metric", "channels", "us_per_channel_frame",
                "realtime_channels_per_core"}
PROTOCOL_KEYS = {"metric", "includes_acquisition_no_device_gating",
                 "host_seconds_per_air_second", "realtime_channels_per_core",
                 "device_decode_seconds_subtracted", "symbols"}


# -- the JAX side, as the JAX repo builds it ---------------------------------

def jax_pipeline(protocol, channels):
    """bench_host_tracking.py's pipelines (:54-61)."""
    if protocol == "dmr":
        return JDmr(channels=channels, sps=10, n_centuries=2)
    if protocol == "ysf":
        return JYsf(channels=channels, sps=10, n_centuries=5)
    if protocol == "nxdn":
        return JNxdn(channels=channels, sps=20, n_centuries=2)
    return JFsk(channels=channels, protocol=protocol, n_centuries=2)


JAX_ADAPTERS = {"dmr": jtb.DmrAdapter, "ysf": jtb.YsfAdapter,
                "nxdn": jtb.NxdnAdapter, "dstar": jtb.DstarAdapter,
                "pocsag": jtb.PocsagAdapter}


def jax_streams(seed=host_synth.SEED,
                transmissions=host_synth.TRANSMISSIONS):
    """bench_host_tracking.py's ``_streams`` (:28-45) from the JAX repo's
    own generators."""
    rng = np.random.default_rng(seed)
    out = []
    for name in ("dmr", "ysf", "nxdn"):
        out.append((name, np.concatenate(
            [ft.synth_dibit(name, rng) for _ in range(transmissions)])))
    out.append(("dstar", np.concatenate(
        [ft.synth_dstar(rng) for _ in range(transmissions)])))
    out.append(("pocsag", np.concatenate(
        [ft.synth_pocsag(rng) for _ in range(transmissions)])))
    return out


def jax_bank(pipe, adapter, streams, slices):
    """Each channel's (voice bytes, events) of ``streams`` [C, n] through
    the JAX package's bank, pushed a slice ``(lo, hi)`` at a time; a
    metadata writer a channel."""
    C = streams.shape[0]
    out = Outputs(C)
    bank = jtb.TrackedChannelBank(pipe, on_output=out.on_output,
                                  adapter=adapter)
    for c, sink in enumerate(out.events):
        bank.set_meta_writer(c, JWriter(sink.append))
    for lo, hi in slices:
        bank.push_dibits(streams[:, lo:hi])
    return [out.channel(c) for c in range(C)]


def protocol_slices(n):
    warm, measured = push_plan(n)
    return [(lo, lo + CHUNK) for lo in warm + measured]


def jax_protocol(name, stream):
    return jax_bank(jax_pipeline(name, 1), JAX_ADAPTERS[name](),
                    stream[None], protocol_slices(len(stream)))[0]


def port_protocol(name, stream):
    out = Outputs(1)
    bank = host_tracking.tracked_bank(name, 1, torch.device("cpu"), out)
    for lo, hi in protocol_slices(len(stream)):
        bank.push_dibits(stream[None, lo:hi])
    return out.channel(0)


def jax_scaling(channels):
    """The scaling part's bank (bench_host_tracking.py :170-183): the warm
    push of 1,600 symbols, then chunks of 400."""
    payload = host_tracking.PAYLOAD
    one = np.concatenate([j_dmr.voice_frame(s % 2, payload, sync=True)
                          for s in range(host_tracking.SCALING_FRAMES)])
    stream = np.tile(one, (channels, 1)).astype(np.uint8)
    chunk = host_tracking.SCALING_CHUNK
    warm = chunk * host_tracking.SCALING_WARM
    slices = [(0, warm)] + [(lo, lo + chunk) for lo in
                            range(warm, stream.shape[1] - chunk, chunk)]
    return jax_bank(jax_pipeline("dmr", channels), jtb.DmrAdapter(), stream,
                    slices)


def jax_steady():
    """The steady state (bench_host_tracking.py :101-140): (the aligned
    frames, the JAX adapter's field rows, the tracker's outputs, its
    events)."""
    lc = j_dmr.group_lc(*host_tracking.LC)
    payload = host_tracking.PAYLOAD
    stream = np.concatenate([
        j_dmr.data_frame(s % 2, DATA_TYPE_VOICE_LC, lc)
        if s < host_tracking.STEADY_HEADERS
        else j_dmr.voice_frame(s % 2, payload, sync=True)
        for s in range(host_tracking.STEADY_FRAMES)]).astype(np.uint8)
    hunt, off, nxt = JSyncPhase(), 0, None
    while nxt is None:
        nxt, c = hunt.process(stream[off:], None)
        off += c
    n = (len(stream) - off) // FRAME
    aligned = np.tile(stream[off:off + n * FRAME].reshape(n, FRAME),
                      (host_tracking.STEADY_TILES, 1))
    ad = jtb.DmrAdapter()
    host = ad.decode_fields(aligned, jnp)
    rows = [ad.field_row(host, r) for r in range(aligned.shape[0])]
    events = []
    meta = ad.make_meta()
    meta.set_writer(JWriter(events.append))
    tr = ad.make_tracker(meta, 3, nxt)
    outs = [tr.process_fields(f) for f in rows]
    return aligned, rows, outs, b"".join(events)


def build_fixture() -> dict:
    """Every part's voice bytes and events from the JAX package on the
    CPU, at the program's default sizes."""
    fx = {}

    def put(part, voice, events):
        fx[f"{part}_voice"] = np.frombuffer(voice, np.uint8).copy()
        fx[f"{part}_events"] = np.frombuffer(events, np.uint8).copy()

    _, _, outs, events = jax_steady()
    put("steady", b"".join(o[0] for o in outs), events)
    put("scaling", *jax_scaling(2)[0])
    for name, stream in jax_streams():
        put(name, *jax_protocol(name, stream))
    return fx


# -- the tests ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_generators_equal_the_jax_repos(seed):
    for name in ("dmr", "ysf", "nxdn"):
        got = host_synth.synth_dibit(name, np.random.default_rng(seed))
        want = ft.synth_dibit(name, np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for got_fn, want_fn in ((host_synth.synth_dstar, ft.synth_dstar),
                            (host_synth.synth_pocsag, ft.synth_pocsag)):
        got = got_fn(np.random.default_rng(seed))
        want = want_fn(np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got_fn, want_fn in ((host_synth.dmr_streams, j_dmr_bank.make_streams),
                            (host_synth.ysf_streams, j_ysf_bank.make_streams),
                            (host_synth.nxdn_streams,
                             j_nxdn_bank.make_streams)):
        got, want = got_fn(seed), want_fn(seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_protocol_streams_equal_the_jax_tools():
    got = host_synth.protocol_streams()
    want = jax_streams()
    assert [n for n, _, _ in got] == [n for n, _ in want] == list(PROTOCOLS)
    for (_, g, rate), (name, w) in zip(got, want):
        assert np.array_equal(g, w), name
        assert rate == {"nxdn": 2400, "pocsag": 1200}.get(name, 4800)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_protocol_bank_equals_jax(protocol):
    """Two transmissions of another seed (one that gives each protocol
    some output): the port's bank and JAX's give the same voice bytes and
    events."""
    stream = dict((n, s) for n, s, _ in
                  host_synth.protocol_streams(seed=9, transmissions=2))[
        protocol]
    got = port_protocol(protocol, stream)
    want = jax_protocol(protocol, stream)
    assert got == want
    assert got[0] or got[1]


def test_steady_state_rows_and_tracker_equal_jax():
    from digiham_tpu_torch.pipeline import DmrPipeline
    from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
    from digiham_tpu_torch.runtime.tracked_bank import DmrAdapter

    aligned, j_rows, j_outs, j_events = jax_steady()
    nxt, mine = host_tracking.aligned_frames(host_tracking.steady_stream())
    assert np.array_equal(mine, aligned)
    ad = DmrAdapter()
    host = ad.decode_fields(mine, DmrPipeline(1, 10, 2, device="cpu"))
    rows = [ad.field_row(host, r) for r in range(mine.shape[0])]
    assert len(rows) == len(j_rows) == mine.shape[0]
    for r, (got, want) in enumerate(zip(rows, j_rows)):
        assert ([getattr(got, k) for k in got.__slots__]
                == [getattr(want, k) for k in want.__slots__]), r
    events = []
    meta = ad.make_meta()
    meta.set_writer(PipelineMetaWriter(events.append))
    tr = ad.make_tracker(meta, 3, nxt)
    outs = [tr.process_fields(f) for f in rows]
    assert outs == j_outs
    assert b"".join(events) == j_events
    assert sum(len(o[0]) for o in outs) > 0


@pytest.mark.parametrize("channels", [2, 4])
def test_scaling_bank_equals_jax(channels):
    row, out = host_tracking.bank_scaling(torch.device("cpu"), channels)
    want = jax_scaling(channels)
    got = [out.channel(c) for c in range(channels)]
    assert got == want
    assert len(set(got)) == 1 and got[0][0]
    assert row["channels"] == channels and row["us_per_channel_frame"] > 0


def test_main_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = host_tracking.main(["--device", "cpu", "--channels", "2", "4"])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert rc == 0, lines
    assert [ln["metric"] for ln in lines] == [
        "dmr_host_tracking_steady_state", "dmr_host_bank_scaling",
        "dmr_host_bank_scaling"] + [f"{p}_host_control_plane"
                                    for p in PROTOCOLS]
    for ln in lines:
        assert ln["correct"] is True and ln["backend"] == "cpu", ln
        assert ln["card"] is None
    assert STEADY_KEYS <= set(lines[0])
    assert [ln["channels"] for ln in lines[1:3]] == [2, 4]
    for ln in lines[1:3]:
        assert SCALING_KEYS <= set(ln) and ln["us_per_channel_frame"] > 0
    for ln in lines[3:]:
        assert PROTOCOL_KEYS <= set(ln), ln
        assert ln["host_seconds_per_air_second"] > 0
        assert ln["voice_bytes"] + ln["event_bytes"] > 0
        assert ln["device_decode_includes_copy_back"] is False


def test_no_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = host_tracking.main(["--channels", "2"])
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 1 and line["value"] is None and "error" in line


def test_dibit_path_never_rebases_the_rrc_history(monkeypatch):
    """``push_dibits`` goes straight to the trackers: the sample buffer's
    RRC rebase (the JAX package's one-channel aliasing fault) is never
    reached, in either package."""
    from digiham_tpu.runtime import stream as jstream
    from digiham_tpu_torch.runtime import tracked_bank as ptb

    def refuse(*a, **kw):
        raise AssertionError("rrc_rebase_history reached")

    monkeypatch.setattr(ptb, "rrc_rebase_history", refuse)
    monkeypatch.setattr(jstream, "rrc_rebase_history", refuse)
    stream = host_synth.dmr_streams(3, 1)[0]
    assert port_protocol("dmr", stream) == jax_protocol("dmr", stream)


def test_fixture_rebuilds_exactly():
    fresh = build_fixture()
    committed = host_tracking.load_fixture()
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    for name in ("steady", "scaling", *PROTOCOLS):
        assert len(fresh[f"{name}_voice"]) + len(fresh[f"{name}_events"]), name


if __name__ == "__main__":
    fx = build_fixture()
    np.savez_compressed(host_tracking.FIXTURE, **fx)
    print(f"wrote {host_tracking.FIXTURE}: " + ", ".join(
        f"{k} {len(v)}" for k, v in fx.items()))
