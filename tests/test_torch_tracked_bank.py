"""The port's streaming DMR bank against the JAX package's: FM audio in
uneven chunks -> SampleBuffer -> TrackedChannelBank / ChannelBank ->
flush, voice bytes and metadata event strings equal byte for byte; the
symbol-domain contract with ``make_decoder()``; device-gated hunting;
snapshot/restore; the hand-off of a JAX bank's snapshot through
``convert.from_jax_checkpoint``; ``StreamDriver``; and the committed
fixture ``data/dmr_bank_smoke.npz`` rebuilt from ``dmr_synth`` plus the JAX
bank (so it cannot drift from either).

Sample streams carry noise whose seed is screened knife-edge free
(torch_parity.audio_knife_edge_free): no decision sits within float32
reassociation distance of a threshold, so the two packages must agree
exactly. Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_tracked_bank.py``.
"""
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp.demod import demod_init as j_demod_init
from digiham_tpu.dsp.demod import gfsk_demod_block as j_gfsk_demod_block
from digiham_tpu.pipeline import DmrPipeline as JPipeline
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.stream import StreamDriver as JStreamDriver
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.dsp.demod import demod_init, gfsk_demod_block
from digiham_tpu_torch.pipeline import DmrPipeline, dmr_sync_correlate
from digiham_tpu_torch.protocols.dmr import make_decoder
from digiham_tpu_torch.runtime import checkpoint, metrics
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.stream import (SampleBuffer, StreamDriver,
                                              rrc_rebase_history)
from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

sys.path.insert(0, os.path.dirname(__file__))
from dmr_synth import (data_frame, group_lc, interleave_slots,  # noqa: E402
                       make_lc_bytes, voice_frame, voice_superframe)
import torch_bank  # noqa: E402

torch.set_num_threads(1)

BANK = smoke.DMR_BANK
VARIANTS = 8
N_SAMPLES = 92_000  # 5 steps of 16 centuries and a tail of ~1,200 symbols
N_SYMBOLS = N_SAMPLES // BANK.sps + 2
DOTS = np.tile(np.array([0, 2], np.uint8), 120)  # dotting preamble
IDLE_LC = make_lc_bytes(0)
ALIAS_LC = make_lc_bytes(4, bytes([(1 << 6) | (6 << 1)]) + b"DL1ABC")
GPS_LC = make_lc_bytes(8, bytes([0x01, 0x12, 0x34, 0x56, 0x85, 0x43, 0x21]))
IDLE, FLUSH_VOICE = 4, 5  # variants with a role in the tests


def _rx_design():
    from digiham_tpu.dsp.rrc import WIDE_RRC
    return WIDE_RRC


def _tx_variant(v: int) -> np.ndarray:
    """One variant's TX dibits [N_SYMBOLS]: dotting, then TDMA frames
    alternating slot 0 and slot 1, then dotting to the end."""
    rng = np.random.default_rng(2000 + v)
    lc = group_lc(100 + v, 2000 + v)

    def payload():
        return rng.integers(0, 4, 108)

    def call(slot, lcs, n_super, header_lc=lc):
        frames = [data_frame(slot, 1, header_lc)] * 2
        for i in range(n_super):
            frames += voice_superframe(slot, lcs[i % len(lcs)], payload())
        return frames + [data_frame(slot, 2, header_lc)]

    idle = [data_frame(1, 9, IDLE_LC)] * 40
    lead = DOTS
    if v == 0:    # a group call: headers, superframes with the LC, terminator
        slot0 = call(0, [lc], 3)
    elif v == 1:  # data frames of every data type, both slots
        slot0 = [data_frame(0, t, lc) for t in range(12)] * 2
        idle = [data_frame(1, (t + 5) % 12, lc) for t in range(12)] * 2
    elif v == 2:  # talker alias, GPS and group LC embedded in the voice
        slot0 = call(0, [ALIAS_LC, GPS_LC, lc], 3)
    elif v == 3:  # a unit-to-unit call with 1% dibit errors (added below)
        slot0 = call(0, [group_lc(7 + v, 9 + v, opcode=3)], 3)
    elif v == IDLE:  # no carrier at all (smoke.bank_audio switches it off)
        slot0 = []
    elif v == FLUSH_VOICE:  # voice up to the end of the stream
        slot0 = call(0, [lc], 5)[:-1]
    elif v == 6:  # calls in both slots: the active slot wins
        slot0 = call(0, [lc], 3)
        idle = call(1, [group_lc(555, 666)], 3)
    else:         # a late, short call after a long preamble
        lead = np.tile(DOTS, 12)
        slot0 = call(0, [lc], 1)
    n = min(len(slot0), len(idle))
    parts = [lead]
    if n:
        parts.append(interleave_slots(slot0[:n], idle[:n]))
    tx = np.concatenate(parts).astype(np.uint8)
    if v == 3:
        hit = rng.random(len(tx)) < 0.01
        tx[hit] = rng.integers(0, 4, int(hit.sum()))
    fill = np.tile(DOTS, -(-(N_SYMBOLS - len(tx)) // len(DOTS)) + 1)
    return np.concatenate([tx, fill])[:N_SYMBOLS]


def _screened_seeds(fx_like: dict, first_seed: int) -> np.ndarray:
    return torch_bank.screened_seeds(BANK, _rx_design(), fx_like,
                                     first_seed)


def _jax_bank(C, nc):
    return JBank(JPipeline(channels=C, sps=BANK.sps, n_centuries=nc))


def _port_bank(C, nc):
    return TrackedChannelBank(
        DmrPipeline(channels=C, sps=BANK.sps, n_centuries=nc, device="cpu"),
        device="cpu")


def build_fixture(noise_seeds=None) -> dict:
    """TX dibits, idle flags, push chunks, noise seeds and the JAX bank's
    voice bytes and event strings (see torch_bank.build_fixture). Without
    seeds, draws per-variant seeds until the stream is knife-edge free."""
    return torch_bank.build_fixture(
        BANK, _rx_design(),
        np.stack([_tx_variant(v) for v in range(VARIANTS)]),
        np.arange(VARIANTS) == IDLE, torch_bank.chunks(N_SAMPLES, 42),
        lambda C: _jax_bank(C, BANK.n_centuries), noise_seeds)


@pytest.fixture(scope="module")
def committed():
    return smoke.load(BANK)


@pytest.fixture(scope="module")
def fixture_audio(committed):
    return smoke.bank_audio(BANK, committed)


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from dmr_synth and the
    JAX bank with its stored seeds."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k


def test_fixture_streams_are_knife_edge_free(committed):
    assert np.array_equal(_screened_seeds(committed, 9000),
                          committed["noise_seeds"])


def test_fixture_is_a_stream_worth_checking(committed):
    """Voice bytes in every call variant (whole 27-byte frames), none on
    the data-only and idle channels; the LC, talker alias and GPS events
    are there."""
    voice, events = zip(*(smoke.bank_expected(committed, v)
                          for v in range(VARIANTS)))
    for v in (0, 2, 3, 5, 6, 7):
        assert len(voice[v]) >= 6 * 27 and len(voice[v]) % 27 == 0, v
    assert voice[1] == b"" and voice[IDLE] == b"" and events[IDLE] == ""
    assert "source:2000" in events[0] and "target:100" in events[0]
    assert "talkeralias:DL1ABC" in events[2]
    assert "lat:" in events[2] and "lon:" in events[2]
    assert "type:direct" in events[3] or "source:12" in events[3]
    assert "sync:data" in events[1]


def test_port_bank_decodes_the_fixture(committed, fixture_audio):
    """The port's bank at the fixture's size (16 centuries) gives the JAX
    bank's bytes and events on every variant, and the flush-voice variant
    emits bytes in ``flush`` itself."""
    bank = _port_bank(VARIANTS, BANK.n_centuries)
    outs, _ = torch_bank.run(bank, PipelineMetaWriter, fixture_audio,
                   committed["chunks"], flush=False)
    before = len(outs[FLUSH_VOICE])
    assert bank.samples.fill > 0
    bank.flush()
    assert len(outs[FLUSH_VOICE]) > before
    for v in range(VARIANTS):
        assert outs[v] == smoke.bank_expected(committed, v)[0], v
    full, ev = torch_bank.run(_port_bank(VARIANTS, BANK.n_centuries),
                    PipelineMetaWriter, fixture_audio, committed["chunks"])
    for v in range(VARIANTS):
        assert (full[v], ev[v]) == smoke.bank_expected(committed, v), v


# --- small banks against the JAX bank -------------------------------------

def _small_streams(seed: int, channels: int = 4):
    """FM audio [C, n] of random DMR traffic (calls, data, 1% dibit
    errors on some channels, one channel of unstructured dibits), noise
    seeds screened knife-edge free."""
    rng = np.random.default_rng(seed)
    streams = []
    for c in range(channels):
        lc = group_lc(int(rng.integers(1, 1 << 24)),
                      int(rng.integers(1, 1 << 24)))
        payload = rng.integers(0, 4, 108)
        parts = [DOTS[:int(rng.integers(60, 200))]]
        for _ in range(3):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts += [voice_frame(s % 2, payload, sync=True)
                          for s in range(int(rng.integers(3, 9)))]
            elif kind == 1:
                parts += [data_frame(s % 2, int(rng.integers(0, 11)), lc)
                          for s in range(4)]
            else:
                parts += voice_superframe(int(rng.integers(0, 2)), lc,
                                          payload)
        dibits = np.concatenate([p.astype(np.uint8) for p in parts])
        if c == channels - 1:
            dibits = rng.integers(0, 4, len(dibits)).astype(np.uint8)
        elif rng.random() < 0.5:
            hit = rng.random(len(dibits)) < 0.01
            dibits[hit] = rng.integers(0, 4, int(hit.sum()))
        streams.append(dibits)
    n_sym = min(len(s) for s in streams)
    tx = np.stack([s[:n_sym] for s in streams])
    n = (n_sym - 2) * BANK.sps
    fx = {"tx_dibits": tx, "idle": np.zeros(channels, bool),
          "chunks": torch_bank.chunks(n, seed, lo=100, hi=9000)}
    fx["noise_seeds"] = _screened_seeds(fx, 100 * seed)
    return smoke.bank_audio(BANK, fx), fx["chunks"], tx


@pytest.mark.parametrize("seed", range(4))
def test_tracked_bank_matches_jax(seed):
    """Uneven push chunks and a final flush: bytes and event strings equal
    the JAX bank's on every channel."""
    samples, chunks, _ = _small_streams(seed)
    C = samples.shape[0]
    j_out, j_ev = torch_bank.run(_jax_bank(C, 2), JWriter, samples, chunks)
    p_out, p_ev = torch_bank.run(_port_bank(C, 2), PipelineMetaWriter,
                                 samples, chunks)
    assert any(j_out) and any(j_ev)
    for c in range(C):
        assert p_out[c] == j_out[c], f"ch{c} payload diverges"
        assert p_ev[c] == j_ev[c], f"ch{c} metadata diverges"


@pytest.mark.parametrize("seed", range(2))
def test_channel_bank_equals_tracked_bank(seed):
    """The plain ChannelBank with make_decoder() per channel gives the
    tracked bank's bytes and events, flush included."""
    samples, chunks, _ = _small_streams(seed + 10)
    C = samples.shape[0]
    t_out, t_ev = torch_bank.run(_port_bank(C, 2), PipelineMetaWriter,
                                 samples, chunks)
    pipe = DmrPipeline(channels=C, sps=BANK.sps, n_centuries=2, device="cpu")
    bank = ChannelBank(pipe, [make_decoder() for _ in range(C)],
                       device="cpu")
    c_out, c_ev = torch_bank.run(bank, PipelineMetaWriter, samples, chunks)
    assert c_out == t_out and c_ev == t_ev
    with pytest.raises(RuntimeError, match="flushed"):
        bank.push(samples[:, :10])


def _reference_path(dibit_streams):
    return torch_bank.reference_path(make_decoder, PipelineMetaWriter,
                                     dibit_streams)


def _push_dibits(streams, chunk, gated):
    return torch_bank.push_dibits(
        _port_bank(streams.shape[0], 2), PipelineMetaWriter, streams, chunk,
        dmr_sync_correlate if gated else None)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_push_dibits_equals_decoder(seed, gated):
    """The symbol-domain contract: the tracked bank's fields path, with
    and without device-gated hunting, is byte- and event-identical to the
    per-channel symbol-domain Decoder on the same dibits."""
    _, _, tx = _small_streams(seed + 20)
    outs, metas = _push_dibits(tx, 800, gated)
    ref_out, ref_meta = _reference_path(tx)
    for c in range(tx.shape[0]):
        assert outs[c] == ref_out[c], f"ch{c} payload diverges"
        assert metas[c] == ref_meta[c], f"ch{c} metadata diverges"


@pytest.mark.parametrize("gated", [False, True])
def test_push_dibits_noise_equals_decoder(gated):
    rng = np.random.default_rng(99)
    streams = rng.integers(0, 4, (2, 12000)).astype(np.uint8)
    outs, metas = _push_dibits(streams, 977, gated)
    assert (outs, metas) == _reference_path(streams)


@pytest.mark.parametrize("kind", ["tracked", "plain"])
def test_snapshot_restore_midstream(kind):
    """A snapshot taken between pushes, restored into a fresh bank, gives
    the same remainder as the bank that went on; the blob holds numpy
    only, so it would load on another device."""
    samples, chunks, _ = _small_streams(31)
    C = samples.shape[0]

    def make():
        if kind == "tracked":
            return _port_bank(C, 2)
        pipe = DmrPipeline(channels=C, sps=BANK.sps, n_centuries=2,
                           device="cpu")
        return ChannelBank(pipe, [make_decoder() for _ in range(C)],
                           device="cpu")

    cut = len(chunks) // 2
    first = make()
    head_out, head_ev = torch_bank.run(first, PipelineMetaWriter,
                             samples, chunks[:cut], flush=False)
    blob = first.snapshot()
    payload = pickle.loads(blob)
    state = pickle.loads(payload["pipeline_state"])
    assert state["kind"] == "PipelineState"
    rest = samples[:, int(chunks[:cut].sum()):]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[cut:])
    second = make()
    second.restore(blob)
    if kind == "tracked":
        assert second.samples.consumed == 1
    got = torch_bank.run(second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want
    assert any(want[0])
    wider = _port_bank(C + 1, 2) if kind == "tracked" else ChannelBank(
        DmrPipeline(channels=C + 1, sps=BANK.sps, n_centuries=2,
                    device="cpu"), [None] * (C + 1), device="cpu")
    with pytest.raises(ValueError, match="channels"):
        wider.restore(blob)


def test_convert_handoff_from_jax_snapshot():
    """A JAX bank runs the first half; the pipeline state of its snapshot
    crosses through convert.from_jax_checkpoint and its pending samples
    into a port bank with fresh host machines, which then gives what a
    JAX bank handed the same state and samples gives."""
    samples, chunks, _ = _small_streams(41)
    C = samples.shape[0]
    cut = len(chunks) // 2
    j_first = _jax_bank(C, 2)
    torch_bank.run(j_first, JWriter, samples, chunks[:cut], flush=False)
    payload = pickle.loads(j_first.snapshot())
    rest = samples[:, int(chunks[:cut].sum()):]

    j_second = _jax_bank(C, 2)
    j_second.state = j_load_state(payload["pipeline_state"])
    p_second = _port_bank(C, 2)
    p_second.state = convert.from_jax_checkpoint(payload["pipeline_state"],
                                                 device="cpu")
    for bank in (j_second, p_second):
        bank.samples.push(payload["samples"])
        bank.samples.consumed = 1
    assert p_second.state.demod.pos.dtype == torch.int32
    assert np.array_equal(p_second.state.rrc.history.numpy(),
                          np.asarray(j_second.state.rrc.history))
    want = torch_bank.run(j_second, JWriter, rest, chunks[cut:])
    got = torch_bank.run(p_second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want
    assert any(want[0])
    buf = io.BytesIO()
    np.savez(buf, np.zeros(3))
    with pytest.raises(ValueError, match="leaves"):
        convert.from_jax_checkpoint(pickle.dumps({"npz": buf.getvalue()}),
                                    device="cpu")


def test_stream_driver_matches_jax():
    """StreamDriver over gfsk_demod_block: the same symbol blocks as the
    JAX StreamDriver from the same uneven pushes, and the same final carry."""
    samples, chunks, _ = _small_streams(51)
    C = samples.shape[0]
    # a StreamDriver takes filtered samples: the plain RRC of the whole stream
    from digiham_tpu_torch.dsp.rrc import RrcState, rrc_filter_block
    filt = rrc_filter_block(torch.from_numpy(samples),
                            RrcState.init(C, device="cpu"))[0].numpy()

    def j_fn(block, state, nc):
        return j_gfsk_demod_block(jnp.asarray(block), state, nc, BANK.sps,
                                  impl="xla")

    def p_fn(block, state, nc):
        return gfsk_demod_block(block, state, nc, BANK.sps)

    jd = JStreamDriver(C, BANK.sps, j_fn, j_demod_init(C), n_centuries=2)
    pd = StreamDriver(C, BANK.sps, p_fn, demod_init(C, "cpu"),
                      n_centuries=2, device="cpu")
    lo, n_blocks = 0, 0
    for n in chunks:
        j_blocks = jd.push(filt[:, lo:lo + n])
        p_blocks = pd.push(filt[:, lo:lo + n])
        lo += n
        assert len(j_blocks) == len(p_blocks)
        for jb, pb in zip(j_blocks, p_blocks):
            assert pb.dtype == np.uint8 and np.array_equal(jb, pb)
        n_blocks += len(p_blocks)
    assert n_blocks >= 3
    assert np.array_equal(pd.state.pos.numpy(), np.asarray(jd.state.pos))
    assert pd.state.pos.dtype == torch.int32
    assert pd.buffer.fill == jd.buffer.fill


def test_rebase_history_and_the_stream_start_guard():
    """rrc_rebase_history rebuilds exactly ntaps-1 raw samples before the
    new origin, zero-pads only at stream start, and raises mid-stream."""
    pipe = DmrPipeline(channels=2, sps=10, n_centuries=2, device="cpu")
    state = pipe.init_state()
    block = np.arange(2 * 300, dtype=np.float32).reshape(2, 300)
    rrc = rrc_rebase_history(pipe, state, block, 200)
    assert np.array_equal(rrc.history.numpy(), block[:, 120:200])
    block[:] = 0  # the history is a copy, not a view of the buffer
    assert rrc.history.numpy()[0, 0] == 120
    block = np.arange(2 * 300, dtype=np.float32).reshape(2, 300)
    young = rrc_rebase_history(pipe, state, block, 30, stream_start=True)
    assert np.array_equal(young.history.numpy()[:, :50], np.zeros((2, 50)))
    assert np.array_equal(young.history.numpy()[:, 50:], block[:, :30])
    with pytest.raises(ValueError, match="mid-stream rebase"):
        rrc_rebase_history(pipe, state, block, 30, stream_start=False)
    unfiltered = DmrPipeline(channels=2, sps=10, n_centuries=2,
                             use_rrc=False, device="cpu")
    assert rrc_rebase_history(unfiltered, state, block, 200) is None


def test_sample_buffer():
    buf = SampleBuffer(2, initial_cap=8)
    buf.push(np.arange(6, dtype=np.float32))  # 1-D broadcasts to channels
    buf.push(np.arange(12, dtype=np.float32).reshape(2, 6))  # grows
    assert buf.fill == 12 and buf.data.shape[1] >= 12
    assert np.array_equal(buf.view(4), [[0, 1, 2, 3]] * 2)
    padded = buf.view(40)  # beyond capacity: a zero-padded copy
    assert padded.shape == (2, 40) and not padded[:, 12:].any()
    buf.consume(5)
    assert buf.fill == 7 and buf.consumed == 5
    assert np.array_equal(buf.data[0, :7], [5, 0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("entry", ["tracked_bank", "channel_bank",
                                   "stream_driver", "load_state",
                                   "from_jax_checkpoint"])
def test_no_card_raises(entry):
    """``device=None`` is the card in every new entry point: without one
    they raise, and never give way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pipe = DmrPipeline(channels=2, sps=10, n_centuries=2, device="cpu")
    blob = checkpoint.save_state(pipe.init_state())
    calls = {
        "tracked_bank": lambda: TrackedChannelBank(pipe),
        "channel_bank": lambda: ChannelBank(pipe, [None, None]),
        "stream_driver": lambda: StreamDriver(
            2, 10, gfsk_demod_block, demod_init(2, "cpu")),
        "load_state": lambda: checkpoint.load_state(blob),
        "from_jax_checkpoint": lambda: convert.from_jax_checkpoint(
            pickle.dumps({"npz": b""})),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_checkpoint_round_trip_and_decoder():
    pipe = DmrPipeline(channels=3, sps=10, n_centuries=2, device="cpu")
    state = pipe.init_state()
    state.demod.pos += 7
    state.rrc.history += 1.5
    back = checkpoint.load_state(checkpoint.save_state(state), device="cpu")
    assert type(back) is type(state)
    for a, b in ((back.rrc.history, state.rrc.history),
                 (back.demod.pos, state.demod.pos),
                 (back.demod.offset, state.demod.offset),
                 (back.demod.volume_ring, state.demod.volume_ring)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    demod = checkpoint.load_state(checkpoint.save_state(state.demod), "cpu")
    assert torch.equal(demod.pos, state.demod.pos)
    with pytest.raises(TypeError):
        checkpoint.save_state({"pos": state.demod.pos})
    dec = make_decoder()
    dec.process(_tx_variant(0)[:2000])
    twin = checkpoint.load_decoder(checkpoint.save_decoder(dec))
    rest = _tx_variant(0)[2000:5000]
    assert twin.process(rest) == dec.process(rest)


def test_metrics_meter_and_torch_trace(tmp_path, monkeypatch, fixture_audio):
    """The bank's counters feed the periodic report; ``torch_trace``
    writes a Chrome trace whose rows hold the bank's spans beside the
    profiler's ops, on the ops' timeline, and leaves the tracer off."""
    lines = []
    monkeypatch.setattr(metrics.TRACER, "sink", lines.append)
    monkeypatch.setattr(metrics.TRACER, "report_every", 1e-9)
    bank = _port_bank(2, 2)
    with metrics.torch_trace(str(tmp_path / "trace")):
        bank.push(fixture_audio[:2, :8000])
    assert not metrics.TRACER.on and bank.steps >= 2
    assert len(lines) == bank.steps
    assert all('"report": "bank"' in line for line in lines)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    ours = [e for e in trace["traceEvents"]
            if e.get("pid") == "digiham_tpu_torch spans"]
    names = [e["name"] for e in ours]
    assert names.count("bank.push") == 1
    assert names.count("bank.step") == names.count("bank.launch") == bank.steps
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::")]
    push = ours[names.index("bank.push")]
    assert ops and all(push["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= push["ts"] + push["dur"] + 1000 for e in ops)


if __name__ == "__main__":
    fx = build_fixture()
    BANK.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BANK.fixture, **fx)
    print(f"wrote {BANK.fixture} (noise seeds {fx['noise_seeds'].tolist()}, "
          f"chunks {fx['chunks'].tolist()})")
