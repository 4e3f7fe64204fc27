"""The port's streaming NXDN bank against the JAX package's:
``TrackedChannelBank`` with ``NxdnAdapter`` over ``NxdnPipeline`` (FM audio
in uneven chunks -> flush through K4's 161-tap RRC), its ``push_dibits``
with and without device-gated hunting, the per-channel ``make_decoder()``,
the TX_RELEASE re-hunt (``keep_from``), snapshot/restore, the hand-off of
a JAX bank's snapshot through ``convert.from_jax_checkpoint``, and the
committed fixture ``data/nxdn_bank_smoke.npz`` rebuilt from ``nxdn_synth``
plus the JAX bank. Voice bytes and metadata event strings must be equal
byte for byte.

Sample streams carry noise whose seed is screened knife-edge free
(torch_parity.audio_knife_edge_free), so the two packages must agree
exactly. Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_tracked_bank_nxdn.py``.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from digiham_tpu.dsp.rrc import NARROW_RRC
from digiham_tpu.pipeline import NxdnPipeline as JPipeline
from digiham_tpu.protocols.nxdn import make_decoder as j_make_decoder
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.tracked_bank import NxdnAdapter as JAdapter
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.bench import host_synth
from digiham_tpu_torch.pipeline import (DmrPipeline, NxdnPipeline,
                                        nxdn_sync_correlate)
from digiham_tpu_torch.protocols.nxdn import make_decoder
from digiham_tpu_torch.protocols.nxdn.components import \
    SacchSuperframeCollector
from digiham_tpu_torch.protocols.nxdn.fields_phase import \
    NxdnFieldsFramePhase
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER
from digiham_tpu_torch.runtime.tracked_bank import (NxdnAdapter,
                                                    TrackedChannelBank)

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
from nxdn_synth import (encode_facch1, encode_sacch_unit,  # noqa: E402
                        nxdn_frame, vcall_superframe_bytes,
                        voice_slot_dibits)
from test_tracked_bank_nxdn import make_streams  # noqa: E402
from torch_parity import DOTS  # noqa: E402

torch.set_num_threads(1)

BANK = smoke.NXDN_BANK
VARIANTS = 8
N_SAMPLES = 46_000  # 5 steps of 4 centuries at sps 20 and a ~300-symbol tail
N_SYMBOLS = N_SAMPLES // BANK.sps + 2
RELEASE, ERRORS, IDLE, FLUSH_VOICE = 1, 3, 4, 6  # variants with a role
IDLE_MT, TX_RELEASE = 0x10, 0x08  # FACCH1 message types


def _tx_variant(v: int) -> np.ndarray:
    """One variant's TX dibits [N_SYMBOLS]: dotting, then the variant's
    frames, then dotting to the end."""
    rng = np.random.default_rng(5000 + v)

    def frame(i, units, option=0b11, lich=(0b01, 0b10), facch=IDLE_MT):
        slots = [voice_slot_dibits(rng.integers(0, 4, 72), 38 + 72 * s)
                 if (option >> (1 - s)) & 1
                 else encode_facch1(facch, 38 + 72 * s) for s in range(2)]
        return nxdn_frame((*lich, option),
                          encode_sacch_unit(i % 4, units[i % 4]), slots)

    def call(n, ids=(1, 1000 + v, 2000 + v), options=(0b11,)):
        # (call type, source, destination) whose four SACCH units all
        # pass their CRC: a clean unit can fail it (punctured bits are
        # inflated as received zeros), in the reference too
        units = vcall_superframe_bytes(*ids)
        return [frame(i, units, options[i % len(options)]) for i in range(n)]

    lead = DOTS[:192]
    if v in (0, ERRORS):  # a voice call: two whole SACCH superframes
        frames = call(9)
    elif v == RELEASE:  # FACCH1 TX_RELEASE in slot 0 mid-stream, a 2nd call
        units = vcall_superframe_bytes(1, 4321, 8765)
        frames = call(4, (1, 4321, 8765)) + [
            frame(4, units, 0b01, facch=TX_RELEASE), DOTS[:64]] \
            + call(5, (4, 4711, 815))
    elif v == 2:  # RCCH and UDCH frames (SACCH and slots skipped) in a call
        units = vcall_superframe_bytes(1, 1002, 2002)
        frames = [frame(i, units, 0b11, lich)
                  for i, lich in enumerate([(0b01, 0b10), (0b00, 0b10),
                                            (0b01, 0b01), (0b01, 0b10),
                                            (0b01, 0b10), (0b00, 0b01),
                                            (0b01, 0b10), (0b01, 0b10),
                                            (0b01, 0b10)])]
    elif v == IDLE:  # no carrier at all (smoke.bank_audio switches it off)
        frames = []
    elif v == 5:  # a late start
        lead = np.tile(DOTS, 3)[:1200]
        frames = call(5)
    elif v == FLUSH_VOICE:  # a call up to the end of the stream
        lead = DOTS[:40]
        frames = call(12)
    else:  # an individual call, voice and FACCH1 (idle) slots mixed
        frames = call(9, (4, 2468, 1357), (0b11, 0b10, 0b01, 0b11))
    tx = np.concatenate([lead] + [np.asarray(f, np.uint8) for f in frames])
    if v == ERRORS:
        hit = rng.random(len(tx)) < 0.01
        tx[hit] = rng.integers(0, 4, int(hit.sum()))
    fill = np.tile(DOTS, -(-(N_SYMBOLS - len(tx)) // len(DOTS)) + 1)
    return np.concatenate([tx, fill])[:N_SYMBOLS].astype(np.uint8)


def _jax_bank(C, nc=BANK.n_centuries):
    return JBank(JPipeline(channels=C, sps=BANK.sps, n_centuries=nc),
                 adapter=JAdapter())


def _port_bank(C, nc=BANK.n_centuries):
    return TrackedChannelBank(
        NxdnPipeline(channels=C, sps=BANK.sps, n_centuries=nc, device="cpu"),
        adapter=NxdnAdapter(), device="cpu")


def build_fixture(noise_seeds=None) -> dict:
    """The fixture from nxdn_synth and the JAX bank (see torch_bank)."""
    return torch_bank.build_fixture(
        BANK, NARROW_RRC,
        np.stack([_tx_variant(v) for v in range(VARIANTS)]),
        np.arange(VARIANTS) == IDLE,
        torch_bank.chunks(N_SAMPLES, 44, hi=15_000), _jax_bank, noise_seeds)


@pytest.fixture(scope="module")
def committed():
    return smoke.load(BANK)


@pytest.fixture(scope="module")
def fixture_audio(committed):
    return smoke.bank_audio(BANK, committed)


@pytest.fixture
def releases(monkeypatch):
    """Counts the re-hunts that start inside a frame: the tracker's
    ``keep_from`` > 0 (a TX_RELEASE in a FACCH1 slot)."""
    seen = []
    process = NxdnFieldsFramePhase.process_fields

    def counted(self, f):
        out = process(self, f)
        if out[1] and out[2]:
            seen.append(out[2])
        return out

    monkeypatch.setattr(NxdnFieldsFramePhase, "process_fields", counted)
    return seen


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from nxdn_synth and the
    JAX bank with its stored seeds, and its streams are knife-edge free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    assert np.array_equal(
        torch_bank.screened_seeds(BANK, NARROW_RRC, committed, 9000),
        committed["noise_seeds"])


def test_fixture_is_a_stream_worth_checking(committed):
    """Voice in every call variant in whole 18-byte slots, none on the
    idle channel; both calls of the TX_RELEASE variant and the
    superframe's source and destination are in the events."""
    voice, events = zip(*(smoke.bank_expected(committed, v)
                          for v in range(VARIANTS)))
    for v in (0, RELEASE, 2, ERRORS, 5, FLUSH_VOICE, 7):
        assert len(voice[v]) >= 8 * 18 and len(voice[v]) % 18 == 0, v
    assert voice[IDLE] == b"" and events[IDLE] == ""
    assert "source:1000" in events[0] and "destination:2000" in events[0]
    assert "sync:voice" in events[0] and "type:conference" in events[0]
    assert "source:4321" in events[RELEASE] and "source:4711" in events[
        RELEASE] and "type:individual" in events[RELEASE]
    assert "source:2468" in events[7] and "type:individual" in events[7]


def test_port_bank_decodes_the_fixture(committed, fixture_audio, releases):
    """The port's bank at the fixture's size (4 centuries at sps 20)
    leaves the fixture's tail to its flush, gives the JAX bank's bytes and
    events on every variant, re-hunts inside the TX_RELEASE frame, and the
    flush-voice variant emits bytes in ``flush`` itself."""
    bank = _port_bank(VARIANTS)
    outs, _ = torch_bank.run(bank, PipelineMetaWriter, fixture_audio,
                             committed["chunks"], flush=False,
                             tail=BANK.flush_tail)
    before = len(outs[FLUSH_VOICE])
    bank.flush()
    assert len(outs[FLUSH_VOICE]) > before
    assert releases == [48]
    full, ev = torch_bank.run(_port_bank(VARIANTS), PipelineMetaWriter,
                              fixture_audio, committed["chunks"])
    for v in range(VARIANTS):
        assert (full[v], ev[v]) == smoke.bank_expected(committed, v), v


def test_channel_bank_equals_tracked_bank(committed, fixture_audio):
    """The plain ChannelBank with make_decoder() per channel gives the
    tracked bank's bytes and events on four variants, flush included."""
    pick = [0, RELEASE, 2, FLUSH_VOICE]
    pipe = NxdnPipeline(channels=4, sps=BANK.sps,
                        n_centuries=BANK.n_centuries, device="cpu")
    bank = ChannelBank(pipe, [make_decoder() for _ in pick], device="cpu")
    got = torch_bank.run(bank, PipelineMetaWriter, fixture_audio[pick],
                         committed["chunks"])
    assert got == tuple(map(list, zip(*(smoke.bank_expected(committed, v)
                                        for v in pick))))


# --- small streams against the JAX package --------------------------------

def _streams(seed):
    if seed == "noise":
        return np.random.default_rng(17).integers(0, 4, (2, 12000)).astype(
            np.uint8), 997
    return make_streams(seed), 768


@pytest.mark.parametrize("seed", list(range(6)) + ["noise"])
def test_make_decoder_matches_jax(seed):
    """The symbol-domain decoder on the streams of
    tests/test_tracked_bank_nxdn.py: the JAX package's bytes and events."""
    streams, _ = _streams(seed)
    got = torch_bank.reference_path(make_decoder, PipelineMetaWriter,
                                    streams)
    assert got == torch_bank.reference_path(j_make_decoder, JWriter, streams)
    if seed != "noise":
        assert all(got[0])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", list(range(6)) + ["noise"])
def test_push_dibits_matches_jax_bank(seed, gated):
    """The bank's fields path, with and without device-gated hunting,
    gives the JAX bank's bytes and events (and the decoder's)."""
    streams, chunk = _streams(seed)
    got = torch_bank.push_dibits(
        _port_bank(streams.shape[0], 3), PipelineMetaWriter, streams, chunk,
        nxdn_sync_correlate if gated else None)
    assert got == torch_bank.push_dibits(
        _jax_bank(streams.shape[0], 3), JWriter, streams, chunk)
    assert got == tuple(torch_bank.reference_path(
        make_decoder, PipelineMetaWriter, streams))


def test_tx_release_rehunts_mid_frame(releases):
    """A TX_RELEASE in a FACCH1 slot ends the frame early (``keep_from``
    48 or 120 dibits into it) and the bank re-hunts from there, as the
    decoder does, on the streams that hold one."""
    for seed in range(6):
        streams, chunk = _streams(seed)
        got = torch_bank.push_dibits(_port_bank(streams.shape[0], 3),
                                     PipelineMetaWriter, streams, chunk)
        assert got == tuple(torch_bank.reference_path(
            make_decoder, PipelineMetaWriter, streams))
    assert releases and set(releases) <= {48, 120}


def test_sacch_sfs_counts_the_superframes_the_trackers_complete(
        monkeypatch):
    """``sacch_sfs``: each SACCH superframe an NXDN tracker completes, as
    many as the per-channel decoder completes on the same streams; a DMR
    bank, which decodes voice, counts none."""
    completed = []
    get = SacchSuperframeCollector.get_superframe
    monkeypatch.setattr(SacchSuperframeCollector, "get_superframe",
                        lambda self: completed.append(1) or get(self))
    streams = [_streams(seed) for seed in range(6)]
    for dibits, _ in streams:
        torch_bank.reference_path(make_decoder, PipelineMetaWriter, dibits)
    monkeypatch.undo()
    before = TRACER.counts.sacch_sfs
    for dibits, chunk in streams:
        torch_bank.push_dibits(_port_bank(dibits.shape[0], 3),
                               PipelineMetaWriter, dibits, chunk)
    assert TRACER.counts.sacch_sfs - before == len(completed) > 0
    dmr = host_synth.dmr_streams(11, 3)
    before = TRACER.counts.sacch_sfs
    voice, _ = torch_bank.push_dibits(
        TrackedChannelBank(DmrPipeline(channels=3, sps=10, n_centuries=3,
                                       device="cpu"), device="cpu"),
        PipelineMetaWriter, dmr, 768)
    assert any(voice) and TRACER.counts.sacch_sfs == before



VCALL = 0x01  # FACCH1 message type of a call's header (late entry)


def _late_entry_streams(channels=3):
    """Dibits [C, n]: a call a channel whose every third frame carries a
    FACCH1 VCALL in slot 0, one ``FACCH1 message type: 1`` line each."""
    rows = []
    for c in range(channels):
        rng = np.random.default_rng(70 + c)
        units = vcall_superframe_bytes(1, 3000 + c, 4000 + c)
        frames = []
        for i in range(12):
            option = 0b01 if i % 3 == 1 else 0b11
            slots = [voice_slot_dibits(rng.integers(0, 4, 72), 38 + 72 * s)
                     if (option >> (1 - s)) & 1
                     else encode_facch1(VCALL, 38 + 72 * s)
                     for s in range(2)]
            frames.append(nxdn_frame((0b01, 0b10, option),
                                     encode_sacch_unit(i % 4, units[i % 4]),
                                     slots))
        rows.append(np.concatenate(
            [DOTS[:192 + 40 * c]] + [np.asarray(f, np.uint8) for f in frames]
            + [DOTS[:192]]))
    n = min(map(len, rows))
    return np.stack([r[:n] for r in rows]).astype(np.uint8)


class _Stderr:
    """Keeps each write to standard error."""

    def __init__(self):
        self.writes = []

    def write(self, text):
        self.writes.append(text)
        return len(text)

    def flush(self):
        pass


def test_the_banks_facch1_lines_are_the_decoders_one_write_a_step(
        monkeypatch):
    """The FACCH1 lines the bank's trackers say are the per-channel
    decoder's, each channel's in its order, and the bank writes a step's
    lines in one call (``runtime/diag.py``), where the decoder writes
    each line at once."""
    streams = _late_entry_streams()
    err = _Stderr()
    monkeypatch.setattr(sys, "stderr", err)
    want = tuple(torch_bank.reference_path(make_decoder, PipelineMetaWriter,
                                           streams))
    said = "".join(err.writes).splitlines()
    assert said and set(said) == {f"FACCH1 message type: {VCALL}"}
    assert len(err.writes) >= len(said)
    err.writes.clear()
    chunk = 768
    got = torch_bank.push_dibits(_port_bank(streams.shape[0], 3),
                                 PipelineMetaWriter, streams, chunk)
    assert got == want and any(got[0])
    assert "".join(err.writes).splitlines() == said
    assert len(err.writes) <= -(-streams.shape[1] // chunk) < len(said)

def _small_audio(seed, channels=4):
    """FM audio [C, n] of make_streams traffic (2 channels per call),
    noise seeds screened knife-edge free, and uneven push chunks."""
    parts = [make_streams(seed + s) for s in range(channels // 2)]
    n_sym = min(p.shape[1] for p in parts)
    tx = np.concatenate([p[:, :n_sym] for p in parts])
    fx = {"tx_dibits": tx, "idle": np.zeros(len(tx), bool),
          "chunks": torch_bank.chunks((n_sym - 2) * BANK.sps, seed, lo=100,
                                      hi=9000)}
    fx["noise_seeds"] = torch_bank.screened_seeds(BANK, NARROW_RRC, fx,
                                                  100 * seed)
    return smoke.bank_audio(BANK, fx), fx["chunks"]


def test_tracked_bank_audio_matches_jax():
    """Audio in uneven chunks, then flush: the JAX bank's bytes and events
    at 3 centuries on every channel."""
    samples, chunks = _small_audio(20)
    want = torch_bank.run(_jax_bank(len(samples), 3), JWriter, samples,
                          chunks)
    got = torch_bank.run(_port_bank(len(samples), 3), PipelineMetaWriter,
                         samples, chunks)
    assert got == want and any(want[0]) and any(want[1])


def test_snapshot_restore_midstream(committed, fixture_audio):
    """A snapshot taken between pushes, restored into a fresh bank, gives
    the same remainder as the bank that went on; the NXDN machines pickle
    without the JAX package (the blob holds numpy and port classes)."""
    pick = [0, RELEASE, 5, FLUSH_VOICE]
    samples, chunks = fixture_audio[pick], committed["chunks"]
    cut = len(chunks) // 2
    first = _port_bank(len(pick))
    torch_bank.run(first, PipelineMetaWriter, samples, chunks[:cut],
                   flush=False)
    blob = first.snapshot()
    chans = pickle.loads(blob)["chans"]
    assert b"digiham_tpu_torch.protocols.nxdn" in chans
    assert b"digiham_tpu.protocols" not in chans
    rest = samples[:, int(chunks[:cut].sum()):]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[cut:])
    second = _port_bank(len(pick))
    second.restore(blob)
    got = torch_bank.run(second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want and all(want[0])


def test_convert_handoff_from_jax_snapshot():
    """What crosses from a JAX bank's snapshot is its pipeline state and
    pending samples (``convert.from_jax_checkpoint``), never its host
    machines: a port bank with fresh machines, handed them, gives what a
    JAX bank with fresh machines handed the same gives."""
    samples, chunks = _small_audio(30)
    cut = len(chunks) // 2
    j_first = _jax_bank(len(samples), 3)
    torch_bank.run(j_first, JWriter, samples, chunks[:cut], flush=False)
    payload = pickle.loads(j_first.snapshot())
    rest = samples[:, int(chunks[:cut].sum()):]
    j_second = _jax_bank(len(samples), 3)
    p_second = _port_bank(len(samples), 3)
    j_second.state = j_load_state(payload["pipeline_state"])
    p_second.state = convert.from_jax_checkpoint(payload["pipeline_state"],
                                                 device="cpu")
    for bank in (j_second, p_second):
        bank.samples.push(payload["samples"])
        bank.samples.consumed = 1
    want = torch_bank.run(j_second, JWriter, rest, chunks[cut:])
    assert torch_bank.run(p_second, PipelineMetaWriter, rest,
                          chunks[cut:]) == want
    assert any(want[0])


def test_no_card_raises():
    """``device=None`` is the card: without one the NXDN bank raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pipe = NxdnPipeline(channels=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackedChannelBank(pipe, adapter=NxdnAdapter())


if __name__ == "__main__":
    fx = build_fixture()
    BANK.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BANK.fixture, **fx)
    print(f"wrote {BANK.fixture} (noise seeds {fx['noise_seeds'].tolist()}, "
          f"chunks {fx['chunks'].tolist()})")
