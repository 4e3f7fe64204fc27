"""The port's streaming YSF bank against the JAX package's:
``TrackedChannelBank`` with ``YsfAdapter`` over ``YsfPipeline`` (FM audio
in uneven chunks -> flush), its ``push_dibits`` with and without
device-gated hunting, the per-channel ``make_decoder()``, snapshot/restore,
the hand-off of a JAX bank's snapshot through
``convert.from_jax_checkpoint``, and the committed fixture
``data/ysf_bank_smoke.npz`` rebuilt from ``ysf_synth`` plus the JAX bank.
Voice bytes and metadata event strings must be equal byte for byte.

Sample streams carry noise whose seed is screened knife-edge free
(torch_parity.audio_knife_edge_free), so the two packages must agree
exactly. Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_tracked_bank_ysf.py``.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from digiham_tpu.dsp.rrc import WIDE_RRC
from digiham_tpu.pipeline import YsfPipeline as JPipeline
from digiham_tpu.protocols.ysf import make_decoder as j_make_decoder
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu.runtime.tracked_bank import YsfAdapter as JAdapter
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.pipeline import YsfPipeline, ysf_sync_correlate
from digiham_tpu_torch.protocols.ysf import make_decoder
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.tracked_bank import (TrackedChannelBank,
                                                    YsfAdapter)

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
from test_tracked_bank_ysf import make_streams  # noqa: E402
from torch_parity import DOTS  # noqa: E402
from ysf_synth import (header_frame, terminator_frame, v1_frame,  # noqa: E402
                       vd2_frame, vw_frame)

torch.set_num_threads(1)

BANK = smoke.YSF_BANK
VARIANTS = 8
N_SAMPLES = 58_000  # 5 steps of 10 centuries and a tail of ~800 symbols
N_SYMBOLS = N_SAMPLES // BANK.sps + 2
GPS, ERRORS, IDLE, FLUSH_VOICE = 4, 5, 6, 7  # variants with a role
CALLSIGNS = (b"DL1ABC", b"DB0XYZ", b"DOWNLINK", b"UPLINK")  # the header's
DCH_CALLSIGNS = (b"DK0DCH", b"DO1SRC", b"DN-DCH", b"UP-DCH")  # DCH 0-3
# a DT1+DT2 data frame of a short GPS report (command 0x22625F, radio
# FT-2D): 50 deg 06.50 min N, 8 deg 07.50 min E (src/ysf_decoder/gps.cpp)
GPS_BODY = bytes([0x00, 0x22, 0x62, 0x5F, 0x28,
                  0x35, 0x30, 0x30, 0x56, 0x55, 0x30, 0x7E, 0x5F, 0x4E,
                  0x20, 0x20, 0x20, 0x20, 0x03])
GPS_FRAME = GPS_BODY + bytes([sum(GPS_BODY) & 0xFF])


def _dch(fn: int, name: bytes) -> bytes:
    return (name + b" " * 10)[:10] if fn < 4 else b" " * 10


def _tx_variant(v: int) -> np.ndarray:
    """One variant's TX dibits [N_SYMBOLS]: dotting, then the variant's
    frames, then dotting to the end."""
    rng = np.random.default_rng(4000 + v)

    def ambe():
        return rng.integers(0, 256, 7).astype(np.uint8).tobytes()

    def dn_call(n, names=CALLSIGNS, dch_names=DCH_CALLSIGNS):
        return [header_frame(*names)] + [
            vd2_frame(i % 8, _dch(i % 8, dch_names[i % 4]), ambe())
            for i in range(n)]

    lead = DOTS[:200]
    if v in (0, ERRORS):  # a DN call: callsigns in DCH frames 0-3
        frames = dn_call(9) + [terminator_frame()]
    elif v == 1:  # V/D1
        frames = [header_frame(*CALLSIGNS)] + [
            v1_frame(i % 8, rng.integers(0, 4, 36)) for i in range(9)] \
            + [terminator_frame()]
    elif v == 2:  # VW: the sub-frame after the header
        frames = [header_frame(*CALLSIGNS)] + [
            vw_frame(i % 8, rng.integers(0, 256, 18).astype(np.uint8)
                     .tobytes()) for i in range(9)] + [terminator_frame()]
    elif v == 3:  # a terminator, then a second transmission
        frames = dn_call(3) + [terminator_frame()] + dn_call(
            4, (b"DK2XY", b"DF5AB", b"D2", b"U2"),
            (b"DK2DCH", b"DF5DCH", b"D2DCH", b"U2DCH")) \
            + [terminator_frame()]
    elif v == GPS:  # V/D2 with a GPS report in DCH frames 6-7
        frames = [header_frame(*CALLSIGNS)] + [
            vd2_frame(fn, GPS_FRAME[(fn - 6) * 10:(fn - 5) * 10]
                      if fn >= 6 else _dch(fn, DCH_CALLSIGNS[fn % 4]),
                      ambe())
            for fn in range(8)] + [terminator_frame()]
    elif v == IDLE:  # no carrier at all (smoke.bank_audio switches it off)
        frames = []
    else:  # FLUSH_VOICE: a DN call up to the end of the stream
        lead = DOTS[:60]
        frames = dn_call(12)
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
        YsfPipeline(channels=C, sps=BANK.sps, n_centuries=nc, device="cpu"),
        adapter=YsfAdapter(), device="cpu")


def build_fixture(noise_seeds=None) -> dict:
    """The fixture from ysf_synth and the JAX bank (see torch_bank)."""
    return torch_bank.build_fixture(
        BANK, WIDE_RRC, np.stack([_tx_variant(v) for v in range(VARIANTS)]),
        np.arange(VARIANTS) == IDLE, torch_bank.chunks(N_SAMPLES, 43),
        _jax_bank, noise_seeds)


@pytest.fixture(scope="module")
def committed():
    return smoke.load(BANK)


@pytest.fixture(scope="module")
def fixture_audio(committed):
    return smoke.bank_audio(BANK, committed)


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from ysf_synth and the
    JAX bank with its stored seeds, and its streams are knife-edge free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    assert np.array_equal(
        torch_bank.screened_seeds(BANK, WIDE_RRC, committed, 9000),
        committed["noise_seeds"])


def test_fixture_is_a_stream_worth_checking(committed):
    """Voice in every call variant in whole blocks of its mode (DN 8, V1
    10, VW 19 bytes), none on the idle channel; callsigns from the header
    and the DCH, the three modes and the GPS position are in the events."""
    voice, events = zip(*(smoke.bank_expected(committed, v)
                          for v in range(VARIANTS)))
    for v, size in ((0, 8), (1, 10), (2, 19), (3, 8), (GPS, 8), (ERRORS, 8),
                    (FLUSH_VOICE, 8)):
        assert len(voice[v]) >= 20 * size and len(voice[v]) % size == 0, v
    assert voice[IDLE] == b"" and events[IDLE] == ""
    assert "target:DL1ABC" in events[0] and "source:DB0XYZ" in events[0]
    assert "up:UPLINK" in events[0] and "mode:DN" in events[0]
    assert "target:DK0DCH" in events[0] and "up:UP-DCH" in events[0]
    assert "mode:V1" in events[1] and "mode:VW" in events[2]
    assert "source:DF5AB" in events[3] and "source:DF5DCH" in events[3]
    assert "lat:50.108334" in events[GPS] and "lon:8.125000" in events[GPS]


def test_port_bank_decodes_the_fixture(committed, fixture_audio):
    """The port's bank at the fixture's size (10 centuries) leaves the
    fixture's tail to its flush, gives the JAX bank's bytes and events on
    every variant, and the flush-voice variant emits bytes in ``flush``
    itself."""
    bank = _port_bank(VARIANTS)
    outs, _ = torch_bank.run(bank, PipelineMetaWriter, fixture_audio,
                             committed["chunks"], flush=False,
                             tail=BANK.flush_tail)
    before = len(outs[FLUSH_VOICE])
    bank.flush()
    assert len(outs[FLUSH_VOICE]) > before
    full, ev = torch_bank.run(_port_bank(VARIANTS), PipelineMetaWriter,
                              fixture_audio, committed["chunks"])
    for v in range(VARIANTS):
        assert (full[v], ev[v]) == smoke.bank_expected(committed, v), v


def test_channel_bank_equals_tracked_bank(committed, fixture_audio):
    """The plain ChannelBank with make_decoder() per channel gives the
    tracked bank's bytes and events on four variants, flush included."""
    pick = [0, 2, GPS, FLUSH_VOICE]
    pipe = YsfPipeline(channels=4, sps=BANK.sps,
                       n_centuries=BANK.n_centuries, device="cpu")
    bank = ChannelBank(pipe, [make_decoder() for _ in pick], device="cpu")
    got = torch_bank.run(bank, PipelineMetaWriter, fixture_audio[pick],
                         committed["chunks"])
    assert got == tuple(map(list, zip(*(smoke.bank_expected(committed, v)
                                        for v in pick))))


# --- small streams against the JAX package --------------------------------

def _streams(seed):
    """The dibit streams and push size of tests/test_tracked_bank_ysf.py."""
    if seed == "noise":
        return np.random.default_rng(7).integers(0, 4, (2, 15000)).astype(
            np.uint8), 1111
    return make_streams(seed), 960


@pytest.mark.parametrize("seed", list(range(6)) + ["noise"])
def test_make_decoder_matches_jax(seed):
    """The symbol-domain decoder on the streams of
    tests/test_tracked_bank_ysf.py: the JAX package's bytes and events."""
    streams, _ = _streams(seed)
    got = torch_bank.reference_path(make_decoder, PipelineMetaWriter,
                                    streams)
    want = torch_bank.reference_path(j_make_decoder, JWriter, streams)
    assert got == want
    if seed != "noise":
        assert all(got[0]) and all(got[1])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", list(range(6)) + ["noise"])
def test_push_dibits_matches_jax_bank(seed, gated):
    """The bank's fields path, with and without device-gated hunting,
    gives the JAX bank's bytes and events (and the decoder's)."""
    streams, chunk = _streams(seed)
    got = torch_bank.push_dibits(
        _port_bank(streams.shape[0], 5), PipelineMetaWriter, streams, chunk,
        ysf_sync_correlate if gated else None)
    assert got == torch_bank.push_dibits(
        _jax_bank(streams.shape[0], 5), JWriter, streams, chunk)
    assert got == tuple(torch_bank.reference_path(
        make_decoder, PipelineMetaWriter, streams))


def _small_audio(seed, channels=4):
    """FM audio [C, n] of make_streams traffic (2 channels per call),
    noise seeds screened knife-edge free, and uneven push chunks."""
    parts = [make_streams(seed + s) for s in range(channels // 2)]
    n_sym = min(p.shape[1] for p in parts)
    tx = np.concatenate([p[:, :n_sym] for p in parts])
    fx = {"tx_dibits": tx, "idle": np.zeros(len(tx), bool),
          "chunks": torch_bank.chunks((n_sym - 2) * BANK.sps, seed, lo=100,
                                      hi=9000)}
    fx["noise_seeds"] = torch_bank.screened_seeds(BANK, WIDE_RRC, fx,
                                                  100 * seed)
    return smoke.bank_audio(BANK, fx), fx["chunks"]


def test_tracked_bank_audio_matches_jax():
    """Audio in uneven chunks, then flush: the JAX bank's bytes and events
    at 5 centuries on every channel."""
    samples, chunks = _small_audio(20)
    want = torch_bank.run(_jax_bank(len(samples), 5), JWriter, samples,
                          chunks)
    got = torch_bank.run(_port_bank(len(samples), 5), PipelineMetaWriter,
                         samples, chunks)
    assert got == want and any(want[0]) and any(want[1])


def test_snapshot_restore_midstream(committed, fixture_audio):
    """A snapshot taken between pushes, restored into a fresh bank, gives
    the same remainder as the bank that went on; the YSF machines pickle
    without the JAX package (the blob holds numpy and port classes)."""
    pick = [0, 3, GPS, FLUSH_VOICE]
    samples, chunks = fixture_audio[pick], committed["chunks"]
    cut = len(chunks) // 2
    first = _port_bank(len(pick))
    torch_bank.run(first, PipelineMetaWriter, samples, chunks[:cut],
                   flush=False)
    blob = first.snapshot()
    assert b"digiham_tpu_torch.protocols.ysf" in pickle.loads(blob)["chans"]
    assert b"digiham_tpu.protocols" not in pickle.loads(blob)["chans"]
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
    j_first = _jax_bank(len(samples), 5)
    torch_bank.run(j_first, JWriter, samples, chunks[:cut], flush=False)
    payload = pickle.loads(j_first.snapshot())
    rest = samples[:, int(chunks[:cut].sum()):]
    j_second, p_second = _jax_bank(len(samples), 5), _port_bank(len(samples),
                                                                 5)
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
    """``device=None`` is the card: without one the YSF bank raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pipe = YsfPipeline(channels=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackedChannelBank(pipe, adapter=YsfAdapter())


if __name__ == "__main__":
    fx = build_fixture()
    BANK.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BANK.fixture, **fx)
    print(f"wrote {BANK.fixture} (noise seeds {fx['noise_seeds'].tolist()}, "
          f"chunks {fx['chunks'].tolist()})")
