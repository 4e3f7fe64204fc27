"""The port's streaming D-Star bank against the JAX package's:
``TrackedChannelBank`` with ``DstarAdapter`` over ``FskPipeline`` (FM audio
in uneven chunks -> flush), its ``push_dibits`` with and without
device-gated hunting, the per-channel ``make_decoder()``, snapshot/restore
(mid-stream and while a header decode is pending), the hand-off of a JAX
bank's snapshot through ``convert.from_jax_checkpoint`` (an FSK state
without an RRC: 3 leaves), and the committed fixture
``data/dstar_bank_smoke.npz`` rebuilt from tests/torch_fsk.py's variants
plus the JAX bank. Voice bytes and metadata event strings must be equal
byte for byte.

Sample streams carry noise whose seed is screened knife-edge free
(torch_parity.audio_knife_edge_free), so the two packages must agree
exactly. Rebuild the fixture with
``PYTHONPATH=.:tests python tests/test_torch_tracked_bank_dstar.py``.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from digiham_tpu.pipeline import FskPipeline as JPipeline
from digiham_tpu.protocols.dstar import make_decoder as j_make_decoder
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.tracked_bank import DstarAdapter as JAdapter
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.pipeline import FskPipeline, bit_sync_correlate
from digiham_tpu_torch.pipeline.fsk import FskPipelineState
from digiham_tpu_torch.protocols.dstar import make_decoder
from digiham_tpu_torch.protocols.dstar.phases import (HEADER_SYNC,
                                                      TERMINATOR, VOICE_SYNC)
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.tracked_bank import (DstarAdapter,
                                                    TrackedChannelBank)

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
import torch_fsk  # noqa: E402
from test_dstar import full_voice_stream  # noqa: E402
from test_tracked_bank_dstar import make_streams  # noqa: E402

torch.set_num_threads(1)

BANK = smoke.DSTAR_BANK
N_SAMPLES = 60_000  # 15 steps of 4 centuries and a tail
N_BITS = N_SAMPLES // BANK.sps + 2


def _jax_bank(C, nc=BANK.n_centuries):
    return JBank(JPipeline(channels=C, protocol="dstar", n_centuries=nc),
                 adapter=JAdapter())


def _port_bank(C, nc=BANK.n_centuries):
    return TrackedChannelBank(
        FskPipeline(C, "dstar", n_centuries=nc, device="cpu"),
        adapter=DstarAdapter(), device="cpu")


def build_fixture(noise_seeds=None) -> dict:
    """The fixture from torch_fsk's variants and the JAX bank (see
    torch_bank); pushes of 500-8,000 samples, so that some push ends while
    a header decode is pending."""
    tx = np.stack([torch_fsk.dstar_variant(v, N_BITS)
                   for v in range(torch_fsk.VARIANTS)])
    return torch_bank.build_fixture(
        BANK, None, tx, np.arange(torch_fsk.VARIANTS) == torch_fsk.D_IDLE,
        torch_bank.chunks(N_SAMPLES, 47, hi=8000), _jax_bank, noise_seeds,
        mode="fsk")


@pytest.fixture(scope="module")
def committed():
    return smoke.load(BANK)


@pytest.fixture(scope="module")
def fixture_audio(committed):
    return smoke.bank_audio(BANK, committed)


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from torch_fsk and the
    JAX bank with its stored seeds, and its streams are knife-edge free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    assert np.array_equal(
        torch_bank.screened_seeds(BANK, None, committed, 9000, mode="fsk"),
        committed["noise_seeds"])


def test_fixture_is_a_stream_worth_checking(committed):
    """Voice in 9-byte frames in every call variant, none on the idle
    channel; the header's callsigns, the slow-data message and the D-PRS
    report are in the events, and the terminators reset them."""
    voice, events = zip(*(smoke.bank_expected(committed, v)
                          for v in range(torch_fsk.VARIANTS)))
    for v in (torch_fsk.D_CALL, torch_fsk.D_VSYNC, torch_fsk.D_TWO_CALLS,
              torch_fsk.D_HALF_TERM, torch_fsk.D_ERRORS,
              torch_fsk.D_BAD_HEADER, torch_fsk.D_FLUSH):
        assert len(voice[v]) >= 9 * 9 and len(voice[v]) % 9 == 0, v
    assert voice[torch_fsk.D_IDLE] == b"" and events[torch_fsk.D_IDLE] == ""
    call = events[torch_fsk.D_CALL]
    assert "ourcall:W1AW/705" in call and "yourcall:CQCQCQ" in call
    assert f"message:{torch_fsk.MESSAGE.decode()}" in call
    assert call.endswith("protocol:DSTAR\n")  # the full terminator's reset
    two = events[torch_fsk.D_TWO_CALLS]
    assert "ourcall:DL1XYZ" in two and "dprs:DL1XYZ>API705" in two
    assert events[torch_fsk.D_HALF_TERM].endswith("protocol:DSTAR\n")
    assert "ourcall:" not in events[torch_fsk.D_BAD_HEADER]
    assert "ourcall:DK5EW/T" in events[torch_fsk.D_FLUSH]


def test_port_bank_decodes_the_fixture(committed, fixture_audio):
    """The port's bank at the fixture's size (4 centuries) leaves the
    fixture's tail to its flush, gives the JAX bank's bytes and events on
    every variant, and the flush variant emits bytes in ``flush`` itself
    (the per-symbol 2FSK oracle; there is no RRC to run)."""
    bank = _port_bank(torch_fsk.VARIANTS)
    outs, _ = torch_bank.run(bank, PipelineMetaWriter, fixture_audio,
                             committed["chunks"], flush=False,
                             tail=BANK.flush_tail)
    before = len(outs[torch_fsk.D_FLUSH])
    bank.flush()
    assert len(outs[torch_fsk.D_FLUSH]) > before
    full, ev = torch_bank.run(_port_bank(torch_fsk.VARIANTS),
                              PipelineMetaWriter, fixture_audio,
                              committed["chunks"])
    for v in range(torch_fsk.VARIANTS):
        assert (full[v], ev[v]) == smoke.bank_expected(committed, v), v


def test_channel_bank_equals_tracked_bank(committed, fixture_audio):
    """The plain ChannelBank over FskPipeline with make_decoder() per
    channel gives the tracked bank's bytes and events, flush included."""
    pick = [torch_fsk.D_CALL, torch_fsk.D_TWO_CALLS, torch_fsk.D_BAD_HEADER,
            torch_fsk.D_FLUSH]
    pipe = FskPipeline(4, "dstar", n_centuries=BANK.n_centuries,
                       device="cpu")
    bank = ChannelBank(pipe, [make_decoder() for _ in pick], device="cpu")
    got = torch_bank.run(bank, PipelineMetaWriter, fixture_audio[pick],
                         committed["chunks"])
    assert got == tuple(map(list, zip(*(smoke.bank_expected(committed, v)
                                        for v in pick))))


def _pending_header(bank) -> bool:
    return any(ch.tracker is None and not ch.hunt.hunting
               for ch in bank.chans)


def test_fixture_pushes_end_on_a_pending_header(committed, fixture_audio):
    """Some push of the fixture ends while a header decode is pending (the
    hunt holds its exact position): where chip_smoke.py snapshots it."""
    bank = _port_bank(torch_fsk.VARIANTS)
    bank.on_output = None
    pending, lo = [], 0
    for i, n in enumerate(committed["chunks"]):
        bank.push(fixture_audio[:, lo:lo + n])
        lo += n
        if _pending_header(bank):
            pending.append(i)
    assert pending


@pytest.mark.parametrize("where", ["mid_stream", "pending_header"])
def test_snapshot_restore(committed, fixture_audio, where):
    """A snapshot taken between pushes, mid-stream or while a header
    decode is pending, restored into a fresh bank, gives the same
    remainder as the bank that went on; the D-Star machines pickle
    without the JAX package."""
    chunks = committed["chunks"]
    first = _port_bank(torch_fsk.VARIANTS)
    cut, lo = len(chunks) // 2, 0
    for i, n in enumerate(chunks):
        torch_bank.run(first, PipelineMetaWriter, fixture_audio[:, lo:lo + n],
                       [n], flush=False)
        lo += n
        if where == "mid_stream" and i + 1 == cut:
            break
        if where == "pending_header" and _pending_header(first):
            cut = i + 1
            break
    blob = first.snapshot()
    assert b"digiham_tpu_torch.protocols.dstar" in pickle.loads(blob)["chans"]
    assert b"digiham_tpu.protocols" not in pickle.loads(blob)["chans"]
    rest = fixture_audio[:, lo:]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[cut:])
    second = _port_bank(torch_fsk.VARIANTS)
    second.restore(blob)
    assert isinstance(second.state, FskPipelineState)
    assert second.state.rrc is None
    got = torch_bank.run(second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want and any(want[0])


# --- small streams against the JAX package --------------------------------

def _streams(seed):
    """The bit streams and push size of tests/test_tracked_bank_dstar.py."""
    if seed == "noise":
        return np.random.default_rng(7).integers(0, 2, (2, 20000)).astype(
            np.uint8), 977
    if seed == "half_terminator":
        parts = full_voice_stream(6) + [np.concatenate([
            np.unpackbits(np.frombuffer(b"\x55" * 9, np.uint8),
                          bitorder="little"), TERMINATOR[24:]]),
            np.ones(300, np.uint8)]
        return np.stack([np.concatenate(parts).astype(np.uint8)] * 2), 700
    return make_streams(seed), 700


SEEDS = list(range(6)) + ["noise", "half_terminator"]


@pytest.mark.parametrize("seed", SEEDS)
def test_make_decoder_matches_jax(seed):
    """The bit-domain decoder on the streams of
    tests/test_tracked_bank_dstar.py: the JAX package's bytes and events,
    and in 97-bit pieces the same as in one piece."""
    streams, _ = _streams(seed)
    got = torch_bank.reference_path(make_decoder, PipelineMetaWriter,
                                    streams)
    assert got == torch_bank.reference_path(j_make_decoder, JWriter, streams)
    dec = make_decoder()
    pieces = b"".join(dec.process(streams[0][i:i + 97])
                      for i in range(0, streams.shape[1], 97))
    assert pieces == got[0][0]
    if seed not in ("noise",):
        assert any(got[0])


def _gate(bits):
    return {"sync_dist_header_sync": bit_sync_correlate(bits, HEADER_SYNC),
            "sync_dist_voice_sync": bit_sync_correlate(bits, VOICE_SYNC)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_push_dibits_matches_jax_bank(seed, gated):
    """The bank's fields path, with and without device-gated hunting,
    gives the JAX bank's bytes and events (and the decoder's)."""
    streams, chunk = _streams(seed)
    got = torch_bank.push_dibits(
        _port_bank(streams.shape[0], 2), PipelineMetaWriter, streams, chunk,
        _gate if gated else None)
    assert got == torch_bank.push_dibits(
        _jax_bank(streams.shape[0], 2), JWriter, streams, chunk)
    assert got == tuple(torch_bank.reference_path(
        make_decoder, PipelineMetaWriter, streams))


def _small_audio(seed, channels=4):
    """FM audio [C, n] of make_streams traffic, noise seeds screened
    knife-edge free, and uneven push chunks."""
    tx = make_streams(seed, channels)
    n_sym = tx.shape[1]
    fx = {"tx_dibits": tx, "idle": np.zeros(len(tx), bool),
          "chunks": torch_bank.chunks((n_sym - 2) * BANK.sps, seed, lo=100,
                                      hi=9000)}
    fx["noise_seeds"] = torch_bank.screened_seeds(BANK, None, fx, 100 * seed,
                                                  mode="fsk")
    return smoke.bank_audio(BANK, fx), fx["chunks"]


def test_tracked_bank_audio_matches_jax():
    """Audio in uneven chunks, then flush: the JAX bank's bytes and events
    at 2 centuries on every channel."""
    samples, chunks = _small_audio(20)
    want = torch_bank.run(_jax_bank(len(samples), 2), JWriter, samples,
                          chunks)
    got = torch_bank.run(_port_bank(len(samples), 2), PipelineMetaWriter,
                         samples, chunks)
    assert got == want and any(want[0])


def test_convert_handoff_from_jax_snapshot():
    """What crosses from a JAX FSK bank's snapshot is its pipeline state
    (3 leaves: no RRC) and pending samples, never its host machines: a
    port bank with fresh machines, handed them, gives what a JAX bank with
    fresh machines handed the same gives."""
    samples, chunks = _small_audio(30)
    cut = len(chunks) // 2
    j_first = _jax_bank(len(samples), 2)
    torch_bank.run(j_first, JWriter, samples, chunks[:cut], flush=False)
    payload = pickle.loads(j_first.snapshot())
    rest = samples[:, int(chunks[:cut].sum()):]
    j_second, p_second = _jax_bank(len(samples), 2), _port_bank(len(samples),
                                                                 2)
    j_second.state = j_load_state(payload["pipeline_state"])
    p_second.state = convert.from_jax_checkpoint(payload["pipeline_state"],
                                                 device="cpu")
    assert isinstance(p_second.state, FskPipelineState)
    assert p_second.state.rrc is None
    for bank in (j_second, p_second):
        bank.samples.push(payload["samples"])
        bank.samples.consumed = 1
    want = torch_bank.run(j_second, JWriter, rest, chunks[cut:])
    assert torch_bank.run(p_second, PipelineMetaWriter, rest,
                          chunks[cut:]) == want
    assert any(want[0])


def test_no_card_raises():
    """``device=None`` is the card: without one the D-Star pipeline and
    bank raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FskPipeline(2, "dstar")
    pipe = FskPipeline(2, "dstar", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackedChannelBank(pipe, adapter=DstarAdapter())


if __name__ == "__main__":
    fx = build_fixture()
    BANK.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BANK.fixture, **fx)
    print(f"wrote {BANK.fixture} (noise seeds {fx['noise_seeds'].tolist()}, "
          f"chunks {fx['chunks'].tolist()})")
