"""The port's streaming POCSAG bank against the JAX package's:
``TrackedChannelBank`` with ``PocsagAdapter`` over ``FskPipeline`` (FM audio
in uneven chunks -> flush), its ``push_dibits`` with and without
device-gated hunting, the per-channel ``make_decoder()``, other baud rates
(sps 20, 40, 94), snapshot/restore, the hand-off of a JAX bank's snapshot
through ``convert.from_jax_checkpoint`` (an FSK state without an RRC: 3
leaves), and the committed fixture ``data/pocsag_bank_smoke.npz`` rebuilt
from tests/torch_fsk.py's variants plus the JAX bank. Message bytes must be
equal byte for byte (POCSAG has no metadata stream).

Sample streams carry noise whose seed is screened knife-edge free
(torch_parity.audio_knife_edge_free), so the two packages must agree
exactly. Rebuild the fixture with
``PYTHONPATH=.:tests python tests/test_torch_tracked_bank_pocsag.py``.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from digiham_tpu.pipeline import FskPipeline as JPipeline
from digiham_tpu.protocols import pocsag as j_pocsag
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.tracked_bank import PocsagAdapter as JAdapter
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.pipeline import FskPipeline, bit_sync_correlate
from digiham_tpu_torch.pipeline.fsk import FskPipelineState
from digiham_tpu_torch.protocols import pocsag
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.tracked_bank import (PocsagAdapter,
                                                    TrackedChannelBank)

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
import torch_fsk  # noqa: E402
from test_pocsag import (address_codeword, alpha_payloads,  # noqa: E402
                         build_stream, data_codeword)
from test_tracked_bank_pocsag import (make_streams,  # noqa: E402
                                      numeric_payloads)

torch.set_num_threads(1)

BANK = smoke.POCSAG_BANK
N_SAMPLES = 240_000  # 14 steps of 4 centuries at sps 40 and a tail
N_BITS = N_SAMPLES // BANK.sps + 2


def _jax_bank(C, nc=BANK.n_centuries, sps=BANK.sps):
    return JBank(JPipeline(channels=C, protocol="pocsag", n_centuries=nc,
                           sps=sps), adapter=JAdapter())


def _port_bank(C, nc=BANK.n_centuries, sps=BANK.sps):
    return TrackedChannelBank(
        FskPipeline(C, "pocsag", n_centuries=nc, sps=sps, device="cpu"),
        adapter=PocsagAdapter(), device="cpu")


def build_fixture(noise_seeds=None) -> dict:
    """The fixture from torch_fsk's variants and the JAX bank (see
    torch_bank), with the numeric type opened (smoke.function_bits)."""
    tx = np.stack([torch_fsk.pocsag_variant(v, N_BITS)
                   for v in range(torch_fsk.VARIANTS)])
    return torch_bank.build_fixture(
        BANK, None, tx, np.arange(torch_fsk.VARIANTS) == torch_fsk.P_IDLE,
        torch_bank.chunks(N_SAMPLES, 48), _jax_bank, noise_seeds,
        mode="fsk", invert=True,
        extra={"open_function_bits": torch_fsk.OPEN_FUNCTION_BITS})


@pytest.fixture(scope="module")
def committed():
    return smoke.load(BANK)


@pytest.fixture(scope="module")
def fixture_audio(committed):
    return smoke.bank_audio(BANK, committed)


@pytest.fixture
def numeric_open(committed):
    """The fixture's function bits in the port's decoder (and the JAX
    package's) while a test runs."""
    with smoke.function_bits(committed, j_pocsag):
        yield


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from torch_fsk and the
    JAX bank with its stored seeds, and its streams are knife-edge free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    assert np.array_equal(
        torch_bank.screened_seeds(BANK, None, committed, 9000, mode="fsk",
                                  invert=True),
        committed["noise_seeds"])
    assert j_pocsag.OPEN_FUNCTION_BITS == pocsag.OPEN_FUNCTION_BITS == (1, 3)


def test_fixture_is_a_stream_worth_checking(committed):
    """Messages on every paging variant, none on the idle channel; the
    numeric page (function bits 0) decodes through the BCD path; the
    messages after a lost sync and after a late start are there."""
    out = [smoke.bank_expected(committed, v)
           for v in range(torch_fsk.VARIANTS)]
    for v in range(torch_fsk.VARIANTS):
        assert out[v][1] == "", v  # no metadata stream
        if v != torch_fsk.P_IDLE:
            assert b"message:" in out[v][0], v
    assert out[torch_fsk.P_IDLE][0] == b""
    assert b"message:HELLO PORT" in out[torch_fsk.P_ALPHA][0]
    assert b"message:0123456789*U -)(" in out[torch_fsk.P_NUMERIC][0]
    assert b"message:AND TEXT" in out[torch_fsk.P_NUMERIC][0]
    assert (b"message:FIRST" in out[torch_fsk.P_IDLE_FLUSH][0]
            and b"message:SECOND" in out[torch_fsk.P_IDLE_FLUSH][0])
    assert b"message:AFTER RESYNC" in out[torch_fsk.P_RESYNC][0]
    assert b"message:HELLO PORT" in out[torch_fsk.P_LATE][0]


def test_port_bank_decodes_the_fixture(committed, fixture_audio,
                                       numeric_open):
    """The port's bank at the fixture's size (4 centuries at sps 40)
    leaves the fixture's tail to its flush, gives the JAX bank's bytes on
    every variant, and the flush variant emits bytes in ``flush`` itself
    (the per-symbol 2FSK oracle, inverted)."""
    bank = _port_bank(torch_fsk.VARIANTS)
    outs, _ = torch_bank.run(bank, PipelineMetaWriter, fixture_audio,
                             committed["chunks"], flush=False,
                             tail=BANK.flush_tail)
    before = len(outs[torch_fsk.P_FLUSH])
    bank.flush()
    assert len(outs[torch_fsk.P_FLUSH]) > before
    full, ev = torch_bank.run(_port_bank(torch_fsk.VARIANTS),
                              PipelineMetaWriter, fixture_audio,
                              committed["chunks"])
    for v in range(torch_fsk.VARIANTS):
        assert (full[v], ev[v]) == smoke.bank_expected(committed, v), v


def test_channel_bank_equals_tracked_bank(committed, fixture_audio,
                                          numeric_open):
    """The plain ChannelBank over FskPipeline with make_decoder() per
    channel gives the tracked bank's bytes, flush included."""
    pick = [torch_fsk.P_NUMERIC, torch_fsk.P_RESYNC, torch_fsk.P_LATE,
            torch_fsk.P_FLUSH]
    pipe = FskPipeline(4, "pocsag", n_centuries=BANK.n_centuries,
                       device="cpu")
    bank = ChannelBank(pipe, [pocsag.make_decoder() for _ in pick],
                       device="cpu")
    got = torch_bank.run(bank, PipelineMetaWriter, fixture_audio[pick],
                         committed["chunks"])
    assert got == tuple(map(list, zip(*(smoke.bank_expected(committed, v)
                                        for v in pick))))


def test_snapshot_restore_midstream(committed, fixture_audio, numeric_open):
    """A snapshot taken between pushes, restored into a fresh bank, gives
    the same remainder as the bank that went on; the POCSAG machines
    pickle without the JAX package."""
    samples, chunks = fixture_audio, committed["chunks"]
    cut = len(chunks) // 2
    first = _port_bank(torch_fsk.VARIANTS)
    torch_bank.run(first, PipelineMetaWriter, samples, chunks[:cut],
                   flush=False)
    blob = first.snapshot()
    chans = pickle.loads(blob)["chans"]
    assert b"digiham_tpu_torch.protocols.pocsag" in chans
    assert b"digiham_tpu.protocols" not in chans
    rest = samples[:, int(chunks[:cut].sum()):]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[cut:])
    second = _port_bank(torch_fsk.VARIANTS)
    second.restore(blob)
    assert isinstance(second.state, FskPipelineState)
    assert second.state.rrc is None
    got = torch_bank.run(second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want and any(want[0])


# --- small streams against the JAX package --------------------------------

def _numeric_stream():
    cws = [address_codeword(777, 1)]
    cws += [data_codeword(p) for p in numeric_payloads("0123456789")]
    return np.stack([build_stream(cws)] * 2).astype(np.uint8), 501


def _streams(seed):
    """The bit streams and push size of tests/test_tracked_bank_pocsag.py."""
    if seed == "noise":
        return np.random.default_rng(11).integers(0, 2, (2, 24000)).astype(
            np.uint8), 977
    if seed == "numeric":
        return _numeric_stream()
    return make_streams(seed), 501


SEEDS = list(range(6)) + ["noise", "numeric"]


@pytest.mark.parametrize("seed", SEEDS)
def test_make_decoder_matches_jax(seed):
    """The bit-domain decoder on the streams of
    tests/test_tracked_bank_pocsag.py (its numeric page has function bits
    1, which open a message that never prints, as in the reference): the
    JAX package's bytes, and in 57-bit pieces the same as in one piece."""
    streams, _ = _streams(seed)
    got = torch_bank.reference_path(pocsag.make_decoder, PipelineMetaWriter,
                                    streams)
    assert got == torch_bank.reference_path(j_pocsag.make_decoder, JWriter,
                                            streams)
    dec = pocsag.make_decoder()
    pieces = b"".join(dec.process(streams[0][i:i + 57])
                      for i in range(0, streams.shape[1], 57))
    assert pieces == got[0][0]
    if seed not in ("noise", "numeric"):  # function bits 1 print nothing
        assert any(got[0])


def _gate(bits):
    return {"sync_dist_preamble": bit_sync_correlate(bits,
                                                     pocsag.SYNC_PATTERN)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_push_dibits_matches_jax_bank(seed, gated):
    """The bank's fields path, with and without device-gated hunting,
    gives the JAX bank's bytes (and the decoder's)."""
    streams, chunk = _streams(seed)
    got = torch_bank.push_dibits(
        _port_bank(streams.shape[0], 2), PipelineMetaWriter, streams, chunk,
        _gate if gated else None)
    assert got == torch_bank.push_dibits(
        _jax_bank(streams.shape[0], 2), JWriter, streams, chunk)
    assert got == tuple(torch_bank.reference_path(
        pocsag.make_decoder, PipelineMetaWriter, streams))


@pytest.mark.parametrize("sps", [20, 40, 94])
def test_other_baud_rates_match_jax(sps):
    """2400, 1200 and 512 baud (the reference's --samples flag): pages in
    shaped 2FSK audio with noise, pushed in uneven chunks and flushed,
    give the JAX bank's bytes, and the message is there."""
    rate = dataclasses.replace(BANK, sps=sps)
    cws = [address_codeword(55, 3)]
    cws += [data_codeword(p) for p in alpha_payloads("RATE TEST")]
    tx = np.stack([np.concatenate([build_stream(cws),
                                   np.zeros(600, np.uint8)])] * 2)
    n = (tx.shape[1] - 2) * sps
    fx = {"tx_dibits": tx, "idle": np.zeros(2, bool),
          "chunks": torch_bank.chunks(n, sps, lo=100, hi=9000)}
    fx["noise_seeds"] = torch_bank.screened_seeds(rate, None, fx, 100 * sps,
                                                  mode="fsk", invert=True)
    samples = smoke.bank_audio(rate, fx)
    want = torch_bank.run(_jax_bank(2, 2, sps), JWriter, samples,
                          fx["chunks"])
    got = torch_bank.run(_port_bank(2, 2, sps), PipelineMetaWriter, samples,
                         fx["chunks"])
    assert got == want
    assert all(b"message:RATE TEST" in v for v in got[0])


def _small_audio(seed, channels=3):
    """FM audio [C, n] of make_streams traffic, noise seeds screened
    knife-edge free, and uneven push chunks."""
    tx = make_streams(seed, channels)
    n_sym = tx.shape[1]
    fx = {"tx_dibits": tx, "idle": np.zeros(len(tx), bool),
          "chunks": torch_bank.chunks((n_sym - 2) * BANK.sps, seed, lo=100,
                                      hi=20_000)}
    fx["noise_seeds"] = torch_bank.screened_seeds(BANK, None, fx, 100 * seed,
                                                  mode="fsk", invert=True)
    return smoke.bank_audio(BANK, fx), fx["chunks"]


def test_tracked_bank_audio_matches_jax():
    """Audio in uneven chunks, then flush: the JAX bank's bytes at 2
    centuries on every channel."""
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
    """``device=None`` is the card: without one the POCSAG pipeline and
    bank raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FskPipeline(2, "pocsag")
    pipe = FskPipeline(2, "pocsag", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackedChannelBank(pipe, adapter=PocsagAdapter())


if __name__ == "__main__":
    fx = build_fixture()
    BANK.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(BANK.fixture, **fx)
    print(f"wrote {BANK.fixture} (noise seeds {fx['noise_seeds'].tolist()}, "
          f"chunks {fx['chunks'].tolist()})")
