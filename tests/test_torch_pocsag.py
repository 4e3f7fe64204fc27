"""The port's POCSAG decoder and tensor functions against the JAX
package's: ``make_decoder()`` on tests/torch_fsk.py's eight roles (alpha
pages, a numeric page, idle codewords, a lost and found sync, bit errors,
noise, a late start, pages cut by the stream's end), chunked equal to
one-shot; the numeric (BCD) path behind widened function bits, and closed
by default; ``sync_distances``, ``parse_codewords`` on words with bit 31
set (int64 holding JAX's uint32; parity by popcount, never a sign bit) and
``pocsag_decode_frames``. Bytes and fields are exact."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.pipeline.fsk import pocsag_decode_frames as j_decode_frames
from digiham_tpu.protocols import pocsag as j_pocsag
from digiham_tpu_torch import smoke
from digiham_tpu_torch.pipeline import pocsag_decode_frames
from digiham_tpu_torch.pipeline.fsk import FskTables
from digiham_tpu_torch.protocols import pocsag

sys.path.insert(0, os.path.dirname(__file__))
import torch_fsk  # noqa: E402
from test_pocsag import (IDLE_CODEWORD, address_codeword,  # noqa: E402
                         build_stream, data_codeword, numeric_payloads,
                         u32_bits)

torch.set_num_threads(1)

N_BITS = 6000


def _decode(module, bits, piece=None):
    dec = module.make_decoder()
    step = piece or len(bits)
    return b"".join(dec.process(bits[i:i + step])
                    for i in range(0, len(bits), step))


@pytest.mark.parametrize("variant", range(torch_fsk.VARIANTS))
def test_make_decoder_matches_jax(variant):
    """Every role, with the fixtures' widened function bits: the JAX
    decoder's bytes; in 57- and 1,000-bit pieces the same as in one."""
    bits = torch_fsk.pocsag_variant(variant, N_BITS)
    with smoke.function_bits(
            {"open_function_bits": torch_fsk.OPEN_FUNCTION_BITS}, j_pocsag):
        want = _decode(j_pocsag, bits)
        got = _decode(pocsag, bits)
        assert got == want
        for piece in (57, 1000):
            assert _decode(pocsag, bits, piece) == got
    if variant != torch_fsk.P_IDLE:
        assert b"message:" in got


def test_numeric_path_opens_only_when_widened():
    """Function bits 0 (numeric): no message by default, as in the
    reference; with the type opened, the BCD path's digits and specials,
    in both packages alike."""
    digits = "0123456789*U -)("
    cws = [address_codeword(321, 0)]
    cws += [data_codeword(p) for p in numeric_payloads(digits)]
    cws.append(IDLE_CODEWORD)
    bits = build_stream(cws).astype(np.uint8)
    assert pocsag.OPEN_FUNCTION_BITS == (1, 3)
    closed = _decode(pocsag, bits)
    assert closed == _decode(j_pocsag, bits) and b"message:" not in closed
    with smoke.function_bits({"open_function_bits": np.array([0, 1, 3])},
                             j_pocsag):
        assert pocsag.OPEN_FUNCTION_BITS == j_pocsag.OPEN_FUNCTION_BITS \
            == (0, 1, 3)
        opened = _decode(pocsag, bits)
        assert opened == _decode(j_pocsag, bits)
    assert pocsag.OPEN_FUNCTION_BITS == j_pocsag.OPEN_FUNCTION_BITS == (1, 3)
    assert b"address:2568" in opened
    assert f"message:{digits}".encode() in opened


def test_sync_distances_match_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 700)).astype(np.uint8)
    bits[0, 100:132] = pocsag.SYNC_PATTERN
    bits[1, 300:332] = pocsag.SYNC_PATTERN ^ (np.arange(32) % 11 == 0)
    got = pocsag.sync_distances(torch.from_numpy(bits))
    want = np.asarray(j_pocsag.sync_distances(jnp.asarray(bits)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert want[0, 100] == 0 and want[1, 300] == 3
    table = torch.as_tensor(pocsag.SYNC_PATTERN)
    assert torch.equal(pocsag.sync_distances(torch.from_numpy(bits), table),
                       got)


def _words(rng, n):
    """Codewords (half of them with bit 31 set: address/data flag 1),
    1-3 bit errors in a third, random words in another third."""
    info = rng.integers(0, 1 << 21, n)
    words = np.array([address_codeword(int(i) >> 3, int(i) & 3) if k % 2 == 0
                      else data_codeword(int(i) & 0xFFFFF)
                      for k, i in enumerate(info)], np.int64)
    for k in range(0, n, 3):
        for b in rng.choice(32, 1 + k % 3, replace=False):
            words[k] ^= 1 << int(b)
    words[1::3] = rng.integers(0, 1 << 32, len(words[1::3]))
    return words


def test_parse_codewords_matches_jax():
    """int64 words in [0, 2**32), as the bank builds them, and the same
    bit patterns as int32 (negative where bit 31 is set): JAX's corrected
    words and flags."""
    words = _words(np.random.default_rng(5), 600)
    assert (words >> 31).any() and ((words >> 31) == 0).any()
    j_full, j_ok = j_pocsag.parse_codewords(jnp.asarray(words, jnp.uint32))
    j_full, j_ok = np.asarray(j_full, np.int64), np.asarray(j_ok)
    for as_type in (np.int64, np.int32):
        full, ok = pocsag.parse_codewords(torch.from_numpy(
            words.astype(np.uint32).view(np.int32).astype(as_type)
            if as_type == np.int32 else words))
        assert full.dtype == torch.int64 and ok.dtype == torch.bool
        assert (full >= 0).all() and (full < 1 << 32).all()
        assert np.array_equal(full.numpy(), j_full)
        assert np.array_equal(ok.numpy(), j_ok)
    assert j_ok.any() and not j_ok.all()
    clean = np.array([data_codeword(0xFFFFF), address_codeword(0x3FFFF, 3)])
    full, ok = pocsag.parse_codewords(torch.from_numpy(clean))
    assert ok.all() and np.array_equal(full.numpy(), clean)
    # the host decode of one codeword's bits: the same word, or None
    host = [pocsag.parse_codeword_np(u32_bits(int(w))) for w in words[:90]]
    assert host == [j_pocsag.parse_codeword_np(u32_bits(int(w)))
                    for w in words[:90]]
    assert host == [int(f) if k else None
                    for f, k in zip(j_full[:90], j_ok[:90])]


@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64"])
def test_pocsag_decode_frames_matches_jax(dtype):
    """[B, 32] windows (codewords with bit 31 set, the sync word, random
    bits): the word as int64 holding JAX's uint32, the flag and the sync
    distance; [C, N, 32] batches alike."""
    rng = np.random.default_rng(9)
    words = _words(rng, 90)
    frames = np.stack([u32_bits(int(w)) for w in words])
    frames[::7] = pocsag.SYNC_PATTERN
    frames = frames.astype(dtype)
    want = {k: np.asarray(v) for k, v in
            j_decode_frames(jnp.asarray(frames)).items()}
    for tables in (None, FskTables.build("cpu")):
        got = {k: v.numpy() for k, v in pocsag_decode_frames(
            torch.from_numpy(frames), tables).items()}
        assert sorted(got) == sorted(want)
        assert got["word"].dtype == np.int64 and want["word"].dtype \
            == np.uint32
        assert np.array_equal(got["word"], want["word"].astype(np.int64))
        for k in ("ok", "sync_dist"):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert (want["sync_dist"][::7] == 0).all()
    batched = pocsag_decode_frames(torch.from_numpy(frames.reshape(3, 30,
                                                                   32)))
    assert np.array_equal(batched["word"].numpy().reshape(-1),
                          want["word"].astype(np.int64))
