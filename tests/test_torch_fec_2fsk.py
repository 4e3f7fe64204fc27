"""The FEC pieces of the port's D-Star and POCSAG paths against the JAX
package's: BCH(31,21) (the syndrome table the port builds itself, the
tensor and numpy decodes on random words and on every 1- and 2-error word
and sampled 3-error words), ``crc16_dstar_bytes`` (the bit-serial CRC's
values, a byte at a time), the D-Star
scrambler keystream, the header de-interleave, ``encode_header`` and
``Header.parse_from_header`` on encoded and corrupted headers. All exact."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec import crc as j_crc
from digiham_tpu.fec import lfsr as j_lfsr
from digiham_tpu.fec.linear import decode as j_decode
from digiham_tpu.fec.linear import decode_np as j_decode_np
from digiham_tpu.protocols.dstar import header as j_header
from digiham_tpu_torch.fec import codes, crc, interleave, lfsr
from digiham_tpu_torch.fec.linear import decode, decode_np
from digiham_tpu_torch.protocols.dstar import header

torch.set_num_threads(1)

BCH, J_BCH = codes.BCH_31_21, j_codes.BCH_31_21


def test_bch_syndrome_table_is_the_ports_own_and_equal():
    """1,024 syndromes, every 0-, 1- and 2-bit pattern placed (31 + 465 +
    1 = 497 entries), built by the port's BlockCode; equal to JAX's."""
    ours, ref = BCH.syndrome_table, J_BCH.syndrome_table
    assert ours.shape == (1024,) and ours.dtype == ref.dtype
    assert np.array_equal(ours, ref)
    assert (ours >= 0).sum() == 1 + 31 + 31 * 30 // 2
    assert BCH.correct_bits == 2 and (BCH.n, BCH.k) == (31, 21)
    assert torch.equal(BCH.table("cpu"), torch.from_numpy(ours).to(
        BCH.table("cpu").dtype))


def _both_ways(words: np.ndarray):
    """Tensor and numpy decodes of both packages; all four must agree."""
    got, ok = decode(BCH, torch.from_numpy(words))
    j_got, j_ok = j_decode(J_BCH, jnp.asarray(words))
    n_got, n_ok = decode_np(BCH, words)
    jn_got, jn_ok = j_decode_np(J_BCH, words)
    assert got.dtype == torch.int32 and np.asarray(j_got).dtype == np.int32
    for a, b in ((got.numpy(), np.asarray(j_got)), (n_got, jn_got),
                 (got.numpy(), n_got)):
        assert np.array_equal(a, b)
    for a, b in ((ok.numpy(), np.asarray(j_ok)), (n_ok, jn_ok),
                 (ok.numpy(), n_ok)):
        assert np.array_equal(a, b)
    return got.numpy(), ok.numpy()


@pytest.mark.parametrize("errors", [0, 1, 2, 3, "random"])
def test_bch_decode_matches_jax(errors):
    """Codewords with 0, 1 (every position), 2 (every pair) or 3 (sampled)
    bit errors, and random 31-bit words: the port's and JAX's decodes
    agree, and up to 2 errors are corrected."""
    rng = np.random.default_rng(31 + (errors if errors != "random" else 9))
    data = rng.integers(0, 1 << 21, 8)
    clean = BCH.encode(data)
    assert np.array_equal(clean, J_BCH.encode(data))
    if errors == "random":
        words = rng.integers(0, 1 << 31, (64, 16)).astype(np.int32)
        _both_ways(words)
        return
    if errors == 3:
        patterns = [sum(1 << int(b) for b in rng.choice(31, 3, replace=False))
                    for _ in range(200)]
    else:
        patterns = [sum(1 << b for b in c)
                    for c in itertools.combinations(range(31), errors)]
    words = (clean[:, None] ^ np.asarray(patterns)[None, :]).astype(np.int32)
    got, ok = _both_ways(words)
    if errors <= 2:
        assert ok.all() and (got == clean[:, None]).all()
    else:  # beyond the code's radius: never the sent word, flagged or not
        assert not ((got == clean[:, None]) & ok).any()


@pytest.mark.parametrize("nbits", [24, 312, 328])
def test_crc16_dstar_matches_jax(nbits):
    """The port's D-Star CRC over each message's bytes equals the JAX
    package's bit-serial CRC over its bits, least significant first: on
    random messages, all zeros and all ones."""
    ref = j_crc.crc16_dstar(nbits)
    bits = np.random.default_rng(nbits).integers(0, 2, (6, 9, nbits)).astype(
        np.int32)
    bits[0, 0], bits[0, 1] = 0, 1
    want = ref.compute_np(bits)
    assert np.array_equal(want, np.asarray(ref.compute(jnp.asarray(bits))))
    data = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    got = np.array([[crc.crc16_dstar_bytes(m.tobytes()) for m in row]
                    for row in data])
    assert np.array_equal(got, want)


def test_crc16_dstar_check_value():
    """The reference's CRC over "123456789", LSB first: 0x906E (the
    X.25 check value)."""
    assert crc.crc16_dstar_bytes(b"123456789") == 0x906E


@pytest.mark.parametrize("nbytes", [0, 1, 9, 39, 41, 97, 300])
def test_crc16_dstar_bytes_equals_the_bit_serial_crc(nbytes):
    """The byte-at-a-time D-Star CRC the machines check headers and D-PRS
    lines with equals the JAX package's bit-serial one over the bytes'
    bits, least significant first, and reads 0x906E on "123456789"."""
    data = np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    want = int(j_crc.crc16_dstar(len(bits)).compute_np(bits))
    assert crc.crc16_dstar_bytes(data) == want
    assert crc.crc16_dstar_bytes(b"123456789") == 0x906E


@pytest.mark.parametrize("length", [24, 660, 4096])
def test_dstar_scrambler_matches_jax(length):
    ours, ref = lfsr.dstar_scrambler(length), j_lfsr.dstar_scrambler(length)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    if length > 254:  # a 7-bit maximal-length sequence: period 127
        assert np.array_equal(ours[127:254], ours[:127])


def test_dstar_header_interleave_is_a_permutation():
    idx = interleave.dstar_header()
    assert idx.shape == (660,) and sorted(idx.tolist()) == list(range(660))


def _header_bytes(rng):
    """39 header bytes: flags, then four space-padded callsign fields and a
    suffix, as tests/test_dstar.py builds them."""
    calls = [b"DB0ABC B", b"DB0ABC G", b"CQCQCQ  ",
             b"".join(bytes([65 + int(x)]) for x in rng.integers(0, 26, 6))
             + b"  ", b"ID51"]
    return bytes([0, 0, 0]) + b"".join(calls)


def test_encode_header_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        data = _header_bytes(rng)
        ours = header.encode_header(data)
        assert ours.dtype == np.uint8 and ours.shape == (660,)
        assert np.array_equal(ours, j_header.encode_header(data))


@pytest.mark.parametrize("flips", [0, 1, 3, 8, 20, 60])
def test_parse_from_header_matches_jax(flips):
    """Encoded headers with ``flips`` on-air bit errors (the 4-state
    Viterbi corrects the few, the metric gate or the CRC rejects the
    many): the port's header, or None, is the JAX package's, field for
    field."""
    rng = np.random.default_rng(100 + flips)
    parsed = 0
    for _ in range(6):
        data = _header_bytes(rng)
        bits = header.encode_header(data).copy()
        bits[rng.choice(660, flips, replace=False)] ^= 1
        ours = header.Header.parse_from_header(bits)
        ref = j_header.Header.parse_from_header(bits)
        assert (ours is None) == (ref is None)
        if ours is None:
            continue
        parsed += 1
        assert ours.data == ref.data and ours.data[:39] == data
        for field in ("is_voice", "is_data", "destination_repeater",
                      "departure_repeater", "companion", "own_callsign"):
            assert getattr(ours, field)() == getattr(ref, field)(), field
    if flips <= 3:
        assert parsed == 6
    if flips >= 60:
        assert parsed == 0
