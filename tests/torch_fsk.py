"""The 2FSK stream variants of the port's D-Star and POCSAG tests
(tests/test_torch_{pipeline_fsk,tracked_bank_dstar,tracked_bank_pocsag}.py):
TX bits built with the test suite's own builders (tests/test_dstar.py,
tests/test_pocsag.py), one variant per role, padded with random bits to a
stream's length."""
import numpy as np

from digiham_tpu.fec.crc import crc16_dstar
from digiham_tpu.protocols.dstar.header import Header, encode_header
from digiham_tpu.protocols.dstar.phases import (HEADER_SYNC, TERMINATOR,
                                                VOICE_SYNC)
from test_dstar import bit_sync_preamble, make_header_bytes, scramble24
from test_pocsag import (IDLE_CODEWORD, address_codeword, alpha_payloads,
                         build_stream, data_codeword, numeric_payloads)

VARIANTS = 8

# --- D-Star ----------------------------------------------------------------
D_CALL, D_VSYNC, D_TWO_CALLS, D_HALF_TERM, D_ERRORS, D_IDLE, D_BAD_HEADER, \
    D_FLUSH = range(VARIANTS)
MESSAGE = b"DIGIHAM TORCH SMOKE!"  # 20 characters: four 0x4 blocks


def _lsb_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")


def _slow_data(message: bytes | None, dprs: bytes | None) -> dict:
    """Data frame count (0..19 of a superframe) -> its 3 slow-data bytes:
    a 20-character message (mini header 0x4) or a $$CRC D-PRS sentence
    (mini header 0x3), as tests/test_dstar.py builds them."""
    frames = {}
    if message is not None:
        for block in range(4):
            chunk = message[block * 5:block * 5 + 5]
            frames[2 * block] = bytes([0x40 | block]) + chunk[:2]
            frames[2 * block + 1] = chunk[2:5]
    if dprs is not None:
        bits = _lsb_bits(dprs)
        crc = int(crc16_dstar(len(bits)).compute_np(bits))
        sentence = b"$$CRC%04X," % crc + dprs
        pieces = [sentence[i:i + 5] for i in range(0, len(sentence), 5)]
        assert 2 * len(pieces) <= 20
        for i, piece in enumerate(pieces):
            frames[2 * i] = bytes([0x30 | len(piece)]) + piece[:2]
            frames[2 * i + 1] = (piece[2:] + b"\x00" * 3)[:3]
    return frames


def _voice_frames(rng, n, slow=None, first_due=True):
    """n voice frames with random voice bytes; a voice sync in the data
    section of every 21st (the first one at once after a header)."""
    slow = slow or {}
    fc = 20 if first_due else 0
    out = []
    for _ in range(n):
        voice = _lsb_bits(rng.integers(0, 256, 9).astype(np.uint8).tobytes())
        if fc >= 20:
            out.append(np.concatenate([voice, VOICE_SYNC]))
            fc = 0
        else:
            out.append(np.concatenate(
                [voice, scramble24(slow.get(fc, b"\x66\x66\x66"))]))
            fc += 1
    return out


def _header(own="W1AW", suffix="705", companion="CQCQCQ"):
    return [bit_sync_preamble(), HEADER_SYNC, encode_header(
        make_header_bytes(own=own, suffix=suffix, companion=companion))]


def _terminator(rng, half=False):
    voice = _lsb_bits(rng.integers(0, 256, 9).astype(np.uint8).tobytes())
    return np.concatenate([voice, TERMINATOR[24:] if half else TERMINATOR])


def dstar_variant(v: int, n_bits: int) -> np.ndarray:
    """One D-Star variant's TX bits [n_bits]: random lead-in bits, the
    variant's transmission, random bits to the end."""
    rng = np.random.default_rng(5000 + v)
    parts = [rng.integers(0, 2, 60 if v == D_FLUSH else 240)]
    if v in (D_CALL, D_ERRORS):  # a call with a slow-data message
        parts += _header() + _voice_frames(rng, 45, _slow_data(MESSAGE, None))
        parts.append(_terminator(rng))
    elif v == D_VSYNC:  # a voice-sync entry without a header
        parts += [bit_sync_preamble(), VOICE_SYNC]
        parts += _voice_frames(rng, 44, first_due=False)
    elif v == D_TWO_CALLS:  # full terminator, then a call with D-PRS data
        parts += _header() + _voice_frames(rng, 10) + [_terminator(rng)]
        parts.append(rng.integers(0, 2, 100))
        parts += _header("DL1XYZ", "", "DB0ABC") + _voice_frames(
            rng, 25, _slow_data(None, b"DL1XYZ>API705:!5007.50N/00807.50E"
                                      b">\r"))
        parts.append(_terminator(rng))
    elif v == D_HALF_TERM:
        parts += _header("N0CALL", "D") + _voice_frames(rng, 15)
        parts.append(_terminator(rng, half=True))
    elif v == D_BAD_HEADER:  # the header fails; a voice sync locks later
        bad = encode_header(make_header_bytes()).copy()
        bad[rng.choice(660, 60, replace=False)] ^= 1
        assert Header.parse_from_header(bad) is None
        parts += [bit_sync_preamble(), HEADER_SYNC, bad]
        parts += _voice_frames(rng, 50, first_due=False)
    elif v == D_FLUSH:  # a call that runs into the stream's end
        parts += _header("DK5EW", "T") + _voice_frames(
            rng, n_bits // 96, _slow_data(MESSAGE[::-1], None))
    tx = np.concatenate([np.asarray(p, np.uint8) for p in parts])[:n_bits]
    tx = np.concatenate([tx, rng.integers(0, 2, n_bits - len(tx))])
    if v == D_ERRORS:
        tx = tx ^ (rng.random(n_bits) < 0.005)
    return tx.astype(np.uint8)


# --- POCSAG ----------------------------------------------------------------
P_ALPHA, P_NUMERIC, P_IDLE_FLUSH, P_RESYNC, P_ERRORS, P_IDLE, P_LATE, \
    P_FLUSH = range(VARIANTS)
# the function bits the POCSAG fixtures open messages with: the numeric
# type 0 besides the reference's 1 and 3 (smoke.function_bits)
OPEN_FUNCTION_BITS = np.asarray([0, 1, 3], np.int64)


def _page(rng, address, text=None, digits=None):
    """An address codeword and its message's data codewords."""
    if digits is not None:
        return [address_codeword(address, 0)] + [
            data_codeword(p) for p in numeric_payloads(digits)]
    return [address_codeword(address, 3)] + [
        data_codeword(p) for p in alpha_payloads(text)]


def _text(rng, n=14):
    return "".join(chr(65 + int(x)) for x in rng.integers(0, 26, n))


def pocsag_variant(v: int, n_bits: int) -> np.ndarray:
    """One POCSAG variant's TX bits [n_bits]: random lead-in bits, the
    variant's batches, random bits to the end."""
    rng = np.random.default_rng(6000 + v)
    parts = [rng.integers(0, 2, 2500 if v == P_LATE else 120)]
    if v in (P_ALPHA, P_ERRORS, P_LATE):
        parts.append(build_stream(_page(rng, 1234, "HELLO PORT") + [
            IDLE_CODEWORD] + _page(rng, 98765, _text(rng))))
    elif v == P_NUMERIC:
        parts.append(build_stream(
            _page(rng, 321, digits="0123456789*U -)(")
            + _page(rng, 4321, "AND TEXT")))
    elif v == P_IDLE_FLUSH:  # an idle codeword closes each message
        parts.append(build_stream(
            _page(rng, 77, "FIRST") + [IDLE_CODEWORD, IDLE_CODEWORD]
            + _page(rng, 78, "SECOND") + [IDLE_CODEWORD]
            + _page(rng, 79, _text(rng, 20))))
    elif v == P_RESYNC:  # sync lost in random bits, then found again
        parts.append(build_stream(_page(rng, 555, "BEFORE LOSS")))
        parts.append(rng.integers(0, 2, 1800))
        parts.append(build_stream(_page(rng, 556, "AFTER RESYNC")))
    elif v == P_FLUSH:  # pages up to the stream's end
        cws = []
        while 32 * len(cws) < n_bits:
            cws += _page(rng, int(rng.integers(1, 1 << 18)), _text(rng, 30))
        parts.append(build_stream(cws, preamble_bits=64))
    tx = np.concatenate([np.asarray(p, np.uint8) for p in parts])[:n_bits]
    tx = np.concatenate([tx, rng.integers(0, 2, n_bits - len(tx))])
    if v == P_ERRORS:
        tx = tx ^ (rng.random(n_bits) < 0.01)
    return tx.astype(np.uint8)
