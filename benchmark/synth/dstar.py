"""D-Star DV voice transmissions (JARL's D-STAR system specification):
the 64-bit bit-sync preamble, the 15-bit frame sync and the 660-bit radio
header (flags, RPT1, RPT2, YOUR, MY and its suffix, the CRC, the K=3
convolutional code, the 24 x 28 interleave and the scrambler), then 96-bit
voice frames of 72 AMBE bits and 24 bits of slow data, a voice sync in the
data section of every 21st frame, the slow data scrambled frame by frame,
and last the terminator. Bits, sent at ``LEVELS`` (0 low, 1 high) at
4,800 bit/s.

A call's kind by its variant (``assumed``: no published share of call
kinds is in the repository): half the calls (variants 0 and 1) carry a
20-character text message in the first superframe's slow data, the
header again (mini header 0x5) in the second, and filler after; a quarter
(variant 2) carry GPS in slow data (mini header 0x3): a ``$$CRC`` D-PRS
position report, a ``$GPGGA`` and a ``$GPRMC`` sentence of the seed's
coordinates, over and over; a quarter (variant 3) are late entries with no
radio header: the call starts at a voice sync, and the slow data carries
the header and a message in turns."""
import numpy as np

from ..reference.dstar.header import encode_header
from ..reference.dstar.phases import HEADER_SYNC, TERMINATOR, VOICE_SYNC
from ..reference.fec.dstar_crc import crc16_dstar_bytes
from ..reference.fec.lfsr import dstar_scrambler

SYMBOL_RATE = 4800
LEVELS = [-1.0, +1.0]  # bit 0 low, bit 1 high, as fsk_demodulator slices
FRAME_BITS = 96
SUPERFRAME = 20  # data frames between two voice syncs
# 64 bits of 1010..., whose last 9 are the first 9 of HEADER_SYNC, then
# the 15-bit frame sync
PREAMBLE = np.tile(np.array([1, 0], np.uint8), 32)
FRAME_SYNC = HEADER_SYNC[9:]
FILLER = b"\x66\x66\x66"  # mini header 0x6: no data
YOUR = "CQCQCQ  "
REPEATER = "DIRECT  "  # RPT1 and RPT2 of a simplex call
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _lsb_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8),
                         bitorder="little")


def _letters(rng, lo: int, hi: int) -> str:
    """``lo`` to ``hi`` letters of the seed."""
    n = int(rng.integers(lo, hi + 1))
    return "".join(LETTERS[int(i)] for i in rng.integers(0, 26, n))


def _callsign(rng) -> str:
    """A callsign of the seed: a prefix of one or two letters, a digit, a
    suffix of one to three letters."""
    return (_letters(rng, 1, 2) + str(int(rng.integers(0, 10)))
            + _letters(rng, 1, 3))


def header_bytes(own: str, suffix: str) -> bytes:
    """The 39 bytes of a voice header: flags 0x00, RPT2 and RPT1 DIRECT,
    YOUR ``CQCQCQ``, MY and its suffix."""
    data = bytearray(39)
    data[3:11] = REPEATER.encode()
    data[11:19] = REPEATER.encode()
    data[19:27] = YOUR.encode()
    data[27:35] = own.ljust(8).encode()[:8]
    data[35:39] = suffix.ljust(4).encode()[:4]
    return bytes(data)


def _with_crc(data39: bytes) -> bytes:
    """The 41 bytes of a header with its CRC, as slow data carries it."""
    crc = crc16_dstar_bytes(data39)
    return data39 + bytes([crc & 0xFF, crc >> 8])


def _blocks(mini: int, payload: bytes) -> list:
    """``payload`` as slow-data blocks of up to 5 bytes under mini header
    ``mini`` (its low nibble the block's index for a message, its length
    otherwise): each block the 6 bytes of two data frames."""
    out = []
    for i in range(0, len(payload), 5):
        piece = payload[i:i + 5]
        low = i // 5 if mini == 0x4 else len(piece)
        out.append(bytes([mini << 4 | low]) + piece.ljust(5, b"\x66"))
    return out


def _message_blocks(text: bytes) -> list:
    return _blocks(0x4, text[:20].ljust(20))


def _gps_lines(rng, call: str) -> bytes:
    """A D-PRS report and a GGA and an RMC sentence of a position of the
    seed, each line ended by a carriage return."""
    lat, lon = rng.uniform(-80, 80), rng.uniform(-180, 180)
    ns, ew = "N" if lat >= 0 else "S", "E" if lon >= 0 else "W"
    lat, lon = abs(lat), abs(lon)
    nmea_lat = f"{int(lat):02d}{(lat - int(lat)) * 60:07.4f}"
    nmea_lon = f"{int(lon):03d}{(lon - int(lon)) * 60:07.4f}"
    aprs = (f"{call}>API705,DSTAR*:!{nmea_lat[:7]}{ns}/{nmea_lon[:8]}{ew}>"
            f"\r").encode()
    crc = crc16_dstar_bytes(aprs)
    lines = [b"$$CRC%04X," % crc + aprs]
    for body in (f"GPGGA,120000.00,{nmea_lat},{ns},{nmea_lon},{ew},1,08,"
                 f"0.9,100.0,M,46.9,M,,",
                 f"GPRMC,120000.00,A,{nmea_lat},{ns},{nmea_lon},{ew},0.0,"
                 f"0.0,010126,,,A"):
        check = 0
        for ch in body:
            check ^= ord(ch)
        lines.append(f"${body}*{check:02X}\r\n".encode())
    return b"".join(lines)


def _superframes(variant: int, rng, header41: bytes, n: int) -> list:
    """The slow-data blocks of ``n`` superframes, at most 10 a
    superframe (20 data frames)."""
    message = _message_blocks(f"{_callsign(rng)} via D-STAR".encode()
                              .ljust(20))
    header = _blocks(0x5, header41)
    if variant == 2:
        gps = _blocks(0x3, _gps_lines(rng, header41[27:35].decode().strip()))
        flat = [gps[i % len(gps)] for i in range(10 * n)]
        return [flat[10 * k:10 * k + 10] for k in range(n)]
    if variant == 3:
        return [header if k % 2 == 0 else message for k in range(n)]
    return [message if k == 0 else header if k == 1 else []
            for k in range(n)]


def _voice(rng, n: int, superframes: list) -> list:
    """``n`` voice frames from a voice sync on: random AMBE bits, the
    slow data of the superframes, scrambled frame by frame."""
    key = dstar_scrambler()[:24]
    frames, fc, k = [], SUPERFRAME, -1
    for _ in range(n):
        voice = _lsb_bits(rng.integers(0, 256, 9, dtype=np.uint8).tobytes())
        if fc >= SUPERFRAME:
            frames.append(np.concatenate([voice, VOICE_SYNC]))
            fc, k = 0, k + 1
            continue
        blocks = superframes[k] if k < len(superframes) else []
        block = blocks[fc // 2] if fc // 2 < len(blocks) else FILLER * 2
        data = block[3 * (fc % 2):3 * (fc % 2) + 3]
        frames.append(np.concatenate([voice, _lsb_bits(data) ^ key]))
        fc += 1
    return frames


def call(rng, seconds: float, variant: int = 0) -> np.ndarray:
    """About ``seconds`` of air of a call of kind ``variant``: its bits."""
    variant %= 4
    own = _callsign(rng)
    data39 = header_bytes(own, _letters(rng, 0, 4))
    bits = int(round(seconds * SYMBOL_RATE))
    parts = []
    if variant != 3:
        parts = [PREAMBLE, FRAME_SYNC, encode_header(data39)]
    head = sum(len(p) for p in parts)
    n = max(2, (bits - head) // FRAME_BITS - 1)
    frames = _voice(rng, n, _superframes(variant, rng, _with_crc(data39),
                                         n // (SUPERFRAME + 1) + 1))
    last = _lsb_bits(rng.integers(0, 256, 9, dtype=np.uint8).tobytes())
    frames.append(np.concatenate([last, TERMINATOR]))
    return np.concatenate(parts + frames).astype(np.uint8)
