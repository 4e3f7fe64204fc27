"""DMR frame sub-structures: CACH/TACT, EMB, SlotType, LC, collectors, GPS.

Host control-plane classes; every FEC decode delegates to the shared GF(2)
syndrome library (``fec``). A copy of
``digiham_tpu/protocols/dmr/components.py`` except
``EmbeddedCollector.get_lc``, which decodes through lookup tables built at
import (``_lc_tables``) in place of the bit-by-bit loop, and is held to the
JAX collector by
``tests/test_torch_dmr_host.py::test_embedded_lc_equals_jax``. Bit layouts
are protocol interoperability data from ETSI TS 102 361-1 as realized in the
reference (file:line cited per class).
"""
from __future__ import annotations

import numpy as np

from ...fec.codes import (
    GOLAY_20_8,
    HAMMING_7_4,
    HAMMING_16_11,
    QR_16_7,
)
from ...fec.linear import decode_np
from ...utils import Coordinate, convert_to_utf8
from .constants import TACT_POSITIONS

# LC opcodes (src/dmr_decoder/lc.hpp:5-11)
LC_OPCODE_GROUP = 0
LC_OPCODE_UNIT_TO_UNIT = 3
LC_TALKER_ALIAS_HDR = 4
LC_TALKER_ALIAS_BLK1 = 5
LC_TALKER_ALIAS_BLK2 = 6
LC_TALKER_ALIAS_BLK3 = 7
LC_GPS_INFO = 8

# EMB LCSS values (src/dmr_decoder/emb.hpp:4-8)
LCSS_SINGLE = 0
LCSS_START = 1
LCSS_STOP = 2
LCSS_CONTINUATION = 3

# SlotType data types, ETSI 9.3.6 (src/dmr_decoder/slottype.hpp:5-17)
DATA_TYPE_PI = 0
DATA_TYPE_VOICE_LC = 1
DATA_TYPE_TERMINATOR_LC = 2
DATA_TYPE_CSBK = 3
DATA_TYPE_MBC = 4
DATA_TYPE_MBC_CONTINUATION = 5
DATA_TYPE_DATA_HEADER = 6
DATA_TYPE_RATE_1_2_DATA = 7
DATA_TYPE_RATE_3_4_DATA = 8
DATA_TYPE_IDLE = 9
DATA_TYPE_RATE_1_DATA = 10
DATA_TYPE_UNIFIED_SINGLE_BLOCK_DATA = 11

# Talker alias data formats (src/dmr_decoder/talkeralias.hpp:5-8)
TALKER_ALIAS_FORMAT_7BIT = 0
TALKER_ALIAS_FORMAT_8BIT = 1
TALKER_ALIAS_FORMAT_UTF8 = 2
TALKER_ALIAS_FORMAT_UTF16 = 3

# CACH bit scattering per ETSI (src/dmr_decoder/cach.cpp:7-9)
PAYLOAD_POSITIONS = np.array(
    [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 15, 16, 17, 19, 20, 21, 23],
    dtype=np.int32,
)


class Tact:
    """TACT = Hamming(7,4): busy/slot/LCSS (src/dmr_decoder/tact.cpp:9-24)."""

    def __init__(self, data: int):
        self.data = data

    @staticmethod
    def parse(word7: int) -> "Tact | None":
        corrected, ok = decode_np(HAMMING_7_4, word7)
        return Tact(int(corrected)) if bool(ok) else None

    def is_busy(self) -> bool:
        return bool((self.data >> 6) & 1)

    def slot(self) -> int:
        return (self.data >> 5) & 1

    def lcss(self) -> int:
        return (self.data >> 3) & 3


class Cach:
    """CACH: 7 TACT bits + 17 payload bits scattered over 12 dibits
    (src/dmr_decoder/cach.cpp:11-32)."""

    def __init__(self, tact: Tact | None, payload: bytes):
        self.tact = tact
        self.payload = payload

    _TACT_WEIGHTS = (1 << np.arange(6, -1, -1)).astype(np.int64)
    _PAYLOAD_WEIGHTS = (1 << (np.arange(17) % 8)).astype(np.int64)

    @staticmethod
    def parse(dibits: np.ndarray) -> "Cach":
        bits = np.empty(24, dtype=np.int64)
        d = np.asarray(dibits[:12], dtype=np.int64)
        bits[0::2] = (d >> 1) & 1
        bits[1::2] = d & 1
        tact_word = int(bits[TACT_POSITIONS] @ Cach._TACT_WEIGHTS)
        pbits = bits[PAYLOAD_POSITIONS] * Cach._PAYLOAD_WEIGHTS
        payload = bytes([int(pbits[0:8].sum()), int(pbits[8:16].sum()),
                         int(pbits[16:].sum())])
        return Cach(Tact.parse(tact_word), payload)

    def has_tact(self) -> bool:
        return self.tact is not None


class Emb:
    """EMB: QR(16,7)-protected color code + LCSS
    (src/dmr_decoder/emb.cpp:9-24)."""

    def __init__(self, data: int):
        self.data = data

    @staticmethod
    def parse(word16: int) -> "Emb | None":
        corrected, ok = decode_np(QR_16_7, word16)
        return Emb(int(corrected)) if bool(ok) else None

    def color_code(self) -> int:
        return (self.data >> 12) & 0b1111

    def lcss(self) -> int:
        return (self.data >> 9) & 0b11


class SlotType:
    """SlotType: Golay(20,8)-protected color code + data type
    (src/dmr_decoder/slottype.cpp:9-21)."""

    def __init__(self, data: int):
        self.data = data

    @staticmethod
    def parse(word20: int) -> "SlotType | None":
        corrected, ok = decode_np(GOLAY_20_8, word20)
        return SlotType(int(corrected)) if bool(ok) else None

    def color_code(self) -> int:
        return (self.data >> 16) & 0b1111

    def data_type(self) -> int:
        return (self.data >> 12) & 0b1111


class Lc:
    """9-byte Link Control (src/dmr_decoder/lc.cpp:8-42). The voice-header
    RS(12,9) FEC is absent in the reference too (lc.cpp:8-11 TODO)."""

    def __init__(self, data: bytes):
        self.data = bytes(data[:9])

    @staticmethod
    def parse_from_voice_header(data: bytes) -> "Lc | None":
        return Lc(data)

    def opcode(self) -> int:
        return self.data[0] & 0b00111111

    def feature_set_id(self) -> int:
        return self.data[1]

    def source(self) -> int:
        return (self.data[6] << 16) | (self.data[7] << 8) | self.data[8]

    def target(self) -> int:
        return (self.data[3] << 16) | (self.data[4] << 8) | self.data[5]

    def payload(self) -> bytes:
        """Bytes 2..8 — alias block / GPS payload (lc.cpp:41-42)."""
        return self.data[2:9]


class EmbeddedCollector:
    """Reassembles 4x4-byte embedded LC fragments: 8x16 de-interleave,
    7 rows of Hamming(16,11), column parity, 5-bit mod-31 checksum
    (src/dmr_decoder/embedded.cpp:21-100)."""

    def __init__(self):
        self.data = bytearray(16)
        self.offset = 0

    def collect(self, fragment: bytes) -> None:
        if self.offset > 3:
            return
        self.data[self.offset * 4:self.offset * 4 + 4] = fragment[:4]
        self.offset += 1

    def reset(self) -> None:
        self.offset = 0

    def get_lc(self) -> Lc | None:
        if self.offset < 3:
            return None
        # column-ize: matrix row k bit 15-j = bit 7-k of byte j; row k sits
        # in bits 16k..16k+15 of one int (the tables' bits are disjoint, so
        # the sum ORs them)
        matrix = sum(map(list.__getitem__, _LC_DEINTERLEAVE, self.data))
        m = [_LC_HAMMING_16_11[(matrix >> shift) & 0xFFFF]
             for shift in range(0, 112, 16)]
        if -1 in m:
            return None
        if (m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4] ^ m[5] ^ m[6]
                ^ (matrix >> 112)):
            return None
        lc = bytes([
            (m[0] & 0b1111111100000000) >> 8,
            (m[0] & 0b0000000011100000) | ((m[1] & 0b1111100000000000) >> 11),
            ((m[1] & 0b0000011111100000) >> 3) | ((m[2] & 0b1100000000000000) >> 14),
            (m[2] & 0b0011111111000000) >> 6,
            (m[3] & 0b1111111100000000) >> 8,
            (m[3] & 0b0000000011000000) | ((m[4] & 0b1111110000000000) >> 10),
            ((m[4] & 0b0000001111000000) >> 2) | ((m[5] & 0b1111000000000000) >> 12),
            ((m[5] & 0b0000111111000000) >> 4) | ((m[6] & 0b1100000000000000) >> 14),
            (m[6] & 0b0011111111000000) >> 6,
        ])
        # checksum bit 4-i is bit 5 of row i+2
        received = (((m[2] & 0b100000) >> 1) | ((m[3] & 0b100000) >> 2)
                    | ((m[4] & 0b100000) >> 3) | ((m[5] & 0b100000) >> 4)
                    | ((m[6] & 0b100000) >> 5))
        if sum(lc) % 31 != received:
            return None
        return Lc(lc)


def _lc_tables() -> tuple[tuple[list, ...], list]:
    """The embedded LC's lookup tables, built once at import.

    ``deinterleave[j][b]``: byte j of value b spread over the matrix, bit
    7-k of b at bit 15-j of row k, row k in bits 16k..16k+15 of one int.
    ``hamming[w]``: Hamming(16,11)'s correction of the 16-bit word w, or
    -1 where its syndrome is not correctable (``decode_np``'s array path
    over every word)."""
    spread = [sum(((b >> (7 - k)) & 1) << (16 * k) for k in range(8))
              for b in range(256)]
    deinterleave = tuple([s << (15 - j) for s in spread] for j in range(16))
    corrected, ok = decode_np(HAMMING_16_11,
                              np.arange(1 << 16, dtype=np.int64))
    return deinterleave, np.where(ok, corrected, -1).tolist()


_LC_DEINTERLEAVE, _LC_HAMMING_16_11 = _lc_tables()


class TalkerAliasCollector:
    """Reassembles up to 4x7-byte alias blocks; 7-bit / 8-bit(ISO) / UTF-8 /
    UTF-16BE formats with progressive completeness
    (src/dmr_decoder/talkeralias.cpp:27-144)."""

    def __init__(self):
        self.data = bytearray(28)
        self.blocks = 0

    def reset(self) -> None:
        self.blocks = 0

    def set_block(self, block: int, data: bytes) -> None:
        assert block < 4
        self.data[block * 7:block * 7 + 7] = data[:7]
        self.blocks |= 1 << block

    def _has_header(self) -> bool:
        return bool(self.blocks & 1)

    def _data_format(self) -> int:
        return self.data[0] >> 6

    def _length(self) -> int:
        return (self.data[0] & 0b00111110) >> 1

    def _collected_bytes(self) -> int:
        i = 0
        while i < 4:
            mask = (1 << (i + 1)) - 1
            if (self.blocks & mask) != mask:
                break
            i += 1
        return i * 7

    @staticmethod
    def _convert_7bit(chunk: bytes) -> str:
        s = chunk
        res = bytes([
            (s[0] & 0b11111110) >> 1,
            ((s[0] & 1) << 6) | ((s[1] & 0b11111100) >> 2),
            ((s[1] & 0b11) << 5) | ((s[2] & 0b11111000) >> 3),
            ((s[2] & 0b111) << 4) | ((s[3] & 0b11110000) >> 4),
            ((s[3] & 0b1111) << 3) | ((s[4] & 0b11100000) >> 5),
            ((s[4] & 0b11111) << 2) | ((s[5] & 0b11000000) >> 6),
            ((s[5] & 0b111111) << 1) | ((s[6] & 0b10000000) >> 7),
            s[6] & 0b01111111,
        ])
        return res.decode("latin-1")

    def is_complete(self) -> bool:
        if not self._has_header():
            return False
        nbytes = self._collected_bytes()
        fmt = self._data_format()
        if fmt == TALKER_ALIAS_FORMAT_7BIT:
            return (nbytes * 7) // 8 - 1 >= self._length()
        if fmt == TALKER_ALIAS_FORMAT_8BIT:
            return nbytes - 1 >= self._length()
        if fmt == TALKER_ALIAS_FORMAT_UTF8:
            # reference compares std::string BYTE length
            return len(self._contents_bytes()) >= self._length()
        if fmt == TALKER_ALIAS_FORMAT_UTF16:
            return (nbytes - 1) // 2 >= self._length()
        return False

    def _contents_bytes(self) -> bytes:
        """UTF-8 byte string before truncation (the reference works on
        std::string bytes throughout, talkeralias.cpp:62-117)."""
        nbytes = self._collected_bytes()
        fmt = self._data_format()
        if fmt == TALKER_ALIAS_FORMAT_7BIT:
            parts = [self._convert_7bit(bytes(self.data[i:i + 7]))
                     for i in range(0, nbytes, 7)]
            return "".join(parts)[1:].encode("utf-8")
        if fmt == TALKER_ALIAS_FORMAT_8BIT:
            return convert_to_utf8(bytes(self.data[1:nbytes])).encode("utf-8")
        if fmt == TALKER_ALIAS_FORMAT_UTF8:
            return bytes(self.data[1:nbytes])
        if fmt == TALKER_ALIAS_FORMAT_UTF16:
            chars = (nbytes - 1) // 2
            return bytes(self.data[1:1 + 2 * chars]).decode(
                "utf-16-be", errors="replace").encode("utf-8")
        return b""

    def get_contents(self) -> str:
        if not self._has_header():
            return ""
        raw = self._contents_bytes()
        # byte-wise substr like the reference — may split a multibyte
        # sequence; surrogateescape preserves those bytes through the
        # metadata path
        if len(raw) > self._length():
            raw = raw[:self._length()]
        return raw.decode("utf-8", errors="surrogateescape")


class Gps:
    """ETSI in-band GPS: sign-magnitude 24/25-bit lat/lon
    (src/dmr_decoder/gps.cpp:7-18)."""

    @staticmethod
    def parse(data: bytes) -> Coordinate:
        lat_bits = ((data[4] & 0b01111111) << 16) | (data[5] << 8) | data[6]
        if data[4] & 0b10000000:
            lat_bits = -lat_bits
        lon_bits = (data[1] << 16) | (data[2] << 8) | data[3]
        if data[0] & 0b00000001:
            lon_bits = -lon_bits
        return Coordinate(
            np.float32(180.0) / np.float32(1 << 24) * np.float32(lat_bits),
            np.float32(360.0) / np.float32(1 << 25) * np.float32(lon_bits),
        )
