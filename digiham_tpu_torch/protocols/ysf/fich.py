"""YSF Frame Information CHannel (src/ysf_decoder/fich.cpp).

Pipeline: 5x20 dibit de-interleave -> rate-1/2 Viterbi -> 4x Golay(24,12)
-> reassemble 32-bit FICH + 16-bit checksum -> CRC-16 over the big-endian
byte order of the FICH word.

Copy of ``digiham_tpu/protocols/ysf/fich.py``.
"""
from __future__ import annotations

import numpy as np

from ...fec import interleave
from ...fec.codes import GOLAY_24_12
from ...fec.crc import bytes_to_bits_msb
from ...fec.linear import decode_np
from .primitives import bits_to_bytes, crc16_ok, trellis_decode

# frame types (src/ysf_decoder/fich.hpp:3-6)
FRAME_TYPE_HEADER_CHANNEL = 0
FRAME_TYPE_COMMUNICATION_CHANNEL = 1
FRAME_TYPE_TERMINATOR_CHANNEL = 2
FRAME_TYPE_TEST_CHANNEL = 3

# data types (fich.hpp:8-11)
DATA_TYPE_VD_TYPE_1 = 0
DATA_TYPE_DATA_FR = 1
DATA_TYPE_VD_TYPE_2 = 2
DATA_TYPE_VOICE_FR = 3


class Fich:
    def __init__(self, data: int):
        self.data = data

    @staticmethod
    def parse(dibits: np.ndarray) -> "Fich | None":
        """dibits: the 100-dibit FICH section of a frame."""
        x = np.asarray(dibits[:100], np.uint8)[interleave.ysf_fich()]
        bits, _ = trellis_decode(x)
        by = bits_to_bytes(bits)  # 13 bytes (100 bits)
        golay_words = [
            (by[i * 3] << 16) | (by[i * 3 + 1] << 8) | by[i * 3 + 2]
            for i in range(4)
        ]
        corrected = []
        for w in golay_words:
            c, ok = decode_np(GOLAY_24_12, w)
            if not bool(ok):
                return None
            corrected.append(int(c))
        g = corrected
        fich_data = (
            ((g[0] & 0x00FFF000) << 8)
            | ((g[1] & 0x00FFF000) >> 4)
            | ((g[2] & 0x00FF0000) >> 16)
        )
        checksum = (g[2] & 0x0000F000) | ((g[3] & 0x00FFF000) >> 12)
        be_bytes = fich_data.to_bytes(4, "big")
        if not crc16_ok(bytes_to_bits_msb(np.frombuffer(be_bytes, np.uint8)),
                        checksum):
            return None
        return Fich(fich_data)

    def frame_type(self) -> int:
        return (self.data >> 30) & 0b11

    def data_type(self) -> int:
        return (self.data >> 8) & 0b11

    def frame_number(self) -> int:
        return (self.data >> 19) & 0b111


def encode_fich(fich_data: int) -> np.ndarray:
    """TX/test inverse of Fich.parse: -> 100 interleaved dibits."""
    from ...fec.crc import crc16_ysf
    from ...fec.viterbi import conv_encode

    be_bytes = np.frombuffer((fich_data & 0xFFFFFFFF).to_bytes(4, "big"),
                             np.uint8)
    checksum = int(crc16_ysf(32).compute_np(bytes_to_bits_msb(be_bytes)))
    g_data = [
        (fich_data >> 20) & 0xFFF,
        (fich_data >> 8) & 0xFFF,
        ((fich_data & 0xFF) << 4) | ((checksum >> 12) & 0xF),
        checksum & 0xFFF,
    ]
    words = [int(GOLAY_24_12.encode(d)) for d in g_data]
    bits = np.zeros(100, np.uint8)
    pos = 0
    for w in words:
        for i in range(23, -1, -1):
            bits[pos] = (w >> i) & 1
            pos += 1
    # leave the last 4 bits zero (100 = 96 + 4 pad)
    dibits = conv_encode(bits.astype(np.int64)).astype(np.uint8)
    out = np.zeros(100, np.uint8)
    out[interleave.ysf_fich()] = dibits
    return out
