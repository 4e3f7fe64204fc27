"""NXDN frame sub-structures: LICH, SACCH (+superframe collector), FACCH1.

FEC path per channel unit: bit de-interleave -> de-puncture ("inflate") ->
16-state rate-1/2 Viterbi with blocked start states (4 known leading zeros)
-> CRC-6/CRC-12. All heavy steps delegate to the shared host
primitives (``fec.viterbi.viterbi_decode_np``, numpy, kept by its bytes
for one sequence; ``fec.crc``, ``fec.interleave``).

Copy of ``digiham_tpu/protocols/nxdn/components.py``.
"""
from __future__ import annotations

import numpy as np

from ..fec import interleave
from ..fec.crc import crc6_nxdn, crc12_nxdn
from ..fec.lfsr import nxdn_scrambler
from ..fec.viterbi import viterbi_decode_np

# LICH RF channel types (src/nxdn_decoder/lich.hpp:3-11)
RF_CHANNEL_TYPE_RCCH = 0b00
RF_CHANNEL_TYPE_RTCH = 0b01
RF_CHANNEL_TYPE_RDCH = 0b10
RF_CHANNEL_TYPE_RTCH_C = 0b11

# LICH functional types (lich.hpp:18-25)
USC_TYPE_SACCH_NON_SF = 0b00
USC_TYPE_UDCH = 0b01
USC_TYPE_SACCH_SF = 0b10
USC_TYPE_SACCH_SF_IDLE = 0b11

DIRECTION_OUTBOUND = 0
DIRECTION_INBOUND = 1

# message types (src/nxdn_decoder/types.hpp:1-3)
MESSAGE_TYPE_VCALL = 0x01
MESSAGE_TYPE_TX_RELEASE = 0x08
MESSAGE_TYPE_IDLE = 0x10

# call types (types.hpp:6-8)
CALL_TYPE_BROADCAST = 0b000
CALL_TYPE_CONFERENCE = 0b001
CALL_TYPE_INDIVIDUAL = 0b100


class Scrambler:
    """Per-frame keystream: 9-bit LFSR flipping the high bit of each dibit
    (src/nxdn_decoder/scrambler.cpp:12-25). Stateless here: the caller
    passes the in-frame offset; the keystream array is precomputed."""

    @staticmethod
    def descramble(dibits: np.ndarray, offset: int) -> np.ndarray:
        ks = nxdn_scrambler()[offset:offset + len(dibits)]
        return (np.asarray(dibits, np.uint8) & 3) ^ (ks << 1)


class Lich:
    """Link Information CHannel: 8 dibits, high bits carry 7 data bits + a
    parity bit over the top 4 (src/nxdn_decoder/lich.cpp:5-50)."""

    def __init__(self, data: int):
        self.data = data

    @staticmethod
    def parse(dibits8: np.ndarray) -> "Lich | None":
        bits = (np.asarray(dibits8[:8], np.uint8) >> 1) & 1
        if int(bits[7]) != int(bits[:4].sum()) % 2:
            return None
        byte = 0
        for i in range(7):
            byte |= int(bits[i]) << (6 - i)
        return Lich(byte)

    def rf_type(self) -> int:
        return (self.data >> 5) & 0b11

    def functional_type(self) -> int:
        return (self.data >> 3) & 0b11

    def option(self) -> int:
        return (self.data >> 1) & 0b11

    def direction(self) -> int:
        return self.data & 1


def _bits_from_dibits(dibits: np.ndarray) -> np.ndarray:
    d = np.asarray(dibits, np.uint8)
    out = np.empty(len(d) * 2, np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def _viterbi_nxdn(coded_bits: np.ndarray) -> np.ndarray:
    """Pairs of coded bits -> decoded bits, blocked start states
    (src/nxdn_decoder/trellis.cpp:29-101)."""
    dibits = (coded_bits[0::2] << 1) | coded_bits[1::2]
    bits, _ = viterbi_decode_np(dibits.astype(np.int64), num_states=16,
                                blocked_steps=4)
    return bits.astype(np.uint8)


class Sacch:
    """One 30-dibit SACCH unit -> 26 info bits + structure index
    (src/nxdn_decoder/sacch.cpp:24-84)."""

    def __init__(self, bits36: np.ndarray):
        self.bits = bits36  # decoded bits (26 data + 6 crc + tail)

    @staticmethod
    def parse(dibits30: np.ndarray) -> "Sacch | None":
        bits60 = _bits_from_dibits(dibits30[:30])
        deinterleaved = bits60[interleave.nxdn_sacch()]
        inflated = interleave.depuncture(
            deinterleaved, interleave.depuncture_mask_sacch())
        decoded = _viterbi_nxdn(inflated)
        crc = int(crc6_nxdn(26).compute_np(decoded[:26]))
        received = 0
        for b in decoded[26:32]:
            received = (received << 1) | int(b)
        if crc != received:
            return None
        return Sacch(decoded)

    def structure_index(self) -> int:
        return (int(self.bits[0]) << 1 | int(self.bits[1])) ^ 0b11

    def superframe_bits(self) -> np.ndarray:
        """18 payload bits (bits 8..25 of the unit: byte 1 onward,
        sacch.cpp:117-124)."""
        return self.bits[8:26]


class SacchSuperframe:
    """4x18 = 72 bits -> 9 bytes (sacch.cpp:141-162)."""

    def __init__(self, data: bytes):
        self.data = data

    def message_type(self) -> int:
        return self.data[0] & 0b00111111

    def call_type(self) -> int:
        return self.data[2] >> 5

    def source_unit_id(self) -> int:
        return (self.data[3] << 8) | self.data[4]

    def destination_id(self) -> int:
        return (self.data[5] << 8) | self.data[6]


class SacchSuperframeCollector:
    """(sacch.cpp:86-139)"""

    def __init__(self):
        self.collected: list[Sacch | None] = [None] * 4

    def push(self, sacch: Sacch) -> None:
        index = sacch.structure_index()
        if index > 0 and self.collected[index - 1] is None:
            return  # fragment without its predecessor is worthless
        self.collected[index] = sacch

    def reset(self) -> None:
        self.collected = [None] * 4

    def is_complete(self) -> bool:
        return all(s is not None for s in self.collected)

    def get_superframe(self) -> SacchSuperframe | None:
        if not self.is_complete():
            return None
        bits = np.concatenate([s.superframe_bits() for s in self.collected])
        data = np.packbits(bits.astype(np.uint8)).tobytes()
        return SacchSuperframe(data)


class Facch1:
    """144-dibit slot: 16x9 de-interleave, de-puncture to 192, Viterbi,
    CRC-12 (src/nxdn_decoder/facch1.cpp:8-74)."""

    def __init__(self, bits96: np.ndarray):
        self.bits = bits96

    @staticmethod
    def parse(dibits72: np.ndarray) -> "Facch1 | None":
        bits144 = _bits_from_dibits(dibits72[:72])
        deinterleaved = bits144[interleave.nxdn_facch1()]
        inflated = interleave.depuncture(
            deinterleaved, interleave.depuncture_mask_facch1())
        decoded = _viterbi_nxdn(inflated)
        crc = int(crc12_nxdn(80).compute_np(decoded[:80]))
        received = 0
        for b in decoded[80:92]:
            received = (received << 1) | int(b)
        if crc != received:
            return None
        return Facch1(decoded)

    def message_type(self) -> int:
        v = 0
        for b in self.bits[2:8]:  # data[0] & 0x3F = bits 2..7
            v = (v << 1) | int(b)
        return v
