"""D-Star 660-bit radio header (src/dstar_decoder/header.cpp; copy of
``digiham_tpu/protocols/dstar/header.py``, its encoder the TX side of
``benchmark/synth/dstar.py``).

Chain: descramble (7-bit LFSR keystream) -> de-interleave (12x28 + 12x27)
-> rate-1/2 K=3 4-state Viterbi over 330 dibits (reject if metric > 10) ->
CRC-16 (reflected 0x8408) -> 39-byte header: flags + 4x8-char callsign
fields + 4-char suffix. Bits pack LSB-first per byte throughout (the
reference's ``outshift = pos % 8`` convention, header.cpp:96-99).
"""
from __future__ import annotations

import numpy as np

from ..fec import interleave
from ..fec.dstar_crc import crc16_dstar_bytes
from ..fec.lfsr import dstar_scrambler
from ..fec.viterbi import viterbi_decode_np
from ..utils import convert_to_utf8

HEADER_BITS = 660


def _bits_to_bytes_lsb(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, np.uint8),
                       bitorder="little").tobytes()


def _crc_valid(data: bytes, to_check: int) -> bool:
    """CRC over bytes processed bit-LSB-first (src/dstar_decoder/crc.cpp)."""
    return crc16_dstar_bytes(data) == to_check


class Header:
    def __init__(self, data: bytes):
        self.data = bytes(data)

    @staticmethod
    def parse_from_header(raw_bits: np.ndarray) -> "Header | None":
        """raw_bits: 660 on-air bits."""
        bits = (np.asarray(raw_bits[:HEADER_BITS], np.uint8) & 1)
        descrambled = bits ^ dstar_scrambler()[:HEADER_BITS]
        deinterleaved = descrambled[interleave.dstar_header()]
        dibits = (deinterleaved[0::2].astype(np.int64) << 1) \
            | deinterleaved[1::2]
        decoded, metric = viterbi_decode_np(dibits, num_states=4)
        if int(metric) > 10:
            return None
        decoded_bytes = _bits_to_bytes_lsb(decoded.astype(np.uint8))
        return Header.parse_from_frame_data(decoded_bytes)

    @staticmethod
    def parse_from_frame_data(decoded: bytes) -> "Header | None":
        if len(decoded) < 41:
            return None
        to_check = decoded[39] | (decoded[40] << 8)  # little-endian u16
        if not _crc_valid(decoded[:39], to_check):
            return None
        return Header(decoded[:41])

    def is_data(self) -> bool:
        return bool((self.data[0] >> 7) & 1)

    def is_voice(self) -> bool:
        return not self.is_data()

    @staticmethod
    def _rtrim(s: str) -> str:
        return s.rstrip(" ")

    def destination_repeater(self) -> str:
        return self._rtrim(convert_to_utf8(self.data[3:11]))

    def departure_repeater(self) -> str:
        return self._rtrim(convert_to_utf8(self.data[11:19]))

    def companion(self) -> str:
        return self._rtrim(convert_to_utf8(self.data[19:27]))

    def own_callsign(self) -> str:
        call = self._rtrim(convert_to_utf8(self.data[27:35]))
        suffix = self._rtrim(convert_to_utf8(self.data[35:39]))
        if suffix:
            return f"{call}/{suffix}"
        return call


def encode_header(data39: bytes) -> np.ndarray:
    """TX/test inverse: 39 header bytes -> 660 on-air bits."""
    from ..fec.viterbi import conv_encode

    crc = crc16_dstar_bytes(data39[:39])
    full = data39[:39] + bytes([crc & 0xFF, (crc >> 8) & 0xFF])
    # 41 bytes = 328 bits; the Viterbi span is 330 bits -> 2 zero tail bits
    bits330 = np.concatenate([
        np.unpackbits(np.frombuffer(full, np.uint8), bitorder="little"),
        np.zeros(2, np.uint8)])[:330]
    dibits = conv_encode(bits330.astype(np.int64), num_states=4)
    coded = np.zeros(HEADER_BITS, np.uint8)
    coded[0::2] = (dibits >> 1) & 1
    coded[1::2] = dibits & 1
    interleaved = np.zeros(HEADER_BITS, np.uint8)
    interleaved[interleave.dstar_header()] = coded
    return interleaved ^ dstar_scrambler()[:HEADER_BITS]
