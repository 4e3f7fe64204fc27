"""D-Star phase machine (src/dstar_decoder/dstar_phase.cpp; copy of
``digiham_tpu/protocols/dstar/phases.py``).

Bit-domain (2FSK) protocol: sync hunt for header sync (distance <= 2) or
voice sync (distance <= 1); 660-bit header decode; then 96-bit voice frames
(72 voice bits packed LSB-first + 24 slow-data bits) with a voice re-sync
every 21st frame (hysteresis cap 3), terminator detection (full or
half-length), and descrambled slow-data parsing: 20-char messages, inline
41-byte header re-assembly, and "simple data" carrying $$CRC D-PRS and NMEA
GGA sentences.

Departures from the C++: the sync scan tests up to ``MAX_SCAN`` windows a
call at once with numpy, where the C++ tests one window a call; the first
hit and the bits consumed are the same. The NMEA coordinates are computed
in float32 step by step, as the C++'s ``stof`` and float operations round.
The diagnostic lines go to standard error, as the C++'s ``std::cerr``.
"""
from __future__ import annotations

import sys

import numpy as np

from ..decoder import Output, Phase
from ..fec.dstar_crc import crc16_dstar_bytes
from ..fec.lfsr import dstar_scrambler
from ..utils import Coordinate, convert_to_utf8
from .header import Header

SYNC_SIZE = 24
TERMINATOR_SIZE = 48

# (dstar_phase.hpp:19-38)
HEADER_SYNC = np.array(
    [0, 1, 0, 1, 0, 1, 0, 1, 0,
     1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0, 0], dtype=np.uint8)
VOICE_SYNC = np.array(
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 0,
     1, 1, 0, 1, 0, 0, 0,
     1, 1, 0, 1, 0, 0, 0], dtype=np.uint8)
# the hunt's hits: a header sync within 2 or a voice sync within 1
# (dstar_phase.cpp:20,25)
HEADER_SYNC_BOUND = 2
VOICE_SYNC_BOUND = 1
TERMINATOR = np.array(
    [1, 0] * 16 +
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0], dtype=np.uint8)

_BIT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _dist(a: np.ndarray, b: np.ndarray) -> int:
    return int(_BIT_LUT[np.asarray(a, np.uint8) ^ b].sum())


class SyncPhase(Phase):
    MAX_SCAN = 8192

    def required_data(self) -> int:
        return SYNC_SIZE

    def process(self, data: np.ndarray, output: Output):
        data = data[:SYNC_SIZE - 1 + self.MAX_SCAN]
        windows = np.lib.stride_tricks.sliding_window_view(data, SYNC_SIZE)
        hdist = _BIT_LUT[windows ^ HEADER_SYNC].sum(axis=1)
        vdist = _BIT_LUT[windows ^ VOICE_SYNC].sum(axis=1)
        hits = np.nonzero((hdist <= HEADER_SYNC_BOUND)
                          | (vdist <= VOICE_SYNC_BOUND))[0]
        if len(hits) == 0:
            return None, windows.shape[0]
        i = int(hits[0])
        if hdist[i] <= HEADER_SYNC_BOUND:
            return HeaderPhase(), i + SYNC_SIZE
        return VoicePhase(0), i + SYNC_SIZE


class HeaderPhase(Phase):
    def required_data(self) -> int:
        return 660

    def process(self, data: np.ndarray, output: Output):
        header = Header.parse_from_header(data[:660])
        if header is None:
            return SyncPhase(), 1
        if header.is_voice():
            if self.meta is not None:
                self.meta.set_from_header(header)
            return VoicePhase(), 660
        return SyncPhase(), 660


class VoicePhase(Phase):
    """(dstar_phase.cpp:59-134)"""

    def __init__(self, frame_count: int = 21):
        # after a header, a sync is due immediately and the header counts
        # as one sync (dstar_phase.cpp:64-71)
        self.frame_count = frame_count
        self.sync_count = 1 if frame_count == 21 else 0
        self.collected = bytearray(6)
        self.message = bytearray(20)
        self.message_blocks = 0
        self.header = bytearray(41)
        self.header_count = 0
        self.simple_data = b""

    def required_data(self) -> int:
        return 72 + 24 + 24

    def process(self, data: np.ndarray, output: Output):
        consumed = 0
        if self.sync_count >= 1:
            voice = np.asarray(data[:72], np.uint8) & 1
            output.write(np.packbits(voice, bitorder="little").tobytes())
        consumed += 72

        frame = np.asarray(data[72:72 + 48], np.uint8) & 1
        data_frame = frame[:24]
        consumed += 24

        if (_dist(frame[:TERMINATOR_SIZE], TERMINATOR) <= 1
                or _dist(data_frame, TERMINATOR[24:]) <= 1):
            consumed += 24  # terminator consumes the extra 24
            if self.meta is not None:
                self.meta.reset()
            return SyncPhase(), consumed

        if self._is_sync_due():
            if _dist(data_frame, VOICE_SYNC) > 1:
                self.sync_count -= 1
                if self.sync_count < 0:
                    if self.meta is not None:
                        self.meta.reset()
                    return SyncPhase(), consumed
            else:
                self.sync_count = min(self.sync_count + 1, 3)
                if self.sync_count > 1 and self.meta is not None:
                    self.meta.set_sync("voice")
            self._parse_frame_data()
            self._reset_frames()
        else:
            descrambled = data_frame ^ dstar_scrambler()[:24]
            data_bytes = np.packbits(descrambled, bitorder="little").tobytes()
            self._collect_data_frame(data_bytes)
            self.frame_count += 1

        return None, consumed

    def _is_sync_due(self) -> bool:
        return self.frame_count >= 20

    def _reset_frames(self) -> None:
        self.frame_count = 0
        self.message = bytearray(20)
        self.message_blocks = 0
        self.header = bytearray(41)
        self.header_count = 0

    def _collect_data_frame(self, data: bytes) -> None:
        """(dstar_phase.cpp:148-194)"""
        idx = (self.frame_count % 2) * 3
        self.collected[idx:idx + 3] = data[:3]
        if self.frame_count % 2 == 0:
            return
        mini = self.collected[0] >> 4
        if mini == 0x04:
            block = self.collected[0] & 0x0F
            if block > 3:
                return
            self.message[block * 5:block * 5 + 5] = self.collected[1:6]
            self.message_blocks |= 1 << block
        elif mini == 0x05:
            nbytes = self.collected[0] & 0x0F
            if nbytes > 5 or self.header_count + nbytes > 41:
                return
            self.header[self.header_count:self.header_count + nbytes] = \
                self.collected[1:1 + nbytes]
            self.header_count += nbytes
        elif mini == 0x03:
            nbytes = self.collected[0] & 0x0F
            if nbytes > 5:
                return
            self.simple_data += bytes(self.collected[1:1 + nbytes])
        elif mini in (0x0, 0x1, 0x2, 0x6, 0x7, 0xA, 0xB, 0xD, 0xE, 0xF):
            pass  # reserved
        else:
            print(f"received unknown data (mini header = "
                  f"{self.collected[0]:x})", file=sys.stderr)

    def _parse_frame_data(self) -> None:
        """(dstar_phase.cpp:196-232)"""
        meta = self.meta
        if self.message_blocks == 0x0F and meta is not None:
            meta.set_message(convert_to_utf8(bytes(self.message)))
        if self.header_count == 41:
            h = Header.parse_from_frame_data(bytes(self.header))
            if h is not None and meta is not None:
                meta.set_from_header(h)
        while True:
            pos = self.simple_data.find(b"\r")
            if pos < 0:
                break
            something = self.simple_data[:pos + 1]
            if (len(something) >= 10 and something[:5] == b"$$CRC"
                    and something[9:10] == b","):
                try:
                    checksum = int(something[5:9], 16)
                except ValueError:
                    checksum = -1
                if crc16_dstar_bytes(something[10:]) == checksum:
                    if meta is not None:
                        meta.set_dprs(
                            something[10:-1].decode("latin-1"))
            elif len(something) > 5 and something[:1] == b"$":
                self._parse_nmea(something)
            else:
                print(f"parsed simple data: "
                      f"{something.decode('latin-1', 'replace')}",
                      file=sys.stderr)
            skip = pos + 1
            if len(self.simple_data) > skip and \
                    self.simple_data[skip:skip + 1] == b"\n":
                skip += 1
            self.simple_data = self.simple_data[skip:]

    def _parse_nmea(self, raw: bytes) -> None:
        """XOR-checksummed $..GGA sentences -> Coordinate
        (dstar_phase.cpp:234-279)."""
        meta = self.meta
        text = raw.decode("latin-1", "replace")
        checksum_pos = text.rfind("*")
        if checksum_pos < 0 or checksum_pos + 2 > len(text):
            return
        body = text[1:checksum_pos]
        message = body[2:5]
        checksum = 0
        for ch in body:
            checksum ^= ord(ch)
        try:
            to_check = int(text[checksum_pos + 1:checksum_pos + 3], 16)
        except ValueError:
            return
        if checksum != to_check:
            return
        fields = body.split(",")
        if message == "GGA":
            # all-float32 arithmetic like the C code (stof + float ops,
            # dstar_phase.cpp:257-268); note `(int) lat_combined / 100`
            # is integer division there
            try:
                f32 = np.float32
                lat_c = f32(fields[2])
                lat = f32(int(int(lat_c) / 100))  # C trunc-toward-zero
                lat = f32(lat + (lat_c - f32(lat * f32(100.0))) / f32(60.0))
                if fields[3] == "S":
                    lat = f32(-lat)
                lon_c = f32(fields[4])
                lon = f32(int(int(lon_c) / 100))
                lon = f32(lon + (lon_c - f32(lon * f32(100.0))) / f32(60.0))
                if fields[5] == "W":
                    lon = f32(-lon)
            except (IndexError, ValueError):
                return
            if meta is not None:
                meta.set_gps(Coordinate(lat, lon))
