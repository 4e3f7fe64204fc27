"""YSF DT1/DT2 data-frame reassembly, Wires-X commands, radio types, and
the Yaesu GPS coordinate encoding (src/ysf_decoder/data.{hpp,cpp},
commands.h, radio_types.h, gps.cpp).

Copy of ``digiham_tpu/protocols/ysf/data.py``.
"""
from __future__ import annotations

import numpy as np

from ..utils import Coordinate

# Wires-X commands (src/ysf_decoder/commands.h:4-18)
COMMAND_DX_REQ = 0x5D715F
COMMAND_CONN_REQ = 0x5D235F
COMMAND_DISC_REQ = 0x5D2A5F
COMMAND_ALL_REQ = 0x5D665F
COMMAND_DX_RESP = 0x5D515F
COMMAND_DX_RESP2 = 0x5D525F
COMMAND_CONN_RESP = 0x5D415F
COMMAND_DISC_RESP = 0x5D415F
COMMAND_ALL_RESP = 0x5D465F
COMMAND_NULL0_GPS = 0x22615F
COMMAND_SHORT_GPS = 0x22625F
COMMAND_NULL1_GPS = 0x47635F
COMMAND_LONG_GPS = 0x47645F

# Yaesu radio ids (src/ysf_decoder/radio_types.h:8-19)
RADIO_TYPES = {
    0x20: "DR-2X",
    0x24: "FT-1D",
    0x25: "FTM-400D",
    0x26: "DR-1X",
    0x27: "FT-991",
    0x28: "FT-2D",
    0x29: "FTM-100D",
    0x2B: "FT-70D",
    0x30: "FT-3D",
    0x31: "FTM-300D",
}


def get_radio_type(radio_id: int) -> str:
    return RADIO_TYPES.get(radio_id, "")


class Gps:
    """Yaesu BCD/offset-ASCII coordinate decode with validity checks
    (src/ysf_decoder/gps.cpp:5-85)."""

    @staticmethod
    def parse(data: bytes) -> Coordinate | None:
        f32 = np.float32
        if any((data[i] & 0x0F) > 9 for i in range(6)):
            return None
        # float arithmetic exactly as the C code (gps.cpp:12-18)
        lat = f32(
            f32((data[0] & 0x0F) * 10)
            + f32(data[1] & 0x0F)
            + f32(f32(data[2] & 0x0F) / f32(6))
            + f32(f32(data[3] & 0x0F) / f32(60))
            + f32(f32(data[4] & 0x0F) / f32(600))
            + f32(f32(data[5] & 0x0F) / f32(6000))
        )
        direction = data[3] & 0xF0
        if direction == 0x50:
            pass  # northern hemisphere
        elif direction == 0x30:
            lat = -lat
        else:
            return None

        b = data[4] & 0xF0
        c = data[6]
        if b == 0x50:
            if 0x76 <= c < 0x7F:
                lon = c - 0x76
            elif 0x6C <= c < 0x75:
                lon = 100 + (c - 0x6C)
            elif 0x26 <= c < 0x6B:
                lon = 110 + (c - 0x26)
            else:
                return None
        elif b == 0x30:
            if 0x26 <= c < 0x7F:
                lon = 10 + (c - 0x26)
            else:
                return None
        else:
            # reference reads uninitialized lon here; treat as invalid
            return None

        lon = f32(lon)
        b = data[7]
        if 0x58 < b <= 0x61:
            lon = f32(lon + f32(f32(b - 0x58) / f32(60)))
        elif 0x26 <= b <= 0x57:
            lon = f32(lon + f32(f32(10 + (b - 0x26)) / f32(60)))
        else:
            return None

        b = data[8]
        if 0x1C <= b < 0x7F:
            lon = f32(lon + f32(f32(b - 0x1C) / f32(6000)))
        else:
            return None

        direction = data[5] & 0xF0
        if direction == 0x50:
            lon = f32(-lon)  # western hemisphere
        elif direction == 0x30:
            pass
        else:
            return None

        if lat > 90 or lat < -90 or lon > 180 or lon < -180:
            return None
        return Coordinate(lat, lon)


class DataFrame:
    """A complete DT1+DT2 20-byte frame (src/ysf_decoder/data.cpp:15-41)."""

    def __init__(self, data: bytes):
        self.data = bytes(data[:20])

    def get_command(self) -> int:
        d = self.data
        return (d[1] << 16) | (d[2] << 8) | d[3]

    def get_gps_coordinate(self) -> Coordinate | None:
        if self.get_command() != COMMAND_SHORT_GPS:
            return None
        return Gps.parse(self.data[5:])

    def get_radio(self) -> str:
        return get_radio_type(self.data[4])


class DataCollector:
    """Sequence-checked DT1/DT2 reassembly; terminator 0x03 + additive
    checksum (src/ysf_decoder/data.cpp:43-86)."""

    def __init__(self):
        self.data = bytearray(20)
        self.next_offset = 0

    def reset(self) -> None:
        self.next_offset = 0

    def collect(self, chunk: bytes, offset: int) -> None:
        assert offset < 2
        if offset != self.next_offset:
            self.next_offset = 0
            return
        self.next_offset = offset + 1
        self.data[offset * 10:offset * 10 + 10] = chunk[:10]

    def has_collected(self, num: int) -> bool:
        return self.next_offset >= num

    def get_data_frame(self) -> DataFrame | None:
        if self.data[18] != 0x03:
            return None
        checksum = sum(self.data[:19]) & 0xFF
        if checksum != self.data[19]:
            return None
        return DataFrame(bytes(self.data))
