"""Shared small utilities (reference src/lib/; copy of
``digiham_tpu/utils.py`` without ``env_flag``, its parser of the kernel
override switches: the port has no kernel override. The one environment
switch the port reads is ``DIGIHAM_METRICS_EVERY``, in
``runtime/metrics.py``, as the JAX package does: every that many seconds
it reports the banks' counters on stderr, channel-samples a second,
steps, frames, and the fast-skip and decode-fill ratios).

- hamming_distance: bytewise popcount-of-XOR (src/lib/hamming_distance.c:3-12)
- Coordinate: lat/lon value type (src/lib/coordinate.{hpp,cpp})
- convert_to_utf8: charset conversion, default ISO-8859-1 -> UTF-8
  (src/lib/charset.cpp:10-27)
- dump_hex: stderr hexdump debug helper (src/lib/dumphex.c:3-36)
"""
from __future__ import annotations

import sys

import numpy as np


def hamming_distance(a, b) -> int:
    """Total bit difference between two equal-length byte/symbol arrays."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return int(np.unpackbits(a ^ b).sum())


class Coordinate:
    """Latitude/longitude pair (src/lib/coordinate.cpp:5-9)."""

    __slots__ = ("lat", "lon")

    def __init__(self, lat: float, lon: float):
        self.lat = float(lat)
        self.lon = float(lon)

    def __eq__(self, other):
        return (isinstance(other, Coordinate)
                and self.lat == other.lat and self.lon == other.lon)

    def __repr__(self):
        return f"Coordinate({self.lat}, {self.lon})"

    def format(self) -> tuple[str, str]:
        """std::to_string-style 6-decimal fixed formatting."""
        return f"{self.lat:.6f}", f"{self.lon:.6f}"


def convert_to_utf8(data: bytes, charset: str = "iso-8859-1") -> str:
    """Decode legacy-charset callsign/alias bytes to a UTF-8 string."""
    return bytes(data).decode(charset, errors="replace")


def dump_hex(data, prefix: str = "") -> None:
    data = bytes(bytearray(data))
    for i in range(0, len(data), 16):
        chunk = data[i:i + 16]
        hexpart = " ".join(f"{b:02x}" for b in chunk)
        asciipart = "".join(chr(b) if 32 <= b < 127 else "." for b in chunk)
        print(f"{prefix}{i:08x}  {hexpart:<47}  {asciipart}",
              file=sys.stderr)
