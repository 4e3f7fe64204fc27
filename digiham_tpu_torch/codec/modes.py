"""AMBE codec modes (src/mbe_synthesizer/ambe_modes.cpp, include/ambe_modes.hpp).

- TableMode(index): codec-table index (DMR/NXDN = 33, YSF DN = 34)
- ControlWordMode(cwds): 6 shorts -> "xxxx:xxxx:..." hex string
  (D-Star: 0130:0763:4000:0000:0000:0048)
- DynamicMode(callback): in-stream codec switching via leading mode bytes
  (YSF V/D1 vs DN vs VW)
"""
from __future__ import annotations

from typing import Callable, Optional


class Mode:
    def __eq__(self, other) -> bool:
        raise NotImplementedError

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


class TableMode(Mode):
    def __init__(self, index: int):
        self.index = index

    def get_index(self) -> int:
        return self.index

    def __eq__(self, other) -> bool:
        return isinstance(other, TableMode) and other.index == self.index

    def __hash__(self):
        return hash(("table", self.index))


class ControlWordMode(Mode):
    def __init__(self, cwds):
        self.cwds = tuple(int(c) & 0xFFFF for c in cwds)[:6]

    def get_cwds_as_string(self) -> str:
        """Network byte order hex, colon-separated
        (ambe_modes.cpp:38-45)."""
        return ":".join(f"{c:04x}" for c in self.cwds)

    def __eq__(self, other) -> bool:
        return isinstance(other, ControlWordMode) and other.cwds == self.cwds

    def __hash__(self):
        return hash(("cwd", self.cwds))


class DynamicMode(Mode):
    def __init__(self, callback: Callable[[int], Optional[Mode]]):
        self.callback = callback

    def get_mode_for(self, code: int) -> Optional[Mode]:
        return self.callback(code)

    def __eq__(self, other) -> bool:
        return other is self


# Well-known modes (src/mbe_synthesizer/cli.cpp:95-103,295-317)
DMR_NXDN_TABLE_INDEX = 33
YSF_DN_TABLE_INDEX = 34
DSTAR_CONTROL_WORDS = (0x0130, 0x0763, 0x4000, 0x0000, 0x0000, 0x0048)


def ysf_mode_for(code: int) -> Optional[Mode]:
    """YSF in-stream mode byte -> codec mode
    (src/mbe_synthesizer/cli.cpp:295-317): V/D1 (0) -> table 33,
    DN (2) -> table 34, VW (3) -> full-rate control words."""
    if code == 0:  # V/D mode 1
        return TableMode(DMR_NXDN_TABLE_INDEX)
    if code == 2:  # V/D mode 2 ("DN")
        return TableMode(YSF_DN_TABLE_INDEX)
    if code == 3:  # Voice FR ("VW")
        return ControlWordMode((0x0558, 0x086B, 0x1030, 0x0000, 0x0000,
                                0x0190))
    return None


# per-mode channel frame sizes for YSF dynamic switching
# (src/mbe_synthesizer/cli.cpp:281-293)
YSF_FRAME_SIZES = {0: 9, 2: 7, 3: 18}
