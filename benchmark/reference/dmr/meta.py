"""DMR metadata: two dirty-tracked Slot objects + protocol-tagged events
(src/dmr_decoder/dmr_meta.{hpp,cpp}; copy of
``digiham_tpu/protocols/dmr/meta.py``)."""
from __future__ import annotations

from ..meta import MetaCollector as BaseCollector
from ..utils import Coordinate
from .components import (
    Lc,
    LC_OPCODE_GROUP,
    LC_OPCODE_UNIT_TO_UNIT,
)

SYNCTYPE_DATA = 1
SYNCTYPE_VOICE = 2
META_TYPE_DIRECT = 1
META_TYPE_GROUP = 2


class Slot:
    """Per-timeslot metadata with change detection
    (src/dmr_decoder/dmr_meta.cpp:9-121)."""

    def __init__(self):
        self.dirty = False
        self.sync = -1
        self.type = -1
        self.source = 0
        self.target = 0
        self.talker_alias = ""
        self.coordinate: Coordinate | None = None

    def _set(self, attr, value) -> None:
        if getattr(self, attr) == value:
            return
        setattr(self, attr, value)
        self.dirty = True

    def set_sync(self, sync: int) -> None:
        self._set("sync", sync)

    def set_type(self, type_: int) -> None:
        self._set("type", type_)

    def set_source(self, source: int) -> None:
        self._set("source", source)

    def set_target(self, target: int) -> None:
        self._set("target", target)

    def set_from_lc(self, lc: Lc) -> None:
        op = lc.opcode()
        if op == LC_OPCODE_GROUP:
            self.set_type(META_TYPE_GROUP)
        elif op == LC_OPCODE_UNIT_TO_UNIT:
            self.set_type(META_TYPE_DIRECT)
        self.set_target(lc.target())
        self.set_source(lc.source())

    def set_talker_alias(self, alias: str) -> None:
        self._set("talker_alias", alias)

    def set_coordinate(self, coord: Coordinate | None) -> None:
        if self.coordinate == coord:
            return
        self.coordinate = coord
        self.dirty = True

    def soft_reset(self) -> None:
        self.set_type(-1)
        self.set_source(0)
        self.set_target(0)
        self.set_talker_alias("")
        self.set_coordinate(None)

    def reset(self) -> None:
        self.soft_reset()
        self.set_sync(-1)

    def collect(self) -> dict:
        result = {}
        if self.sync > 0:
            result["sync"] = {SYNCTYPE_DATA: "data",
                              SYNCTYPE_VOICE: "voice"}.get(self.sync, "unknown")
        if self.type > 0:
            result["type"] = {META_TYPE_DIRECT: "direct",
                              META_TYPE_GROUP: "group"}.get(self.type, "unknown")
        if self.source > 0:
            result["source"] = str(self.source)
        if self.target > 0:
            result["target"] = str(self.target)
        if self.talker_alias:
            result["talkeralias"] = self.talker_alias
        if self.coordinate is not None:
            lat, lon = self.coordinate.format()
            result["lat"] = lat
            result["lon"] = lon
        return result


class MetaCollector(BaseCollector):
    """Two slots; ``with_slot(i, fn)`` mutate-then-send
    (src/dmr_decoder/dmr_meta.cpp:148-180)."""

    def __init__(self):
        super().__init__()
        self.slots = (Slot(), Slot())

    def get_protocol(self) -> str:
        return "DMR"

    def with_slot(self, slot: int, fn) -> None:
        fn(self.slots[slot])
        self.send_metadata_for_slot(slot)

    def send_metadata(self) -> None:
        for i in range(2):
            self.send_metadata_for_slot(i)

    def send_metadata_for_slot(self, index: int) -> None:
        slot = self.slots[index]
        if not slot.dirty:
            return
        metadata = super().collect()
        metadata["slot"] = str(index)
        for k, v in slot.collect().items():
            metadata.setdefault(k, v)
        if self.writer is not None:
            self.writer.send_metadata(metadata)
        slot.dirty = False

    def reset(self) -> None:
        for s in self.slots:
            s.reset()
        self.send_metadata()
