"""NXDN metadata collector (src/nxdn_decoder/nxdn_meta.cpp; copy of
``digiham_tpu/protocols/nxdn/meta.py``)."""
from __future__ import annotations

from ..meta import MetaCollector as BaseCollector
from .components import (
    CALL_TYPE_CONFERENCE,
    CALL_TYPE_INDIVIDUAL,
    MESSAGE_TYPE_VCALL,
    SacchSuperframe,
)


class MetaCollector(BaseCollector):
    def __init__(self):
        super().__init__()
        self.sync = ""
        self.type = ""
        self.source = 0
        self.destination = 0

    def get_protocol(self) -> str:
        return "NXDN"

    def collect(self) -> dict:
        metadata = super().collect()
        if self.sync:
            metadata["sync"] = self.sync
        if self.type:
            metadata["type"] = self.type
        if self.source != 0:
            metadata["source"] = str(self.source)
        if self.destination != 0:
            metadata["destination"] = str(self.destination)
        return metadata

    def _set(self, attr, value) -> None:
        if getattr(self, attr) == value:
            return
        setattr(self, attr, value)
        self.send_metadata()

    def set_sync(self, sync: str) -> None:
        self._set("sync", sync)

    def set_type(self, type_: str) -> None:
        self._set("type", type_)

    def set_source(self, source: int) -> None:
        self._set("source", source)

    def set_destination(self, destination: int) -> None:
        self._set("destination", destination)

    def set_from_sacch(self, sacch: SacchSuperframe) -> None:
        if sacch.message_type() == MESSAGE_TYPE_VCALL:
            ct = sacch.call_type()
            if ct == CALL_TYPE_CONFERENCE:
                self.set_type("conference")
            elif ct == CALL_TYPE_INDIVIDUAL:
                self.set_type("individual")
            else:
                self.set_type("")
            self.set_source(sacch.source_unit_id())
            self.set_destination(sacch.destination_id())

    def reset(self) -> None:
        self.hold()
        self.set_sync("")
        self.set_type("")
        self.set_source(0)
        self.set_destination(0)
        self.release()
