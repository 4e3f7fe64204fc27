"""D-Star metadata collector (src/dstar_decoder/dstar_meta.cpp; copy of
``digiham_tpu/protocols/dstar/meta.py``): ``set_from_header`` holds the
events of its five fields and releases them as one, as the C++'s
``setFromHeader`` does."""
from __future__ import annotations

from ..meta import MetaCollector as BaseCollector
from ..utils import Coordinate
from .header import Header


class MetaCollector(BaseCollector):
    def __init__(self):
        super().__init__()
        self.sync = ""
        self.message = ""
        self.departure = ""
        self.destination = ""
        self.ourcall = ""
        self.yourcall = ""
        self.dprs = ""
        self.coord: Coordinate | None = None

    def get_protocol(self) -> str:
        return "DSTAR"

    def collect(self) -> dict:
        metadata = super().collect()
        if self.sync:
            metadata["sync"] = self.sync
        if self.departure:
            metadata["departure"] = self.departure
        if self.destination:
            metadata["destination"] = self.destination
        if self.ourcall:
            metadata["ourcall"] = self.ourcall
        if self.yourcall:
            metadata["yourcall"] = self.yourcall
        if self.message:
            metadata["message"] = self.message
        if self.dprs:
            metadata["dprs"] = self.dprs
        if self.coord is not None:
            lat, lon = self.coord.format()
            metadata["lat"] = lat
            metadata["lon"] = lon
        return metadata

    def _set(self, attr, value) -> None:
        if getattr(self, attr) == value:
            return
        setattr(self, attr, value)
        self.send_metadata()

    def set_sync(self, sync: str) -> None:
        self._set("sync", sync)

    def set_from_header(self, header: Header) -> None:
        self.hold()
        self.set_sync("voice" if header.is_voice() else "data")
        self.set_departure(header.departure_repeater())
        self.set_destination(header.destination_repeater())
        self.set_ourcall(header.own_callsign())
        self.set_yourcall(header.companion())
        self.release()

    def set_message(self, message: str) -> None:
        self._set("message", message)

    def set_departure(self, departure: str) -> None:
        self._set("departure", departure)

    def set_destination(self, destination: str) -> None:
        self._set("destination", destination)

    def set_ourcall(self, ourcall: str) -> None:
        self._set("ourcall", ourcall)

    def set_yourcall(self, yourcall: str) -> None:
        self._set("yourcall", yourcall)

    def set_dprs(self, dprs: str) -> None:
        self._set("dprs", dprs)

    def set_gps(self, coord: Coordinate | None) -> None:
        if self.coord == coord:
            return
        self.coord = coord
        self.send_metadata()

    def reset(self) -> None:
        self.hold()
        self.set_sync("")
        self.set_message("")
        self.set_departure("")
        self.set_destination("")
        self.set_ourcall("")
        self.set_yourcall("")
        self.set_dprs("")
        self.set_gps(None)
        self.release()
