"""YSF metadata collector (src/ysf_decoder/ysf_meta.{hpp,cpp}; copy of
``digiham_tpu/protocols/ysf/meta.py``)."""
from __future__ import annotations

from ...runtime.meta import MetaCollector as BaseCollector
from ...utils import Coordinate


class MetaCollector(BaseCollector):
    def __init__(self):
        super().__init__()
        self.mode = ""
        self.destination = ""
        self.source = ""
        self.up = ""
        self.down = ""
        self.radio = ""
        self.coord: Coordinate | None = None

    def get_protocol(self) -> str:
        return "YSF"

    def collect(self) -> dict:
        result = super().collect()
        if self.mode:
            result["mode"] = self.mode
        if self.destination:
            result["target"] = self.destination
        if self.source:
            result["source"] = self.source
        if self.up:
            result["up"] = self.up
        if self.down:
            result["down"] = self.down
        if self.radio:
            result["radio"] = self.radio
        if self.coord is not None:
            lat, lon = self.coord.format()
            result["lat"] = lat
            result["lon"] = lon
        return result

    def reset(self) -> None:
        self.hold()
        self.set_mode("")
        self.set_destination("")
        self.set_source("")
        self.set_up("")
        self.set_down("")
        self.set_radio("")
        self.set_gps(None)
        self.release()

    def _set(self, attr: str, value) -> None:
        if getattr(self, attr) == value:
            return
        setattr(self, attr, value)
        self.send_metadata()

    def set_mode(self, mode: str) -> None:
        self._set("mode", mode)

    def set_destination(self, destination: str) -> None:
        self._set("destination", destination)

    def set_source(self, source: str) -> None:
        self._set("source", source)

    def set_up(self, up: str) -> None:
        self._set("up", up)

    def set_down(self, down: str) -> None:
        self._set("down", down)

    def set_radio(self, radio: str) -> None:
        self._set("radio", radio)

    def set_gps(self, coord: Coordinate | None) -> None:
        if self.coord == coord:
            return
        self.coord = coord
        self.send_metadata()
