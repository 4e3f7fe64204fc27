"""DMR decoder assembly (src/dmr_decoder/dmr_decoder.cpp:7-22; copy of
``digiham_tpu/protocols/dmr/decoder.py``)."""
from __future__ import annotations

from ..decoder import Decoder as BaseDecoder
from .meta import MetaCollector
from .phases import FramePhase, SyncPhase


class Decoder(BaseDecoder):
    """Decoder(SyncPhase, MetaCollector) with a runtime slot filter that is
    re-injected on every phase swap (dmr_decoder.cpp:9-22), and so is
    ``rs129`` (see :class:`FramePhase`)."""

    rs129 = False

    def __init__(self, rs129: bool = False):
        super().__init__(SyncPhase(), MetaCollector())
        self.slot_filter = 3
        self.rs129 = rs129

    def set_slot_filter(self, flt: int) -> None:
        self.slot_filter = flt
        if isinstance(self.current_phase, FramePhase):
            self.current_phase.set_slot_filter(flt)

    def set_phase(self, phase) -> None:
        super().set_phase(phase)
        if isinstance(phase, FramePhase):
            phase.set_slot_filter(self.slot_filter)
            phase.rs129 = self.rs129


def make_decoder(rs129: bool = False) -> Decoder:
    """The DMR decoder; ``rs129=True`` checks and corrects the voice LC
    header's RS(12,9) parity (:class:`FramePhase`)."""
    return Decoder(rs129)
