"""NxdnFieldsFramePhase: the NXDN frame machine over device-decoded
fields (mirror of phases.FramedPhase, nxdn_phase.cpp:43-171).

On FACCH1 TX_RELEASE the reference exits mid-frame (before consuming the
remaining slot dibits); ``keep_from`` carries that partial consumption to
the tracked bank so re-hunting starts at exactly the same symbol.

Copy of ``digiham_tpu/protocols/nxdn/fields_phase.py``.
"""
from __future__ import annotations

import numpy as np

from ...runtime import diag
from ...runtime.metrics import TRACER
from .components import (
    Lich,
    MESSAGE_TYPE_IDLE,
    MESSAGE_TYPE_TX_RELEASE,
    RF_CHANNEL_TYPE_RCCH,
    SacchSuperframeCollector,
    USC_TYPE_SACCH_SF,
    USC_TYPE_UDCH,
)


class NxdnFrameFields:
    __slots__ = ("sync_dist", "lich_ok", "lich_byte", "sacch_structure",
                 "sacch_bits", "sacch_ok", "voice", "facch_mtype",
                 "facch_ok")

    def __init__(self, sync_dist, lich_ok, lich_byte, sacch_structure,
                 sacch_bits, sacch_ok, voice, facch_mtype, facch_ok):
        self.sync_dist = sync_dist
        self.lich_ok = lich_ok
        self.lich_byte = lich_byte
        self.sacch_structure = sacch_structure
        self.sacch_bits = sacch_bits          # np [18] 0/1
        self.sacch_ok = sacch_ok
        self.voice = voice                    # [2] x 18 bytes
        self.facch_mtype = facch_mtype        # [2]
        self.facch_ok = facch_ok              # [2]


class _FieldsSacch:
    """SacchSuperframeCollector-compatible unit built from fields."""

    def __init__(self, structure: int, bits18: np.ndarray):
        self._structure = structure
        self._bits = bits18

    def structure_index(self) -> int:
        return self._structure

    def superframe_bits(self) -> np.ndarray:
        return self._bits


class NxdnFieldsFramePhase:
    def __init__(self, meta=None):
        self.meta = meta
        self.sync_count = 0
        self.lich: Lich | None = None
        self.sacch_collector = SacchSuperframeCollector()

    def process_fields(self, f: NxdnFrameFields):
        """Returns (voice_bytes, lost_lock, keep_from)."""
        if f.sync_dist <= 2:
            self.sync_count = min(self.sync_count + 1, 6)
        else:
            self.sync_count -= 1
            if self.sync_count < 0:
                if self.meta is not None:
                    self.meta.reset()
                return b"", True, 0

        if f.lich_ok:
            self.lich = Lich(f.lich_byte)

        out = []
        if (self.lich is not None
                and self.lich.rf_type() != RF_CHANNEL_TYPE_RCCH
                and self.lich.functional_type() != USC_TYPE_UDCH):
            if self.lich.functional_type() == USC_TYPE_SACCH_SF \
                    and f.sacch_ok:
                self.sacch_collector.push(
                    _FieldsSacch(f.sacch_structure, f.sacch_bits))
                if self.sacch_collector.is_complete():
                    TRACER.counts.sacch_sfs += 1
                    sf = self.sacch_collector.get_superframe()
                    if self.meta is not None and sf is not None:
                        self.meta.set_from_sacch(sf)
                    self.sacch_collector.reset()

            option = self.lich.option()
            for i in range(2):
                if (option >> (1 - i)) & 1:
                    if self.sync_count >= 1:
                        if self.meta is not None:
                            self.meta.set_sync("voice")
                        out.append(f.voice[i])
                else:
                    if f.facch_ok[i]:
                        mt = f.facch_mtype[i]
                        if mt == MESSAGE_TYPE_TX_RELEASE:
                            if self.meta is not None:
                                self.meta.reset()
                            # exits before consuming this slot
                            # (nxdn_phase.cpp:153-156)
                            return b"".join(out), True, 48 + i * 72
                        elif mt == MESSAGE_TYPE_IDLE:
                            pass
                        else:
                            diag.say(f"FACCH1 message type: {mt}")
        return b"".join(out), False, 0
