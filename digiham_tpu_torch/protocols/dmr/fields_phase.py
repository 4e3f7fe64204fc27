"""FieldsFramePhase: the DMR frame machine over device-decoded fields.

Identical control flow to ``phases.FramePhase`` (dmr_phase.cpp:65-302) but
consuming the per-frame field rows that ``pipeline.dmr.dmr_decode_frames``
computes in batch on device — so the host does no FEC math at all, only
the counters/dispatch (a few microseconds per frame). This is the
steady-state *tracking* half of the acquisition/tracking split
(SURVEY.md §7.1 item 4). Copy of
``digiham_tpu/protocols/dmr/fields_phase.py``; equivalence with it and
with the symbol-domain FramePhase is asserted by
tests/test_torch_dmr_host.py and tests/test_torch_tracked_bank.py on
shared streams.
"""
from __future__ import annotations

import sys

from ...runtime.metrics import TRACER
from .components import (
    DATA_TYPE_IDLE,
    DATA_TYPE_RATE_3_4_DATA,
    DATA_TYPE_TERMINATOR_LC,
    DATA_TYPE_VOICE_LC,
    EmbeddedCollector,
    Gps,
    LC_GPS_INFO,
    LC_OPCODE_GROUP,
    LC_OPCODE_UNIT_TO_UNIT,
    LC_TALKER_ALIAS_BLK3,
    LC_TALKER_ALIAS_HDR,
    LCSS_CONTINUATION,
    LCSS_SINGLE,
    LCSS_START,
    LCSS_STOP,
    Lc,
    TalkerAliasCollector,
)

SYNCTYPE_VOICE = 2


class FrameFields:
    """One frame's device-decoded fields (plain python scalars/bytes)."""

    __slots__ = ("tact_ok", "tact_slot", "sync_type", "emb_ok", "emb_lcss",
                 "emb_fragment", "voice_payload", "slot_type_ok",
                 "data_type", "bptc_ok", "lc_bytes")

    def __init__(self, tact_ok, tact_slot, sync_type, emb_ok, emb_lcss,
                 emb_fragment, voice_payload, slot_type_ok, data_type,
                 bptc_ok, lc_bytes):
        self.tact_ok = tact_ok
        self.tact_slot = tact_slot
        self.sync_type = sync_type
        self.emb_ok = emb_ok
        self.emb_lcss = emb_lcss
        self.emb_fragment = emb_fragment
        self.voice_payload = voice_payload
        self.slot_type_ok = slot_type_ok
        self.data_type = data_type
        self.bptc_ok = bptc_ok
        self.lc_bytes = lc_bytes


class FieldsFramePhase:
    """Mirror of phases.FramePhase with fields input. ``process_fields``
    returns (emitted_voice_bytes | b"", lost_lock: bool)."""

    def __init__(self, meta=None):
        self.meta = meta
        self.sync_count = 0
        self.slot = -1
        self.slot_stability = 0
        self.sync_types = [-1, -1]
        self.slot_sync_count = [0, 0]
        self.emb_collectors = (EmbeddedCollector(), EmbeddedCollector())
        self.talker_alias = (TalkerAliasCollector(), TalkerAliasCollector())
        self.active_slot = -1
        self.slot_filter = 3
        self.superframe_counter = [0, 0]

    def set_slot_filter(self, flt: int) -> None:
        self.slot_filter = flt
        if ((self.active_slot + 1) & flt) == 0:
            self.active_slot = -1

    def _meta_with_slot(self, slot: int, fn) -> None:
        if self.meta is not None:
            self.meta.with_slot(slot, fn)

    def process_fields(self, f: FrameFields):
        """(dmr_phase.cpp:65-302 over field rows).
        Returns (voice_bytes, lost_lock, keep_from): on lock loss the
        re-hunt starts ``keep_from`` dibits into the failing frame (0 for
        DMR — the reference exits without consuming)."""
        next_slot = (self.slot ^ 1) & 0xFF
        if f.tact_ok:
            if f.tact_slot != next_slot:
                if self.slot_stability < 5:
                    self.slot_stability = 0
                    self.slot = f.tact_slot
                    other = self.slot ^ 1
                    self.sync_types[other] = -1
                    self._meta_with_slot(other, lambda s: s.reset())
                    if self.active_slot == other:
                        self.active_slot = -1
                else:
                    self.slot_stability -= 1
                    if self.slot != -1:
                        self.slot = next_slot
            else:
                self.slot_stability = min(self.slot_stability + 1, 100)
                self.slot = next_slot
        elif self.slot != -1:
            self.slot_stability = max(self.slot_stability - 1, -100)
            self.slot = next_slot

        if self.slot == -1:
            return b"", False, 0

        slot = self.slot
        sync_type = f.sync_type
        if sync_type > 0:
            self.sync_count = min(self.sync_count + 1, 5)
            self.slot_sync_count[slot] = min(self.slot_sync_count[slot] + 1, 5)
            soft_reset = (self.sync_types[slot] == SYNCTYPE_VOICE
                          and sync_type != self.sync_types[slot])
            self.sync_types[slot] = sync_type

            def update(s, st=sync_type, soft=soft_reset):
                s.set_sync(st)
                if soft:
                    s.soft_reset()

            self._meta_with_slot(slot, update)
            self.superframe_counter[slot] = 0
            self.emb_collectors[slot].reset()
        elif (self.sync_types[slot] == SYNCTYPE_VOICE
              and self.superframe_counter[slot] < 5):
            self.superframe_counter[slot] += 1
            if f.emb_ok:
                self.sync_count = min(self.sync_count + 1, 5)
                self.slot_sync_count[slot] = min(
                    self.slot_sync_count[slot] + 1, 5)
                collector = self.emb_collectors[slot]
                lcss = f.emb_lcss
                if lcss == LCSS_SINGLE:
                    pass
                elif lcss in (LCSS_START, LCSS_CONTINUATION):
                    if lcss == LCSS_START:
                        collector.reset()
                    collector.collect(f.emb_fragment)
                elif lcss == LCSS_STOP:
                    collector.collect(f.emb_fragment)
                    TRACER.counts.emb_lcs += 1
                    lc = collector.get_lc()
                    if lc is not None:
                        self._handle_lc(lc)
                    collector.reset()
            else:
                if self._lose_sync(slot):
                    return b"", True, 0
        else:
            self.superframe_counter[slot] = 0
            self.emb_collectors[slot].reset()
            if self._lose_sync(slot):
                return b"", True, 0

        out = b""
        if self.sync_types[slot] == SYNCTYPE_VOICE:
            if (((slot + 1) & self.slot_filter)
                    and self.active_slot in (-1, slot)):
                self.active_slot = slot
                out = f.voice_payload
        else:
            if self.active_slot == slot:
                self.active_slot = -1
            self.talker_alias[slot].reset()
            if self.sync_types[slot] == 1:  # SYNCTYPE_DATA
                self._process_data_frame(f, slot)
            else:
                self._meta_with_slot(slot, lambda s: s.reset())
        return out, False, 0

    def _lose_sync(self, slot: int) -> bool:
        self.slot_sync_count[slot] -= 1
        if self.slot_sync_count[slot] < 0:
            self.slot_sync_count[slot] = 0
            self.sync_types[slot] = -1
            self._meta_with_slot(slot, lambda s: s.reset())
            if self.active_slot == slot:
                self.active_slot = -1
        self.sync_count -= 1
        if self.sync_count < 0:
            if self.meta is not None:
                self.meta.reset()
            return True
        return False

    def _process_data_frame(self, f: FrameFields, slot: int) -> None:
        if not f.slot_type_ok:
            return
        data_type = f.data_type
        if data_type == DATA_TYPE_RATE_3_4_DATA:
            return
        if not f.bptc_ok:
            return
        if data_type == DATA_TYPE_VOICE_LC:
            lc = Lc.parse_from_voice_header(f.lc_bytes)
            if lc is not None:
                self._handle_lc(lc)
        elif data_type in (DATA_TYPE_TERMINATOR_LC, DATA_TYPE_IDLE):
            self._meta_with_slot(slot, lambda s: s.soft_reset())

    def _handle_lc(self, lc: Lc) -> None:
        opcode = lc.opcode()
        slot = self.slot
        if opcode in (LC_OPCODE_GROUP, LC_OPCODE_UNIT_TO_UNIT):
            self._meta_with_slot(slot, lambda s: s.set_from_lc(lc))
        elif LC_TALKER_ALIAS_HDR <= opcode <= LC_TALKER_ALIAS_BLK3:
            collector = self.talker_alias[slot]
            collector.set_block(opcode - LC_TALKER_ALIAS_HDR, lc.payload())
            if collector.is_complete():
                alias = collector.get_contents().rstrip("\x00")
                self._meta_with_slot(slot, lambda s: s.set_talker_alias(alias))
        elif opcode == LC_GPS_INFO:
            coord = Gps.parse(lc.payload())
            self._meta_with_slot(slot, lambda s: s.set_coordinate(coord))
        else:
            print(f"unknown opcode: {opcode} from feature set id: "
                  f"{lc.feature_set_id()}", file=sys.stderr)
