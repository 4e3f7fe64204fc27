"""DMR phase machine: sync hunt + 144-dibit TDMA frame loop.

Faithful port of the reference control flow (src/dmr_decoder/dmr_phase.cpp):
CACH/TACT slot tracking with ±100 stability hysteresis, per-slot sync-type
tracking with 5-cap counters, 6-frame voice superframes with EMB/embedded-LC
extraction, BPTC-protected data frames (VOICE_LC / TERMINATOR / IDLE), LC
dispatch to talker-alias and GPS collectors, and slot-filter muting with
active-slot arbitration. This is control-plane code: all FEC math delegates
to the host twins in ``fec``; the voice payload pack is a numpy gather.

Copy of ``digiham_tpu/protocols/dmr/phases.py``; the sync words and the
frame geometry live in ``constants.py``. The JAX package's opt-in RS(12,9)
check of the voice LC header (its ``DIGIHAM_DMR_RS129`` switch) is the
constructor argument ``FramePhase(rs129=True)`` here
(``make_decoder(rs129=True)``), not an environment switch.
"""
from __future__ import annotations

import sys

import numpy as np

from ..fec import bptc, rs129 as rs
from ..decoder import Output, Phase
from .components import (
    Cach,
    DATA_TYPE_IDLE,
    DATA_TYPE_RATE_3_4_DATA,
    DATA_TYPE_TERMINATOR_LC,
    DATA_TYPE_VOICE_LC,
    Emb,
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
    SlotType,
    TalkerAliasCollector,
)
from .constants import (BS_DATA_SYNC, BS_VOICE_SYNC, CACH_SIZE,  # noqa: F401
                        FRAME_SIZE, MS_DATA_SYNC, MS_VOICE_SYNC, SYNC_OFFSET,
                        SYNC_SIZE)

SYNCTYPE_DATA = 1
SYNCTYPE_VOICE = 2

_SYNC_PATTERNS = (
    (BS_DATA_SYNC, SYNCTYPE_DATA),
    (BS_VOICE_SYNC, SYNCTYPE_VOICE),
    (MS_DATA_SYNC, SYNCTYPE_DATA),
    (MS_VOICE_SYNC, SYNCTYPE_VOICE),
)

_BIT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def get_sync_type(window: np.ndarray) -> int:
    """First-match sync classification, distance <= 3 per pattern
    (dmr_phase.cpp:18-33)."""
    w = np.asarray(window[:SYNC_SIZE], dtype=np.uint8)
    for pattern, stype in _SYNC_PATTERNS:
        if _BIT_LUT[w ^ pattern].sum() <= 3:
            return stype
    return -1


def pack_dibits(dibits: np.ndarray) -> bytes:
    """Pack dibits MSB-first, 4 per byte (dmr_phase.cpp:216-225)."""
    d = np.asarray(dibits, dtype=np.uint8) & 3
    pad = (-len(d)) % 4
    if pad:
        d = np.concatenate([d, np.zeros(pad, np.uint8)])
    quads = d.reshape(-1, 4)
    return bytes(
        (quads[:, 0] << 6) | (quads[:, 1] << 4)
        | (quads[:, 2] << 2) | quads[:, 3])


class SyncPhase(Phase):
    """Symbol-by-symbol sync hunt at mid-frame offset
    (dmr_phase.cpp:35-48), vectorized over the buffered window."""

    def required_data(self) -> int:
        return SYNC_SIZE + SYNC_OFFSET

    MAX_SCAN = 4096  # offsets per call: bounds latency on huge buffers

    def process(self, data: np.ndarray, output: Output):
        n = min(len(data), SYNC_OFFSET + SYNC_SIZE - 1 + self.MAX_SCAN)
        data = data[:n]
        usable = n - SYNC_OFFSET
        if usable < SYNC_SIZE:
            return None, 0
        windows = np.lib.stride_tricks.sliding_window_view(
            data[SYNC_OFFSET:], SYNC_SIZE)
        for pattern, _ in _SYNC_PATTERNS:
            dist = _BIT_LUT[windows ^ pattern].sum(axis=1)
            hits = np.nonzero(dist <= 3)[0]
            if len(hits):
                first_any = int(hits[0])
                break
        else:
            first_any = None
        if first_any is None:
            return None, windows.shape[0] - 1 + 1
        # check offsets before first_any found by *other* patterns: the
        # reference tests all 4 patterns per offset before advancing
        dists = np.stack([
            _BIT_LUT[windows[:first_any + 1] ^ p].sum(axis=1)
            for p, _ in _SYNC_PATTERNS])
        anyhit = np.nonzero((dists <= 3).any(axis=0))[0]
        return FramePhase(), int(anyhit[0])


class FramePhase(Phase):
    """144-dibit frame loop (dmr_phase.cpp:65-302). ``rs129``: check and
    correct the voice LC header's RS(12,9) parity, dropping an LC it cannot
    correct (an opt-in improvement over the reference, which ignores the
    parity bytes, lc.cpp:8-11; off by default, so the metadata stay the
    reference's)."""

    rs129 = False

    def __init__(self, rs129: bool = False):
        self.rs129 = rs129
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

    def required_data(self) -> int:
        return FRAME_SIZE

    def set_slot_filter(self, flt: int) -> None:
        self.slot_filter = flt
        if ((self.active_slot + 1) & flt) == 0:
            self.active_slot = -1

    # -- helpers ---------------------------------------------------------
    def _meta_with_slot(self, slot: int, fn) -> None:
        if self.meta is not None:
            self.meta.with_slot(slot, fn)

    def process(self, data: np.ndarray, output: Output):
        cach = Cach.parse(data)
        # slots alternate; override allowed by 100%-confident TACT
        # (dmr_phase.cpp:66-99). With slot == -1, the reference's
        # ``slot ^ 1`` lands in an unsigned char as 254, which can never
        # match a TACT slot of 0/1 — reproduce that.
        next_slot = (self.slot ^ 1) & 0xFF
        if cach.has_tact():
            tact_slot = cach.tact.slot()
            if tact_slot != next_slot:
                if self.slot_stability < 5:
                    self.slot_stability = 0
                    self.slot = tact_slot
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
                self.slot_stability += 1
                if self.slot_stability > 100:
                    self.slot_stability = 100
                self.slot = next_slot
        elif self.slot != -1:
            self.slot_stability -= 1
            if self.slot_stability < -100:
                self.slot_stability = -100
            self.slot = next_slot

        if self.slot != -1:
            ret = self._process_slot(data, output)
            if ret is not None:
                return ret, 0

        return None, FRAME_SIZE

    def _process_slot(self, data: np.ndarray, output: Output):
        """Returns SyncPhase() to drop out, else None."""
        slot = self.slot
        sync_type = get_sync_type(data[SYNC_OFFSET:SYNC_OFFSET + SYNC_SIZE])
        if sync_type > 0:
            self.sync_count = min(self.sync_count + 1, 5)
            self.slot_sync_count[slot] = min(self.slot_sync_count[slot] + 1, 5)
            soft_reset = (self.sync_types[slot] == SYNCTYPE_VOICE
                          and sync_type != self.sync_types[slot])
            self.sync_types[slot] = sync_type

            def update(s, sync_type=sync_type, soft=soft_reset):
                s.set_sync(sync_type)
                if soft:
                    s.soft_reset()

            self._meta_with_slot(slot, update)
            self.superframe_counter[slot] = 0
            self.emb_collectors[slot].reset()
        elif (self.sync_types[slot] == SYNCTYPE_VOICE
              and self.superframe_counter[slot] < 5):
            # voice superframe: frames 2-6 carry EMB + embedded data
            # (dmr_phase.cpp:117-187)
            self.superframe_counter[slot] += 1
            emb_word = 0
            for i in range(2):
                off = SYNC_OFFSET + i * 20
                for k in range(4):
                    emb_word = ((emb_word << 2) | int(data[off + k])) & 0xFFFF
            emb = Emb.parse(emb_word)
            if emb is not None:
                self.sync_count = min(self.sync_count + 1, 5)
                self.slot_sync_count[slot] = min(
                    self.slot_sync_count[slot] + 1, 5)
                fragment = bytearray(4)
                raw = data[SYNC_OFFSET + 4:SYNC_OFFSET + 20]
                for i in range(16):
                    fragment[i // 4] |= int(raw[i]) << (6 - (i % 4) * 2)
                collector = self.emb_collectors[slot]
                lcss = emb.lcss()
                if lcss == LCSS_SINGLE:
                    pass  # RC data, unused (dmr_phase.cpp:156-158)
                elif lcss in (LCSS_START, LCSS_CONTINUATION):
                    if lcss == LCSS_START:
                        collector.reset()
                    collector.collect(bytes(fragment))
                elif lcss == LCSS_STOP:
                    collector.collect(bytes(fragment))
                    lc = collector.get_lc()
                    if lc is not None:
                        self._handle_lc(lc)
                    collector.reset()
            else:
                # no sync and no EMB: decrement counters, then fall
                # through to the payload section (dmr_phase.cpp:171-187)
                if self._lose_sync(slot):
                    return SyncPhase()
        else:
            self.superframe_counter[slot] = 0
            self.emb_collectors[slot].reset()
            if self._lose_sync(slot):
                return SyncPhase()

        if self.sync_types[slot] == SYNCTYPE_VOICE:
            if (((slot + 1) & self.slot_filter)
                    and self.active_slot in (-1, slot)):
                self.active_slot = slot
                payload = np.concatenate([
                    data[CACH_SIZE:CACH_SIZE + 54],
                    data[CACH_SIZE + 54 + SYNC_SIZE:
                         CACH_SIZE + 54 + SYNC_SIZE + 54],
                ])
                output.write(pack_dibits(payload))
        else:
            if self.active_slot == slot:
                self.active_slot = -1
            self.talker_alias[slot].reset()
            if self.sync_types[slot] == SYNCTYPE_DATA:
                self._process_data_frame(data, slot)
            else:
                self._meta_with_slot(slot, lambda s: s.reset())
        return None

    def _lose_sync(self, slot: int) -> bool:
        """Decrement counters; True when the frame phase must exit
        (dmr_phase.cpp:171-205)."""
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

    def _process_data_frame(self, data: np.ndarray, slot: int) -> None:
        """SlotType golay -> BPTC(196,96) -> LC (dmr_phase.cpp:235-296)."""
        word = 0
        for i in range(5):
            word = (word << 2) | int(data[SYNC_OFFSET - 5 + i])
        for i in range(5):
            word = (word << 2) | int(data[SYNC_OFFSET + SYNC_SIZE + i])
        slot_type = SlotType.parse(word)
        if slot_type is None:
            return
        data_type = slot_type.data_type()
        if data_type == DATA_TYPE_RATE_3_4_DATA:
            return  # only type without BPTC; not decoded (dmr_phase.cpp:245)
        dibits = np.concatenate([
            data[CACH_SIZE:CACH_SIZE + 49],
            data[CACH_SIZE + 54 + SYNC_SIZE + 5:
                 CACH_SIZE + 54 + SYNC_SIZE + 5 + 49],
        ]).astype(np.int64)
        bits196 = np.zeros(196, dtype=np.int64)
        bits196[0::2] = (dibits >> 1) & 1
        bits196[1::2] = dibits & 1
        data_bits, ok = bptc.decode_np(bits196)
        if not bool(ok):
            return
        lc_bytes = np.packbits(data_bits.astype(np.uint8)).tobytes()
        if data_type == DATA_TYPE_VOICE_LC:
            if self.rs129:
                ok, corrected = rs.check(lc_bytes,
                                         mask=rs.MASK_VOICE_LC_HEADER)
                if not ok:
                    return  # uncorrectable LC: drop instead of garbling
                lc_bytes = corrected
            lc = Lc.parse_from_voice_header(lc_bytes)
            if lc is not None:
                self._handle_lc(lc)
        elif data_type in (DATA_TYPE_TERMINATOR_LC, DATA_TYPE_IDLE):
            self._meta_with_slot(slot, lambda s: s.soft_reset())

    def _handle_lc(self, lc: Lc) -> None:
        """(dmr_phase.cpp:304-339)"""
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
