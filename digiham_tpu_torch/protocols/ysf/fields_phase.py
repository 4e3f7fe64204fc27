"""YsfFieldsFramePhase: the YSF frame machine over device-decoded fields.

Mirror of ``phases.FramePhase`` (ysf_phase.cpp:45-172) consuming the rows
``pipeline.ysf.ysf_decode_frames`` computes in batch. The common
steady-state path — V/D2 "DN" frames (sync check, FICH, 5 voice blocks,
DCH) — comes entirely from fields; the rare frame types (V/D1, VW,
FR-data, HEADER, TERMINATOR) fall back to the host routines on the raw
frame dibits, so behavior is identical for every frame type.

Copy of ``digiham_tpu/protocols/ysf/fields_phase.py``.
"""
from __future__ import annotations

import numpy as np

from .data import DataCollector
from .fich import (
    DATA_TYPE_DATA_FR,
    DATA_TYPE_VD_TYPE_1,
    DATA_TYPE_VD_TYPE_2,
    DATA_TYPE_VOICE_FR,
    FRAME_TYPE_COMMUNICATION_CHANNEL,
    FRAME_TYPE_HEADER_CHANNEL,
    FRAME_TYPE_TERMINATOR_CHANNEL,
    Fich,
)
from .phases import (
    FICH_SIZE,
    FRAME_SIZE,
    SYNC_SIZE,
    decode_fr_voice,
    decode_header_dch,
    decode_v1_voice,
    treat_ysf_string,
)


class YsfFrameFields:
    __slots__ = ("sync_dist", "fich_ok", "fich_data", "vd2_voice",
                 "vd2_dch_ok", "vd2_dch")

    def __init__(self, sync_dist, fich_ok, fich_data, vd2_voice,
                 vd2_dch_ok, vd2_dch):
        self.sync_dist = sync_dist
        self.fich_ok = fich_ok
        self.fich_data = fich_data
        self.vd2_voice = vd2_voice      # [5] x 7 bytes
        self.vd2_dch_ok = vd2_dch_ok
        self.vd2_dch = vd2_dch          # 10 bytes


class YsfFieldsFramePhase:
    def __init__(self, meta=None):
        self.meta = meta
        self.sync_count = 0
        self.running_fich: Fich | None = None
        self.data_collector = DataCollector()
        self.expect_sub_frame = False

    def process_fields(self, f: YsfFrameFields, frame: np.ndarray):
        """Returns (voice_bytes, lost_lock, keep_from)."""
        out = []
        if f.sync_dist <= 3:
            self.sync_count = min(self.sync_count + 1, 12)
        else:
            self.sync_count -= 1
            if self.sync_count < 0:
                if self.meta is not None:
                    self.meta.reset()
                return b"", True, 0

        fich = Fich(f.fich_data) if f.fich_ok else None
        if fich is not None:
            self.running_fich = fich

        payload = frame[SYNC_SIZE + FICH_SIZE:FRAME_SIZE]
        rf = self.running_fich
        if rf is not None:
            ft = rf.frame_type()
            if ft == FRAME_TYPE_COMMUNICATION_CHANNEL:
                dt = rf.data_type()
                if dt == DATA_TYPE_VD_TYPE_2:
                    if self.meta is not None:
                        self.meta.set_mode("DN")
                    for i in range(5):
                        out.append(bytes([dt]) + f.vd2_voice[i])
                    if fich is not None and f.vd2_dch_ok:
                        self._handle_v2_dch(f.vd2_dch,
                                            fich.frame_number())
                elif dt == DATA_TYPE_VD_TYPE_1:
                    if self.meta is not None:
                        self.meta.set_mode("V1")
                    for i in range(5):
                        block = payload[36 + i * 72:36 + i * 72 + 36]
                        out.append(bytes([dt]) + decode_v1_voice(block))
                elif dt == DATA_TYPE_VOICE_FR:
                    if self.meta is not None:
                        self.meta.set_mode("VW")
                    start = 3 if self.expect_sub_frame else 0
                    self.expect_sub_frame = False
                    for i in range(start, 5):
                        block = payload[i * 72:i * 72 + 72]
                        out.append(bytes([dt]) + decode_fr_voice(block))
                elif dt == DATA_TYPE_DATA_FR:
                    if self.meta is not None:
                        self.meta.set_mode("FR data")
            elif ft == FRAME_TYPE_HEADER_CHANNEL:
                self._header(payload)
            elif ft == FRAME_TYPE_TERMINATOR_CHANNEL:
                if self.meta is not None:
                    self.meta.reset()
        return b"".join(out), False, 0

    # identical to phases.FramePhase helpers -----------------------------
    def _handle_v2_dch(self, dch: bytes, frame_number: int) -> None:
        meta = self.meta
        if frame_number < 6:
            if meta is not None:
                if frame_number == 0:
                    meta.set_destination(treat_ysf_string(dch))
                elif frame_number == 1:
                    meta.set_source(treat_ysf_string(dch))
                elif frame_number == 2:
                    meta.set_down(treat_ysf_string(dch))
                elif frame_number == 3:
                    meta.set_up(treat_ysf_string(dch))
            self.data_collector.reset()
        if 6 <= frame_number < 8:
            self.data_collector.collect(dch, frame_number - 6)
        if self.data_collector.has_collected(2):
            frame = self.data_collector.get_data_frame()
            if frame is not None and meta is not None:
                meta.set_gps(frame.get_gps_coordinate())

    def _header(self, payload: np.ndarray) -> None:
        meta = self.meta
        if meta is not None:
            meta.reset()
            meta.hold()
        dch = decode_header_dch(payload, 0)
        if dch is not None and meta is not None:
            meta.set_destination(treat_ysf_string(dch[:10]))
            meta.set_source(treat_ysf_string(dch[10:20]))
        dch = decode_header_dch(payload, 1)
        if dch is not None and meta is not None:
            meta.set_down(treat_ysf_string(dch[:10]))
            meta.set_up(treat_ysf_string(dch[10:20]))
        if meta is not None:
            meta.release()
        self.expect_sub_frame = True
