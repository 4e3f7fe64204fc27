"""NXDN phase machine (src/nxdn_decoder/nxdn_phase.cpp).

192-dibit frames: 10 sync + 8 LICH + (30 SACCH + 2x72 voice/FACCH1 slots |
174 skipped for RCCH/UDCH). Per-frame scrambler keystream; steal flags from
the LICH option bits pick voice (18-byte output) or FACCH1 per slot;
FACCH1 TX_RELEASE resets back to sync hunting. Sync hysteresis cap 6.

Copy of ``digiham_tpu/protocols/nxdn/phases.py``; the sync word and the
frame geometry live in ``constants.py``.
"""
from __future__ import annotations

import numpy as np

from ...runtime import diag
from ...runtime.decoder import Output, Phase
from .constants import (FRAME_SIZE, FRAME_SYNC, SYNC_BOUND,  # noqa: F401
                        SYNC_SIZE)
from .components import (
    Facch1,
    Lich,
    MESSAGE_TYPE_IDLE,
    MESSAGE_TYPE_TX_RELEASE,
    RF_CHANNEL_TYPE_RCCH,
    Sacch,
    SacchSuperframeCollector,
    Scrambler,
    USC_TYPE_SACCH_SF,
    USC_TYPE_UDCH,
)

_BIT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def is_sync(window: np.ndarray) -> bool:
    w = np.asarray(window[:SYNC_SIZE], np.uint8)
    return int(_BIT_LUT[w ^ FRAME_SYNC].sum()) <= 2


class SyncPhase(Phase):
    MAX_SCAN = 4096

    def required_data(self) -> int:
        return SYNC_SIZE

    def process(self, data: np.ndarray, output: Output):
        data = data[:SYNC_SIZE - 1 + self.MAX_SCAN]
        windows = np.lib.stride_tricks.sliding_window_view(data, SYNC_SIZE)
        dist = _BIT_LUT[windows ^ FRAME_SYNC].sum(axis=1)
        hits = np.nonzero(dist <= SYNC_BOUND)[0]
        if len(hits) == 0:
            return None, windows.shape[0]
        return FramedPhase(), int(hits[0])


class FramedPhase(Phase):
    def __init__(self):
        self.sync_count = 0
        self.lich: Lich | None = None
        self.sacch_collector = SacchSuperframeCollector()

    def required_data(self) -> int:
        return FRAME_SIZE

    def process(self, data: np.ndarray, output: Output):
        if is_sync(data):
            self.sync_count = min(self.sync_count + 1, 6)
        else:
            self.sync_count -= 1
            if self.sync_count < 0:
                if self.meta is not None:
                    self.meta.reset()
                return SyncPhase(), 0
        pos = SYNC_SIZE

        lich_raw = data[pos:pos + 8]
        pos += 8
        new_lich = Lich.parse(Scrambler.descramble(lich_raw, 0))
        if new_lich is not None:
            self.lich = new_lich

        if (self.lich is not None
                and self.lich.rf_type() != RF_CHANNEL_TYPE_RCCH
                and self.lich.functional_type() != USC_TYPE_UDCH):
            sacch_raw = data[pos:pos + 30]
            sacch = Scrambler.descramble(sacch_raw, 8)
            if self.lich.functional_type() == USC_TYPE_SACCH_SF:
                parsed = Sacch.parse(sacch)
                if parsed is not None:
                    self.sacch_collector.push(parsed)
                    if self.sacch_collector.is_complete():
                        sf = self.sacch_collector.get_superframe()
                        if (self.meta is not None and sf is not None):
                            self.meta.set_from_sacch(sf)
                        self.sacch_collector.reset()
            pos += 30

            option = self.lich.option()
            for i in range(2):
                voice = Scrambler.descramble(
                    data[pos:pos + 72], 38 + i * 72)
                if (option >> (1 - i)) & 1:
                    # stolen-flag clear: voice payload
                    if self.sync_count >= 1:
                        if self.meta is not None:
                            self.meta.set_sync("voice")
                        out = bytearray(18)
                        for k in range(72):
                            out[k // 4] |= (int(voice[k]) & 3) << (
                                6 - (k % 4) * 2)
                        output.write(bytes(out))
                else:
                    facch1 = Facch1.parse(voice)
                    if facch1 is not None:
                        mt = facch1.message_type()
                        if mt == MESSAGE_TYPE_TX_RELEASE:
                            if self.meta is not None:
                                self.meta.reset()
                            # exit before consuming the slot
                            # (nxdn_phase.cpp:153-156)
                            return SyncPhase(), pos
                        elif mt == MESSAGE_TYPE_IDLE:
                            pass
                        else:
                            diag.say(f"FACCH1 message type: {mt}")
                pos += 72
        else:
            pos += 174

        return None, pos
