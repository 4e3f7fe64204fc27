"""YSF phase machine (src/ysf_decoder/ysf_phase.cpp).

Frame = 480 dibits: 20 sync + 100 FICH + 360 payload. The FICH is cached
across frames (``running_fich``); payload dispatch follows its frame type:
COMMUNICATION (V/D1, V/D2 "DN", VoiceFR "VW", DataFR stub), HEADER
(CSD1/CSD2 -> dest/src/down/up), TERMINATOR -> reset. Sync hysteresis
counter caps at 12.

Voice payload decoders produce ``mode byte + packed AMBE bytes`` per block,
feeding the dynamic-mode MBE synthesizer — sizes 10 (V1), 8 (DN), 19 (VW)
per block (ysf_phase.cpp:71-129).

Copy of ``digiham_tpu/protocols/ysf/phases.py``; the sync word and the
voice tables live in ``constants.py``.
"""
from __future__ import annotations

import numpy as np

from ..fec import interleave
from ..decoder import Output, Phase
from ..utils import convert_to_utf8
from .constants import (  # noqa: F401 (re-exported)
    FICH_SIZE,
    FRAME_SIZE,
    SYNC_SIZE,
    TRIBIT_MAJORITY,
    V2_VOICE_MAPPING,
    YSF_SYNC,
)
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
from .primitives import (
    bits_to_bytes,
    crc16_ok,
    dewhiten,
    dibits_to_bits,
    trellis_decode,
)

PAYLOAD_SIZE = 360

_BIT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def is_sync(window: np.ndarray) -> bool:
    w = np.asarray(window[:SYNC_SIZE], np.uint8)
    return int(_BIT_LUT[w ^ YSF_SYNC].sum()) <= 3


def treat_ysf_string(raw: bytes) -> str:
    """Truncate at '\\n' or ' ' then convert ISO-8859-1 -> UTF-8
    (ysf_phase.cpp:351-361)."""
    length = 10
    for c in (b"\n", b" "):
        idx = raw[:length].find(c)
        if idx >= 0:
            length = idx
    return convert_to_utf8(raw[:length])


def decode_v1_voice(dibits36: np.ndarray) -> bytes:
    """V/D1 voice block -> 9 bytes. Reference parity note: the reference
    uses ``=`` instead of ``|=`` (ysf_phase.cpp:175-177), so each byte only
    retains the *last* dibit written to it; reproduced bit-for-bit."""
    out = bytearray(9)
    for k in range(36):
        out[k // 4] = (int(dibits36[k]) & 3) << (6 - 2 * (k % 4))
    return bytes(out)


def decode_v2_voice(dibits52: np.ndarray) -> bytes:
    """V/D2 voice block -> 7 bytes AMBE (ysf_phase.cpp:180-219)."""
    bits104 = dibits_to_bits(dibits52[:52])
    deinterleaved = bits104[interleave.ysf_v2_voice()]
    tri = dewhiten(deinterleaved)
    # 27 tribit-majority bits from bits 0..80
    groups = tri[:81].reshape(27, 3)
    idx = (groups[:, 0] << 2) | (groups[:, 1] << 1) | groups[:, 2]
    voice = np.zeros(49, np.uint8)
    voice[:27] = TRIBIT_MAJORITY[idx]
    voice[27:49] = tri[81:103]
    # output interleave: result[mapping[i]] = voice[i]
    result = np.zeros(56, np.uint8)
    result[V2_VOICE_MAPPING] = voice
    return bits_to_bytes(result)


def decode_fr_voice(dibits72: np.ndarray) -> bytes:
    """VW full-rate voice block -> 18 bytes (ysf_phase.cpp:308-315)."""
    return bits_to_bytes(dibits_to_bits(dibits72[:72]))


def decode_v2_dch(payload: np.ndarray) -> tuple[np.ndarray, bool]:
    """V/D2 data channel: de-interleave + Viterbi + CRC + dewhiten ->
    (10 bytes, ok) (ysf_phase.cpp:258-267)."""
    dch_dibits = payload[interleave.ysf_dch_v2()]
    bits, _ = trellis_decode(dch_dibits)
    by = bits_to_bytes(bits)
    checksum = (by[10] << 8) | by[11]
    if not crc16_ok(bits[:80], checksum):
        return np.zeros(10, np.uint8), False
    clear = dewhiten(bits)
    return np.frombuffer(bits_to_bytes(clear)[:10], np.uint8), True


def decode_header_dch(payload: np.ndarray, block: int) -> bytes | None:
    """Header/terminator data channel -> 20 bytes or None
    (ysf_phase.cpp:317-349)."""
    dch_dibits = payload[interleave.ysf_dch_header(block)]
    bits, _ = trellis_decode(dch_dibits)
    by = bits_to_bytes(bits)
    checksum = (by[20] << 8) | by[21]
    if not crc16_ok(bits[:160], checksum):
        return None
    return bits_to_bytes(dewhiten(bits[:160]))


class SyncPhase(Phase):
    """Symbol-by-symbol hunt for D471C9634D (ysf_phase.cpp:21-33)."""

    MAX_SCAN = 4096

    def required_data(self) -> int:
        return SYNC_SIZE

    def process(self, data: np.ndarray, output: Output):
        data = data[:SYNC_SIZE - 1 + self.MAX_SCAN]
        windows = np.lib.stride_tricks.sliding_window_view(data, SYNC_SIZE)
        dist = _BIT_LUT[windows ^ YSF_SYNC].sum(axis=1)
        hits = np.nonzero(dist <= 3)[0]
        if len(hits) == 0:
            return None, windows.shape[0]
        # frame starts AT the sync (no pre-advance: ysf_phase.cpp:27)
        return FramePhase(), int(hits[0])


class FramePhase(Phase):
    def __init__(self):
        self.sync_count = 0
        self.running_fich: Fich | None = None
        self.data_collector = DataCollector()
        self.expect_sub_frame = False

    def required_data(self) -> int:
        return FRAME_SIZE

    def process(self, data: np.ndarray, output: Output):
        if is_sync(data):
            self.sync_count = min(self.sync_count + 1, 12)
        else:
            self.sync_count -= 1
            if self.sync_count < 0:
                if self.meta is not None:
                    self.meta.reset()
                return SyncPhase(), 0

        fich = Fich.parse(data[SYNC_SIZE:SYNC_SIZE + FICH_SIZE])
        if fich is not None:
            self.running_fich = fich

        payload = data[SYNC_SIZE + FICH_SIZE:FRAME_SIZE]

        rf = self.running_fich
        if rf is not None:
            ft = rf.frame_type()
            if ft == FRAME_TYPE_COMMUNICATION_CHANNEL:
                self._communication(rf, fich, payload, output)
            elif ft == FRAME_TYPE_HEADER_CHANNEL:
                self._header(payload)
            elif ft == FRAME_TYPE_TERMINATOR_CHANNEL:
                if self.meta is not None:
                    self.meta.reset()
        return None, FRAME_SIZE

    # -- frame type handlers --------------------------------------------
    def _communication(self, rf: Fich, fich: Fich | None,
                       payload: np.ndarray, output: Output) -> None:
        dt = rf.data_type()
        if dt == DATA_TYPE_VD_TYPE_1:
            if self.meta is not None:
                self.meta.set_mode("V1")
            for i in range(5):
                block = payload[36 + i * 72:36 + i * 72 + 36]
                output.write(bytes([dt]) + decode_v1_voice(block))
        elif dt == DATA_TYPE_VD_TYPE_2:
            if self.meta is not None:
                self.meta.set_mode("DN")
            for i in range(5):
                block = payload[20 + i * 72:20 + i * 72 + 52]
                output.write(bytes([dt]) + decode_v2_voice(block))
            # DCH needs the *current* frame's FICH for the frame number
            # (ysf_phase.cpp:100-108)
            if fich is not None:
                dch, ok = decode_v2_dch(payload)
                if ok:
                    self._handle_v2_dch(bytes(dch), fich.frame_number())
        elif dt == DATA_TYPE_VOICE_FR:
            if self.meta is not None:
                self.meta.set_mode("VW")
            start_frame = 3 if self.expect_sub_frame else 0
            self.expect_sub_frame = False
            for i in range(start_frame, 5):
                block = payload[i * 72:i * 72 + 72]
                output.write(bytes([dt]) + decode_fr_voice(block))
        elif dt == DATA_TYPE_DATA_FR:
            if self.meta is not None:
                self.meta.set_mode("FR data")

    def _handle_v2_dch(self, dch: bytes, frame_number: int) -> None:
        """(ysf_phase.cpp:269-306)"""
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
        """(ysf_phase.cpp:131-156)"""
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
