"""DMR Tier II transmissions: both TDMA slots in a voice call at once,
each slot a voice-LC header, voice superframes with the embedded LC and a
terminator with LC, bursts alternating between the slots (the copy of
``digiham_tpu_torch/bench/dmr_synth.py``)."""
import numpy as np

from ..reference.dmr.components import (DATA_TYPE_TERMINATOR_LC,
                                        DATA_TYPE_VOICE_LC,
                                        LCSS_CONTINUATION, LCSS_START,
                                        LCSS_STOP)
from ..reference.dmr.constants import (BS_DATA_SYNC, BS_VOICE_SYNC,
                                       CACH_SIZE, FRAME_SIZE, MS_VOICE_SYNC,
                                       SYNC_OFFSET, SYNC_SIZE, TACT_POSITIONS)
from ..reference.fec import bptc, rs129
from ..reference.fec.codes import (GOLAY_20_8, HAMMING_7_4, HAMMING_16_11,
                                   QR_16_7)

SYMBOL_RATE = 4800
BURST_SECONDS = FRAME_SIZE / SYMBOL_RATE  # 30 ms
HEADERS = 3  # voice-LC header bursts a slot before the voice
DOTTING = np.array([0, 2], np.uint8)
LEAD = 40  # dotting pairs before a transmission


def make_cach(slot: int, busy: int = 0, lcss: int = 0) -> np.ndarray:
    """12 CACH dibits with a valid Hamming(7,4) TACT."""
    data4 = (busy << 3) | (slot << 2) | lcss
    tact7 = int(HAMMING_7_4.encode(data4))
    bits = np.zeros(24, dtype=np.uint8)
    for i, pos in enumerate(TACT_POSITIONS):
        bits[pos] = (tact7 >> (6 - i)) & 1
    dibits = (bits[0::2] << 1) | bits[1::2]
    return dibits.astype(np.uint8)


def voice_frame(slot: int, payload108=None, sync=True,
                emb_fragment: bytes | None = None,
                lcss: int = LCSS_CONTINUATION, ms=False) -> np.ndarray:
    """Voice burst: CACH + 2 x 54-dibit voice payload + sync or EMB."""
    frame = np.zeros(FRAME_SIZE, dtype=np.uint8)
    frame[:CACH_SIZE] = make_cach(slot)
    if payload108 is None:
        payload108 = np.arange(108) % 4
    payload108 = np.asarray(payload108, dtype=np.uint8)
    frame[CACH_SIZE:CACH_SIZE + 54] = payload108[:54]
    frame[CACH_SIZE + 54 + SYNC_SIZE:] = payload108[54:]
    if sync:
        frame[SYNC_OFFSET:SYNC_OFFSET + SYNC_SIZE] = \
            MS_VOICE_SYNC if ms else BS_VOICE_SYNC
    else:
        # EMB halves + 16-dibit embedded fragment
        emb16 = int(QR_16_7.encode((1 << 3) | (0 << 2) | lcss))
        emb_dibits = [(emb16 >> (14 - 2 * i)) & 3 for i in range(8)]
        frame[SYNC_OFFSET:SYNC_OFFSET + 4] = emb_dibits[:4]
        frame[SYNC_OFFSET + 20:SYNC_OFFSET + 24] = emb_dibits[4:]
        if emb_fragment is None:
            emb_fragment = b"\x00" * 4
        for i in range(16):
            frame[SYNC_OFFSET + 4 + i] = (
                emb_fragment[i // 4] >> (6 - (i % 4) * 2)) & 3
    return frame


def group_lc(target: int, source: int, opcode: int = 0) -> bytes:
    """9-byte group-call LC: opcode, FID 0, a pad byte, target, source."""
    return bytes([opcode & 0x3F, 0, 0,
                  (target >> 16) & 0xFF, (target >> 8) & 0xFF, target & 0xFF,
                  (source >> 16) & 0xFF, (source >> 8) & 0xFF, source & 0xFF])


def data_frame(slot: int, data_type: int, lc9: bytes,
               sync=BS_DATA_SYNC) -> np.ndarray:
    """Data burst: CACH + BPTC(196,96) payload (the LC and its masked
    RS(12,9) parity) + SlotType (color code 1) + data sync."""
    frame = np.zeros(FRAME_SIZE, dtype=np.uint8)
    frame[:CACH_SIZE] = make_cach(slot)
    frame[SYNC_OFFSET:SYNC_OFFSET + SYNC_SIZE] = sync
    word20 = int(GOLAY_20_8.encode((1 << 4) | data_type))
    st_dibits = [(word20 >> (18 - 2 * i)) & 3 for i in range(10)]
    frame[SYNC_OFFSET - 5:SYNC_OFFSET] = st_dibits[:5]
    frame[SYNC_OFFSET + SYNC_SIZE:SYNC_OFFSET + SYNC_SIZE + 5] = st_dibits[5:]
    mask = {1: rs129.MASK_VOICE_LC_HEADER,
            2: rs129.MASK_TERMINATOR_WITH_LC}.get(data_type, 0)
    parity = bytes(b ^ mask for b in rs129.encode(lc9))
    data_bits = np.unpackbits(np.frombuffer(lc9 + parity, np.uint8))
    bits196 = bptc.encode(data_bits.astype(np.int64))
    dibits98 = ((bits196[0::2] << 1) | bits196[1::2]).astype(np.uint8)
    frame[CACH_SIZE:CACH_SIZE + 49] = dibits98[:49]
    frame[CACH_SIZE + 54 + SYNC_SIZE + 5:
          CACH_SIZE + 54 + SYNC_SIZE + 5 + 49] = dibits98[49:]
    return frame


def embedded_fragments(lc9: bytes) -> list:
    """A 9-byte LC as 4 embedded fragments of 4 bytes (Hamming(16,11) rows,
    5-bit checksum, column parity, 8 x 16 interleave)."""
    lc = list(lc9)
    checksum = sum(lc) % 31
    rows = [0] * 7
    rows[0] = (lc[0] << 8) | (lc[1] & 0b11100000)
    rows[1] = ((lc[1] & 0b00011111) << 11) | ((lc[2] & 0b11111100) << 3)
    rows[2] = ((lc[2] & 0b00000011) << 14) | (lc[3] << 6)
    rows[3] = (lc[4] << 8) | (lc[5] & 0b11000000)
    rows[4] = ((lc[5] & 0b00111111) << 10) | ((lc[6] & 0b11110000) << 2)
    rows[5] = ((lc[6] & 0b00001111) << 12) | ((lc[7] & 0b11111100) << 4)
    rows[6] = ((lc[7] & 0b00000011) << 14) | (lc[8] << 6)
    for i in range(5):  # checksum bit (4-i) -> bit 5 of row i+2
        rows[i + 2] |= ((checksum >> (4 - i)) & 1) << 5
    full = [int(HAMMING_16_11.encode(r >> 5)) for r in rows]
    parity_row = 0
    for r in full:
        parity_row ^= r
    matrix = full + [parity_row]
    data16 = bytearray(16)
    for i in range(16):
        for k in range(8):
            data16[i] |= ((matrix[k] >> (15 - i)) & 1) << (7 - k)
    return [bytes(data16[j * 4:j * 4 + 4]) for j in range(4)]


def voice_superframe(slot: int, lc9: bytes, payloads) -> list:
    """6 voice bursts: A with sync, B-E carrying the embedded LC, F with
    sync; ``payloads`` gives each burst's 108 voice dibits."""
    frames = [voice_frame(slot, payloads[0], sync=True)]
    lcsses = [LCSS_START, LCSS_CONTINUATION, LCSS_CONTINUATION, LCSS_STOP]
    for i, (frag, lcss) in enumerate(zip(embedded_fragments(lc9), lcsses)):
        frames.append(voice_frame(slot, payloads[1 + i], sync=False,
                                  emb_fragment=frag, lcss=lcss))
    frames.append(voice_frame(slot, payloads[5], sync=True))
    return frames


def slot_call(rng, slot: int, superframes: int) -> list:
    """One slot's bursts of a group call: voice-LC headers, voice
    superframes with fresh voice in every burst, a terminator with LC."""
    lc = group_lc(int(rng.integers(1, 1 << 24)), int(rng.integers(1, 1 << 24)))
    bursts = [data_frame(slot, DATA_TYPE_VOICE_LC, lc)] * HEADERS
    for _ in range(superframes):
        bursts += voice_superframe(slot, lc, rng.integers(0, 4, (6, 108)))
    bursts.append(data_frame(slot, DATA_TYPE_TERMINATOR_LC, lc))
    return bursts


def call(rng, seconds: float, variant: int = 0) -> np.ndarray:
    """About ``seconds`` of air: a dotting lead, then both slots in a call,
    their bursts alternating (one variant only)."""
    superframes = max(1, int(round(seconds / (12 * BURST_SECONDS))))
    a, b = slot_call(rng, 0, superframes), slot_call(rng, 1, superframes)
    bursts = [f for pair in zip(a, b) for f in pair]
    return np.concatenate([np.tile(DOTTING, LEAD)] + bursts).astype(np.uint8)
