"""DMR voice bursts for the latency program (the port's copy of the TX
code it needs from tests/dmr_synth.py, which imports the JAX package):
144-dibit voice frames with a valid CACH/TACT and a sync pattern or an EMB
with its embedded-LC fragment. ``tests/test_torch_bench.py`` holds it
equal to the test suite's synthesizer."""
import numpy as np

from ..fec.codes import HAMMING_7_4, QR_16_7
from ..protocols.dmr.components import LCSS_CONTINUATION
from ..protocols.dmr.constants import (BS_VOICE_SYNC, CACH_SIZE, FRAME_SIZE,
                                       MS_VOICE_SYNC, SYNC_OFFSET, SYNC_SIZE,
                                       TACT_POSITIONS)


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
