"""NXDN48 conventional voice transmissions: a FACCH1 VCALL frame, voice
frames whose SACCH superframe carries the call's VCALL (call type, source
and destination), and a FACCH1 TX_RELEASE frame (the copy of
``digiham_tpu_torch/soak/synth.py``'s NXDN builders).

A call's kind by its variant (``assumed``: no published share of call
kinds is in the repository): group calls half the calls (variants 0 and
2), individual calls a quarter (variant 1), and a quarter group calls in
which slot 0 of every fourth voice frame carries FACCH1, the VCALL
repeated for late entry (variant 3)."""
import numpy as np

from ..reference.fec import interleave
from ..reference.fec.crc import crc6_nxdn, crc12_nxdn
from ..reference.fec.viterbi import conv_encode
from ..reference.nxdn.components import (CALL_TYPE_CONFERENCE,
                                         CALL_TYPE_INDIVIDUAL,
                                         MESSAGE_TYPE_TX_RELEASE,
                                         MESSAGE_TYPE_VCALL,
                                         RF_CHANNEL_TYPE_RTCH,
                                         USC_TYPE_SACCH_NON_SF,
                                         USC_TYPE_SACCH_SF, Scrambler)
from ..reference.nxdn.constants import FRAME_SIZE, FRAME_SYNC

SYMBOL_RATE = 2400
FRAME_SECONDS = FRAME_SIZE / SYMBOL_RATE  # 80 ms
DOTTING = np.array([0, 2], np.uint8)
LEAD = 40  # dotting pairs before a transmission
# LICH option bits, slot 0 high: 1 = voice, 0 = FACCH1 (steal flags)
VOICE_VOICE, FACCH_VOICE, FACCH_FACCH = 0b11, 0b01, 0b00
SLOT_OFFSETS = (38, 38 + 72)  # the slots' in-frame scrambler offsets
# a call's (call type, late-entry FACCH1) by its variant
VARIANTS = ((CALL_TYPE_CONFERENCE, False), (CALL_TYPE_INDIVIDUAL, False),
            (CALL_TYPE_CONFERENCE, False), (CALL_TYPE_CONFERENCE, True))


def _conv_and_puncture(bits, keep_mask_len, skip_fn):
    coded = conv_encode(np.asarray(bits, np.int64)).astype(np.uint8)
    coded_bits = np.empty(len(coded) * 2, np.uint8)
    coded_bits[0::2] = (coded >> 1) & 1
    coded_bits[1::2] = coded & 1
    return np.array([coded_bits[i] for i in range(keep_mask_len)
                     if not skip_fn(i)], np.uint8)


def encode_sacch_unit(structure_index: int,
                      payload18: np.ndarray) -> np.ndarray:
    """-> 30 dibits (scrambled at in-frame offset 8)."""
    info = np.zeros(26, np.uint8)
    s = structure_index ^ 0b11
    info[0] = (s >> 1) & 1
    info[1] = s & 1
    info[8:26] = payload18
    crc = int(crc6_nxdn(26).compute_np(info))
    bits36 = np.concatenate([
        info, np.array([(crc >> (5 - i)) & 1 for i in range(6)], np.uint8),
        np.zeros(4, np.uint8)])
    punctured = _conv_and_puncture(bits36, 72, lambda i: (i + 1) % 6 == 0)
    # inverse of the 12x5 de-interleave: interleaved[table[j]] = punctured[j]
    bits60 = np.zeros(60, np.uint8)
    bits60[interleave.nxdn_sacch()] = punctured
    dibits = ((bits60[0::2] << 1) | bits60[1::2]).astype(np.uint8)
    return Scrambler.descramble(dibits, 8)  # self-inverse


def encode_facch1(message_type: int, scramble_offset: int) -> np.ndarray:
    """-> 72 dibits (scrambled at in-frame offset ``scramble_offset``)."""
    info = np.zeros(80, np.uint8)
    for i in range(6):
        info[2 + i] = (message_type >> (5 - i)) & 1
    crc = int(crc12_nxdn(80).compute_np(info))
    bits96 = np.concatenate([
        info, np.array([(crc >> (11 - i)) & 1 for i in range(12)], np.uint8),
        np.zeros(4, np.uint8)])
    punctured = _conv_and_puncture(bits96, 192, lambda i: (i - 1) % 4 == 0)
    bits144 = np.zeros(144, np.uint8)
    bits144[interleave.nxdn_facch1()] = punctured
    dibits = ((bits144[0::2] << 1) | bits144[1::2]).astype(np.uint8)
    return Scrambler.descramble(dibits, scramble_offset)


def encode_lich(rf_type, functional, option, direction=0) -> np.ndarray:
    byte = (rf_type << 5) | (functional << 3) | (option << 1) | direction
    bits = [(byte >> (6 - i)) & 1 for i in range(7)]
    check = bits[0] ^ bits[1] ^ bits[2] ^ bits[3]
    dibits = np.array([b << 1 for b in bits + [check]], np.uint8)
    return Scrambler.descramble(dibits, 0)


def vcall_superframe_bytes(call_type, source, dest) -> np.ndarray:
    """9 superframe bytes -> [4, 18] per-unit payload bits."""
    data = bytearray(9)
    data[0] = 0x01  # VCALL
    data[2] = (call_type & 7) << 5
    data[3] = (source >> 8) & 0xFF
    data[4] = source & 0xFF
    data[5] = (dest >> 8) & 0xFF
    data[6] = dest & 0xFF
    bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
    return bits[:72].reshape(4, 18)


def voice_slot_dibits(payload72, offset) -> np.ndarray:
    """Scramble a raw 72-dibit voice payload for slot at in-frame offset."""
    return Scrambler.descramble(np.asarray(payload72, np.uint8), offset)


def nxdn_frame(lich_args, sacch_dibits, slots) -> np.ndarray:
    """Assemble a 192-dibit frame: sync, LICH, the SACCH's 30 dibits and
    the 2 slots' 72 each (already scrambled)."""
    return np.concatenate([FRAME_SYNC, encode_lich(*lich_args),
                           sacch_dibits, *slots]).astype(np.uint8)


def facch_frame(message_type: int, sacch_dibits) -> np.ndarray:
    """A frame of the call's control: both slots FACCH1 ``message_type``,
    the SACCH outside a superframe."""
    return nxdn_frame(
        (RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_NON_SF, FACCH_FACCH),
        sacch_dibits, [encode_facch1(message_type, o) for o in SLOT_OFFSETS])


def call(rng, seconds: float, variant: int = 0) -> np.ndarray:
    """About ``seconds`` of air: a dotting lead, a FACCH1 VCALL frame,
    voice frames with fresh voice in every slot and the SACCH cycling
    through the 4 units of the call's VCALL superframe, a FACCH1
    TX_RELEASE frame."""
    n = max(1, int(round(seconds / FRAME_SECONDS)) - 2)
    call_type, late_entry = VARIANTS[variant % len(VARIANTS)]
    units = vcall_superframe_bytes(call_type, int(rng.integers(1, 1 << 16)),
                                   int(rng.integers(1, 1 << 16)))
    sacch = [encode_sacch_unit(k, units[k]) for k in range(4)]
    late = encode_facch1(MESSAGE_TYPE_VCALL, SLOT_OFFSETS[0])
    frames = [facch_frame(MESSAGE_TYPE_VCALL, sacch[0])]
    for i in range(n):
        slots = [voice_slot_dibits(rng.integers(0, 4, 72), o)
                 for o in SLOT_OFFSETS]
        option = VOICE_VOICE
        if late_entry and i % 4 == 3:
            option, slots[0] = FACCH_VOICE, late
        frames.append(nxdn_frame(
            (RF_CHANNEL_TYPE_RTCH, USC_TYPE_SACCH_SF, option), sacch[i % 4],
            slots))
    frames.append(facch_frame(MESSAGE_TYPE_TX_RELEASE, sacch[0]))
    return np.concatenate([np.tile(DOTTING, LEAD)] + frames).astype(np.uint8)
