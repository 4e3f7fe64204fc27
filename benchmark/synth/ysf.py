"""Yaesu System Fusion transmissions: a header with its callsigns, then
communication frames of one mode (DN: V/D mode 2 with DCH callsigns; V/D
mode 1; VW full rate), then a terminator (the copy of
``digiham_tpu_torch/soak/synth.py``'s YSF builders)."""
import numpy as np

from ..reference.fec import interleave
from ..reference.fec.crc import crc16_ysf
from ..reference.fec.lfsr import ysf_whitening
from ..reference.fec.viterbi import conv_encode
from ..reference.ysf.constants import (FICH_SIZE, FRAME_SIZE, SYNC_SIZE,
                                       V2_VOICE_MAPPING, YSF_SYNC)
from ..reference.ysf.fich import encode_fich

SYMBOL_RATE = 4800
FRAME_SECONDS = FRAME_SIZE / SYMBOL_RATE  # 100 ms
DOTTING = np.array([0, 2], np.uint8)
LEAD = 40  # dotting pairs before a transmission
# a call's mode by its variant: DN (V/D mode 2) half the calls, V/D
# mode 1 and VW a quarter each
MODES = ("vd2", "vd1", "vd2", "vw")
CALLSIGN_LETTERS = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
                                 np.uint8)


def make_fich_word(frame_type, data_type, frame_number=0):
    return ((frame_type & 3) << 30) | ((frame_number & 7) << 19) \
        | ((data_type & 3) << 8)


def bits_from_bytes(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8))


def whiten_bits(bits: np.ndarray) -> np.ndarray:
    return bits ^ ysf_whitening()[:len(bits)]


def encode_v2_dch(content10: bytes) -> np.ndarray:
    """10 content bytes -> 100 interleaved payload dibits (DCH slots)."""
    clear_bits = bits_from_bytes(content10)  # 80
    whitened = whiten_bits(np.concatenate([clear_bits,
                                           np.zeros(20, np.uint8)]))[:80]
    crc = int(crc16_ysf(80).compute_np(whitened))
    bits100 = np.concatenate([
        whitened,
        bits_from_bytes(bytes([(crc >> 8) & 0xFF, crc & 0xFF])),
        np.zeros(4, np.uint8),
    ])[:100]
    return conv_encode(bits100.astype(np.int64)).astype(np.uint8)


def encode_v2_voice(ambe7: bytes) -> np.ndarray:
    """7 AMBE bytes -> 52 voice dibits (inverse of decode_v2_voice)."""
    result_bits = bits_from_bytes(ambe7)[:56]
    voice = result_bits[V2_VOICE_MAPPING]  # [49]
    tri = np.zeros(104, np.uint8)
    # tribit-encode the first 27 bits
    tri[:81] = np.repeat(voice[:27], 3)
    tri[81:103] = voice[27:49]
    whitened = tri ^ ysf_whitening()[:104]
    interleaved = np.zeros(104, np.uint8)
    interleaved[interleave.ysf_v2_voice()] = whitened
    dibits = (interleaved[0::2] << 1) | interleaved[1::2]
    return dibits.astype(np.uint8)


def encode_header_dch(content20: bytes, block: int, payload: np.ndarray):
    """Scatter a 20-byte header DCH into the payload array in place."""
    clear = bits_from_bytes(content20)  # 160
    whitened = whiten_bits(np.concatenate(
        [clear, np.zeros(40, np.uint8)]))[:160]
    crc = int(crc16_ysf(160).compute_np(whitened))
    bits184 = np.concatenate([
        whitened,
        bits_from_bytes(bytes([(crc >> 8) & 0xFF, crc & 0xFF])),
        np.zeros(4, np.uint8),
    ])[:180]
    dibits = conv_encode(bits184.astype(np.int64)).astype(np.uint8)
    payload[interleave.ysf_dch_header(block)] = dibits


def vd2_frame(frame_number: int, dch10: bytes, ambe7: bytes = b"\x55" * 7,
              data_type=2, frame_type=1) -> np.ndarray:
    """One V/D2 communication frame."""
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = YSF_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
        make_fich_word(frame_type, data_type, frame_number))
    payload = frame[SYNC_SIZE + FICH_SIZE:]
    payload[interleave.ysf_dch_v2()] = encode_v2_dch(dch10)
    voice = encode_v2_voice(ambe7)
    for i in range(5):
        payload[20 + i * 72:20 + i * 72 + 52] = voice
    return frame


def header_frame(dest: bytes, src: bytes, down: bytes, up: bytes,
                 frame_type=0) -> np.ndarray:
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = YSF_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
        make_fich_word(frame_type, 2))
    payload = frame[SYNC_SIZE + FICH_SIZE:]
    encode_header_dch((dest + b" " * 10)[:10] + (src + b" " * 10)[:10], 0,
                      payload)
    encode_header_dch((down + b" " * 10)[:10] + (up + b" " * 10)[:10], 1,
                      payload)
    return frame


def v1_frame(frame_number: int, voice36=None) -> np.ndarray:
    """One V/D1 communication frame: 5 x (36 DCH + 36 raw voice
    dibits)."""
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = YSF_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
        make_fich_word(1, 0, frame_number))
    payload = frame[SYNC_SIZE + FICH_SIZE:]
    if voice36 is None:
        voice36 = np.tile([1, 2, 3, 0], 9)
    for i in range(5):
        payload[36 + i * 72:36 + i * 72 + 36] = voice36
    return frame


def vw_frame(frame_number: int, voice18: bytes = b"\xA5" * 18) -> np.ndarray:
    """One VW (full-rate voice) frame: 5 x 72 raw voice dibits."""
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = YSF_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(
        make_fich_word(1, 3, frame_number))
    payload = frame[SYNC_SIZE + FICH_SIZE:]
    bits = np.unpackbits(np.frombuffer(voice18, np.uint8))
    block = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)
    for i in range(5):
        payload[i * 72:i * 72 + 72] = block
    return frame


def terminator_frame() -> np.ndarray:
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = YSF_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + FICH_SIZE] = encode_fich(make_fich_word(2, 2))
    return frame


def callsign(rng) -> bytes:
    return CALLSIGN_LETTERS[rng.integers(0, len(CALLSIGN_LETTERS),
                                         int(rng.integers(4, 7)))].tobytes()


def call(rng, seconds: float, variant: int = 0) -> np.ndarray:
    """About ``seconds`` of air: a dotting lead, a header with the call's
    callsigns, communication frames of the variant's mode with fresh
    voice in every frame (V/D2 frames carry the callsigns in their DCH,
    by frame number), a terminator."""
    n = max(1, int(round(seconds / FRAME_SECONDS)) - 2)
    dest, src = b"ALL", callsign(rng)
    mode = MODES[variant % len(MODES)]
    frames = [header_frame(dest, src, b"DOWN", b"UP")]
    dch = [(dest + b" " * 10)[:10], (src + b" " * 10)[:10]]
    for i in range(n):
        fn = i % 8
        if mode == "vd2":
            frames.append(vd2_frame(
                fn, dch[fn % 2],
                rng.integers(0, 256, 7, dtype=np.uint8).tobytes()))
        elif mode == "vd1":
            frames.append(v1_frame(fn, rng.integers(0, 4, 36)))
        else:
            frames.append(vw_frame(
                fn, rng.integers(0, 256, 18, dtype=np.uint8).tobytes()))
    frames.append(terminator_frame())
    return np.concatenate([np.tile(DOTTING, LEAD)] + frames).astype(np.uint8)
