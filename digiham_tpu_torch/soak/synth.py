"""The TX side of the five protocols for the soak programs (the port's
copies of tests/ysf_synth.py, tests/nxdn_synth.py, the D-Star and POCSAG
builders of tests/test_dstar.py and tests/test_pocsag.py, the stream
builders of tools/fuzz_timesharded.py and the DMR modulator of
tests/test_impaired_rf.py), built on the port's own tables. DMR voice
bursts come from :mod:`..bench.dmr_synth`. ``tests/test_torch_soak.py``
holds every builder equal to the original on the same seeds."""
import numpy as np

from ..bench.dmr_synth import voice_frame
from ..fec import interleave
from ..fec.codes import BCH_31_21
from ..fec.crc import crc6_nxdn, crc12_nxdn, crc16_ysf
from ..fec.lfsr import dstar_scrambler, ysf_whitening
from ..fec.viterbi import conv_encode
from ..protocols.dstar.header import encode_header
from ..protocols.dstar.phases import HEADER_SYNC, VOICE_SYNC
from ..protocols.nxdn import constants as nxdn_c
from ..protocols.nxdn.components import Scrambler
from ..protocols.pocsag import CODEWORDS_PER_SYNC, IDLE_CODEWORD, SYNC_PATTERN
from ..protocols.ysf.constants import (FICH_SIZE, FRAME_SIZE, SYNC_SIZE,
                                       V2_VOICE_MAPPING, YSF_SYNC)
from ..protocols.ysf.fich import encode_fich

FS = 48000.0
FOUR_LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3  # indexed by dibit
DSTAR_LEVELS = np.array([-1.0, 1.0])
POCSAG_LEVELS = np.array([1.0, -1.0])

# --- DMR: the modulated test call of tests/test_impaired_rf.py --------------

DMR_DEVIATION, DMR_SPS = 1944.0, 10
DMR_PAYLOAD = np.tile([1, 3, 0, 2], 27)
DOTTING = np.array([0, 2], np.uint8)


def modulate(dibits, sps: int = DMR_SPS, deviation: float = DMR_DEVIATION,
             fs: float = FS) -> np.ndarray:
    """Rect 4FSK at ``sps``: each dibit's level times ``deviation`` Hz,
    continuous phase, unit-amplitude complex64 I/Q."""
    freq = np.repeat(FOUR_LEVELS[np.asarray(dibits)], sps) * deviation
    phase = 2 * np.pi * np.cumsum(freq) / fs
    return np.exp(1j * phase).astype(np.complex64)


def dmr_call(n_frames: int) -> np.ndarray:
    """The TX dibits of a DMR call: a dotting lead of 80 dibits, then
    ``n_frames`` voice frames with sync alternating between the two slots
    (payload :data:`DMR_PAYLOAD`), then a dotting tail of 400."""
    frames = [voice_frame(s % 2, DMR_PAYLOAD, sync=True)
              for s in range(n_frames)]
    return np.concatenate([np.tile(DOTTING, 40)] + frames
                          + [np.tile(DOTTING, 200)]).astype(np.uint8)


# --- YSF (tests/ysf_synth.py) ----------------------------------------------

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


# --- NXDN (tests/nxdn_synth.py) --------------------------------------------

def _conv_and_puncture(bits, keep_mask_len, skip_fn):
    coded = conv_encode(np.asarray(bits, np.int64)).astype(np.uint8)
    coded_bits = np.empty(len(coded) * 2, np.uint8)
    coded_bits[0::2] = (coded >> 1) & 1
    coded_bits[1::2] = coded & 1
    return np.array([coded_bits[i] for i in range(keep_mask_len)
                     if not skip_fn(i)], np.uint8)


def encode_sacch_unit(structure_index: int, payload18: np.ndarray,
                      scramble: bool = True) -> np.ndarray:
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
    if scramble:
        dibits = Scrambler.descramble(dibits, 8)  # self-inverse
    return dibits


def encode_facch1(message_type: int, scramble_offset: int | None):
    """-> 72 dibits."""
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
    if scramble_offset is not None:
        dibits = Scrambler.descramble(dibits, scramble_offset)
    return dibits


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


def nxdn_frame(lich_args, sacch_dibits=None, slots=None) -> np.ndarray:
    """Assemble a 192-dibit frame. slots: list of 2 dibit arrays (already
    scrambled) or None -> zero fill."""
    frame = np.zeros(nxdn_c.FRAME_SIZE, np.uint8)
    frame[:nxdn_c.SYNC_SIZE] = nxdn_c.FRAME_SYNC
    frame[nxdn_c.SYNC_SIZE:nxdn_c.SYNC_SIZE + 8] = encode_lich(*lich_args)
    pos = nxdn_c.SYNC_SIZE + 8
    if sacch_dibits is not None:
        frame[pos:pos + 30] = sacch_dibits
    pos += 30
    for i in range(2):
        if slots is not None and slots[i] is not None:
            frame[pos:pos + 72] = slots[i]
        pos += 72
    return frame


# --- D-Star (tests/test_dstar.py) ------------------------------------------

def make_header_bytes(dest="DIRECT", dep="DIRECT", companion="CQCQCQ",
                      own="W1AW", suffix="705", voice=True):
    data = bytearray(39)
    data[0] = 0 if voice else 0x80
    data[3:11] = dest.ljust(8).encode()[:8]
    data[11:19] = dep.ljust(8).encode()[:8]
    data[19:27] = companion.ljust(8).encode()[:8]
    data[27:35] = own.ljust(8).encode()[:8]
    data[35:39] = suffix.ljust(4).encode()[:4]
    return bytes(data)


def scramble24(data3: bytes) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data3, np.uint8), bitorder="little")
    return bits ^ dstar_scrambler()[:24]


def dstar_voice_frame(voice9: bytes = b"\xAA" * 9, data3: bytes = b"\x66" * 3,
                      raw_data24=None) -> np.ndarray:
    voice_bits = np.unpackbits(np.frombuffer(voice9, np.uint8),
                               bitorder="little")
    if raw_data24 is None:
        raw_data24 = scramble24(data3)
    return np.concatenate([voice_bits, raw_data24])


def bit_sync_preamble(n=64):
    return np.tile(np.array([1, 0], np.uint8), n // 2)


def full_voice_stream(n_frames=25, message_frames=None):
    """header sync + header + n voice frames (sync frame every 21st)."""
    parts = [bit_sync_preamble(), HEADER_SYNC,
             encode_header(make_header_bytes())]
    fc = 20  # a voice sync is due immediately after the header
    for _ in range(n_frames):
        if fc >= 20:
            parts.append(dstar_voice_frame(raw_data24=VOICE_SYNC))
            fc = 0
        else:
            data3 = b"\x66\x66\x66"
            if message_frames and fc in message_frames:
                data3 = message_frames[fc]
            parts.append(dstar_voice_frame(data3=data3))
            fc += 1
    return parts


# --- POCSAG (tests/test_pocsag.py) -----------------------------------------

def u32_bits(word):
    return np.array([(word >> (31 - i)) & 1 for i in range(32)], np.uint8)


def make_codeword(info21: int) -> int:
    """info21 -> 32-bit codeword: BCH(31,21) + even parity bit (LSB)."""
    word31 = int(BCH_31_21.encode(info21))
    parity = bin(word31).count("1") & 1
    return (word31 << 1) | parity


def address_codeword(address18: int, func: int) -> int:
    return make_codeword((0 << 20) | (address18 << 2) | func)


def data_codeword(payload20: int) -> int:
    return make_codeword((1 << 20) | payload20)


def alpha_payloads(text: str):
    """Pack text into 20-bit payloads: 7-bit chars, LSB first per char,
    then 20 bits MSB first per codeword."""
    bits = []
    for ch in text:
        c = ord(ch)
        bits.extend((c >> k) & 1 for k in range(7))
    while len(bits) % 20:
        bits.append(0)
    out = []
    for i in range(0, len(bits), 20):
        word = 0
        for j in range(20):
            word |= bits[i + j] << (19 - j)
        out.append(word)
    return out


def build_stream(codewords, preamble_bits=96):
    """Alternating preamble + sync + 16-codeword batches."""
    bits = [np.tile(np.array([1, 0], np.uint8), preamble_bits // 2)]
    for i in range(0, len(codewords), CODEWORDS_PER_SYNC):
        batch = codewords[i:i + CODEWORDS_PER_SYNC]
        batch = batch + [IDLE_CODEWORD] * (CODEWORDS_PER_SYNC - len(batch))
        bits.append(SYNC_PATTERN)
        for cw in batch:
            bits.append(u32_bits(cw))
    # trailing sync + idles so the decoder's re-sync check passes
    bits.append(SYNC_PATTERN)
    for _ in range(CODEWORDS_PER_SYNC):
        bits.append(u32_bits(IDLE_CODEWORD))
    return np.concatenate(bits)


# --- random streams of tools/fuzz_timesharded.py ---------------------------

def dmr_dibits(rng):
    parts = [rng.integers(0, 4, int(rng.integers(20, 400)))]
    payload = rng.integers(0, 4, 108)
    for _ in range(int(rng.integers(1, 4))):
        n_frames = int(rng.integers(30, 120))
        parts += [voice_frame(s % 2, payload, sync=True)
                  for s in range(n_frames)]
        parts.append(rng.integers(0, 4, int(rng.integers(50, 600))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def ysf_dibits(rng):
    parts = [rng.integers(0, 4, int(rng.integers(20, 300))),
             header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
    for i in range(int(rng.integers(18, 40))):
        parts.append(vd2_frame(i % 8, b"FUZZTSHYSF"))
    parts.append(terminator_frame())
    parts.append(rng.integers(0, 4, int(rng.integers(50, 400))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def nxdn_dibits(rng):
    units = vcall_superframe_bytes(int(rng.integers(0, 8)),
                                   int(rng.integers(1, 1 << 16)),
                                   int(rng.integers(1, 1 << 16)))
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(20, 300)))]
    for i in range(int(rng.integers(16, 34))):
        slots = [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 38 + 72)]
        parts.append(nxdn_frame((0b01, 0b10, 0b11),
                                encode_sacch_unit(i % 4, units[i % 4]),
                                slots))
    parts.append(np.zeros(300, np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def dstar_bits(rng):
    parts = full_voice_stream(int(rng.integers(80, 200)))
    parts.append(np.zeros(400, np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def pocsag_bits(rng):
    parts = [np.zeros(100, np.uint8)]
    for m in range(int(rng.integers(5, 12))):
        cws = [address_codeword(int(rng.integers(1, 1 << 18)), 3)]
        cws += [data_codeword(p) for p in alpha_payloads(f"FZ {m}")]
        parts.append(build_stream(cws))
        parts.append(np.zeros(int(rng.integers(60, 200)), np.uint8))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])
