"""POCSAG pager decoder (copy of ``digiham_tpu/protocols/pocsag.py``).

Reference: src/pocsag_decoder/ — bit-level sync on a 32-bit preamble word
(hamming distance <= 3, pocsag_phase.cpp:10-12), then batches of 16
codewords per sync with a re-sync hysteresis counter capped at 2
(pocsag_phase.cpp:38-52). Each 32-bit codeword carries BCH(31,21) over its
top 31 bits plus even parity over all 32 (codeword.cpp:9-31). Address
codewords open a Message (numeric type 0 / alphanumeric type 3 only,
address = 18 data bits << 3 | frame position, pocsag_phase.cpp:63-73); data
codewords append 20 payload bits; idle or invalid codewords flush
(pocsag_phase.cpp:55-88). Messages serialize directly into the payload
stream as ``address:..;message:..\\n`` (message.cpp:17-24).

Sync correlation and the BCH decode are batched tensor functions
(``sync_distances``, ``parse_codewords``); the phase machine itself is
control plane (O(codewords), tiny integer state) and follows the reference
transition for transition. A codeword is an int64 holding the unsigned
32-bit word (the JAX package's uint32): torch's uint32 has no shifts, and
int32 would put bit 31 in the sign.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fec.codes import BCH_31_21
from ..fec.linear import decode as _decode, decode_np as _decode_np, popcount
from ..ops.correlate import sync_correlate
from ..runtime.decoder import Decoder, Output, Phase
from ..runtime.meta import StringSerializer

SYNC_SIZE = 32
CODEWORD_SIZE = 32
CODEWORDS_PER_SYNC = 16
MAX_MESSAGE_LENGTH = 80
IDLE_CODEWORD = 0b01111010100010011100000110010111  # codeword.hpp:22

# Function bits that open a Message. The reference opens one ONLY for fn
# bits 1 (numeric-typed as tone?) and 3 (alphanumeric) — pocsag_phase.cpp:70
# — leaving the type-0 BCD decoder in message.cpp:46-60 dead in practice.
# We reproduce that default; tests widen this to exercise the numeric
# (type-0) path end-to-end so the BCD decoder cannot rot.
OPEN_FUNCTION_BITS = (1, 3)

# 32-bit preamble word as a bit array (pocsag_phase.hpp:15)
SYNC_PATTERN = np.array(
    [0, 1, 1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0,
     0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 0, 1, 1, 0, 0, 0],
    dtype=np.uint8,
)
# the hunt's hit: a distance <= 3 (pocsag_phase.cpp:10-12); the tracked
# bank's fast skip gates on the same bound
SYNC_BOUND = 3


def _pack_u32(bits: np.ndarray) -> np.ndarray:
    """[..., 32] bits -> u32, first bit = MSB (codeword.cpp:10-13)."""
    weights = (1 << np.arange(31, -1, -1)).astype(np.int64)
    return (np.asarray(bits, np.int64) * weights).sum(-1)


def sync_distances(bits: torch.Tensor,
                   pattern: torch.Tensor | None = None) -> torch.Tensor:
    """Hamming distance of the sync pattern at every bit offset.

    bits: [..., L] 0/1. Returns [..., L - 31] int32 distances — the dense
    replacement for the reference's symbol-at-a-time sync hunt
    (pocsag_phase.cpp:25-28). ``pattern``: ``SYNC_PATTERN`` on
    ``bits.device`` (made when omitted)."""
    if pattern is None:
        pattern = torch.as_tensor(SYNC_PATTERN, device=bits.device)
    return sync_correlate(bits, pattern[None, :], 2)[..., 0]


def parse_codewords(words: torch.Tensor,
                    table: torch.Tensor | None = None):
    """Batched codeword validation (codeword.cpp:9-31).

    words: [...] integers holding 32-bit words (int64, or int32 bit
    patterns; the low 32 bits are read). ``table``: BCH(31,21)'s syndrome
    table on ``words.device`` (built when omitted).
    Returns (corrected word as int64 in [0, 2**32), ok bool)."""
    words = words.to(torch.int64) & 0xFFFFFFFF
    corrected, ok = _decode(BCH_31_21, words >> 1, table)
    # the corrected 31-bit word is non-negative in int32
    full = (words & 1) | (corrected.to(torch.int64) << 1)
    return full, ok & ((popcount(full) & 1) == 0)


def parse_codeword_np(bits: np.ndarray):
    """Host decode of one 32-bit codeword -> (u32, ok)."""
    word = int(_pack_u32(bits))
    corrected, ok = _decode_np(BCH_31_21, word >> 1)
    if not bool(ok):
        return None
    full = (word & 1) | (int(corrected) << 1)
    if bin(full).count("1") & 1:
        return None
    return full


class Codeword:
    """Accessor view over a validated 32-bit codeword (codeword.cpp:36-56)."""

    def __init__(self, data: int):
        self.data = data

    def is_idle(self) -> bool:
        return self.data == IDLE_CODEWORD

    def payload(self) -> int:
        return (self.data >> 11) & ((1 << 20) - 1)

    def is_address(self) -> bool:
        return (self.data >> 31) == 0

    def address(self) -> int:
        return (self.data >> 13) & ((1 << 18) - 1)

    def function_bits(self) -> int:
        return (self.data >> 11) & 0b11


_BCD_MAP = {0xA: "*", 0xB: "U", 0xC: " ", 0xD: "-", 0xE: ")", 0xF: "("}


class Message:
    """Message accumulator (message.cpp:26-72): type 3 = 7-bit chars packed
    LSB-first, type 0 = 5 reversed-BCD digits per codeword."""

    def __init__(self, address: int, mtype: int):
        self.address = address
        self.type = mtype
        self._bytes = bytearray(MAX_MESSAGE_LENGTH)
        self.pos = 0

    def append(self, data: int) -> None:
        if self.type == 3:
            if self.pos + 20 < MAX_MESSAGE_LENGTH * 7:
                for i in range(20):
                    bit = (data >> (19 - i)) & 1
                    self._bytes[self.pos // 7] |= bit << (self.pos % 7)
                    self.pos += 1
        elif self.type == 0:
            if self.pos + 5 < MAX_MESSAGE_LENGTH:
                for i in range(5):
                    nibble = 0
                    base = (4 - i) * 4
                    for k in range(4):
                        nibble |= ((data >> (base + k)) & 1) << (3 - k)
                    if nibble < 0xA:
                        c = chr(ord("0") + nibble)
                    else:
                        c = _BCD_MAP[nibble]
                    self._bytes[self.pos] = ord(c)
                    self.pos += 1

    def serialize(self, serializer: StringSerializer, output: Output) -> None:
        if self.pos == 0:
            return
        content = bytes(self._bytes).split(b"\x00")[0].decode(
            "latin-1", errors="replace")
        output.write(serializer.serialize(
            {"address": str(self.address), "message": content}))


def _has_sync(bits: np.ndarray) -> bool:
    return int((bits[:SYNC_SIZE] ^ SYNC_PATTERN).sum()) <= 3


class SyncPhase(Phase):
    """Bit-by-bit sync hunt (pocsag_phase.cpp:18-28), vectorized: scan the
    whole buffered window for the first offset with distance <= 3."""

    def required_data(self) -> int:
        return SYNC_SIZE

    MAX_SCAN = 8192

    def process(self, data: np.ndarray, output: Output):
        n = min(len(data), SYNC_SIZE - 1 + self.MAX_SCAN)
        data = data[:n]
        if n < SYNC_SIZE:
            return None, 0
        # distances at all complete offsets
        windows = np.lib.stride_tricks.sliding_window_view(
            data[:n], SYNC_SIZE)
        dist = (windows ^ SYNC_PATTERN).sum(axis=1)
        hits = np.nonzero(dist <= SYNC_BOUND)[0]
        if len(hits) == 0:
            return None, len(dist) - 1 + 1 if len(dist) else 0
        return CodewordPhase(), int(hits[0]) + SYNC_SIZE


class CodewordPhase(Phase):
    """16 codewords per sync batch + re-sync hysteresis
    (pocsag_phase.cpp:33-95)."""

    def __init__(self):
        self.sync_count = 1
        self.codeword_counter = 0
        self.current_message: Message | None = None
        self.serializer = StringSerializer()

    def required_data(self) -> int:
        return CODEWORD_SIZE

    def _flush(self, output: Output) -> None:
        if self.current_message is not None:
            self.current_message.serialize(self.serializer, output)
        self.current_message = None

    def process(self, data: np.ndarray, output: Output):
        if self.codeword_counter >= CODEWORDS_PER_SYNC:
            if _has_sync(data):
                self.sync_count += 1
                if self.sync_count > 3:
                    self.sync_count = 2
            else:
                prev = self.sync_count
                self.sync_count -= 1
                if prev < 0:
                    self._flush(output)
                    return SyncPhase(), 0
            self.codeword_counter = 0
            return None, SYNC_SIZE

        word = parse_codeword_np(data[:CODEWORD_SIZE])
        if word is None:
            self.current_message = None
        else:
            cw = Codeword(word)
            if cw.is_idle():
                self._flush(output)
            elif cw.is_address():
                self._flush(output)
                ftype = cw.function_bits()
                if ftype in OPEN_FUNCTION_BITS:
                    address = (cw.address() << 3) | (self.codeword_counter // 2)
                    self.current_message = Message(address, ftype)
            else:
                if self.current_message is not None:
                    self.current_message.append(cw.payload())
        self.codeword_counter += 1
        return None, CODEWORD_SIZE


class PocsagFrameFields:
    """Per-32-bit-window fields from ``pipeline.fsk.pocsag_decode_frames``."""

    __slots__ = ("word", "ok", "sync_dist")

    def __init__(self, word: int, ok: bool, sync_dist: int):
        self.word = word
        self.ok = ok
        self.sync_dist = sync_dist


class PocsagFieldsFramePhase:
    """Tracked-bank frame machine: ``CodewordPhase.process`` on
    precomputed fields (device BCH + sync distance), transition-for-
    transition (pocsag_phase.cpp:33-95). Returns (payload, lost,
    keep_from); on sync loss the re-hunt restarts at the failing window
    (the reference consumes 0 there)."""

    def __init__(self):
        self.cw = CodewordPhase()

    def process_fields(self, f: PocsagFrameFields):
        cw = self.cw
        out = Output()
        if cw.codeword_counter >= CODEWORDS_PER_SYNC:
            if f.sync_dist <= 3:
                cw.sync_count += 1
                if cw.sync_count > 3:
                    cw.sync_count = 2
            else:
                prev = cw.sync_count
                cw.sync_count -= 1
                if prev < 0:
                    cw._flush(out)
                    return out.drain(), True, 0
            cw.codeword_counter = 0
            return out.drain(), False, 0
        if not f.ok:
            cw.current_message = None
        else:
            word = Codeword(int(f.word))
            if word.is_idle():
                cw._flush(out)
            elif word.is_address():
                cw._flush(out)
                ftype = word.function_bits()
                if ftype in OPEN_FUNCTION_BITS:
                    address = (word.address() << 3) \
                        | (cw.codeword_counter // 2)
                    cw.current_message = Message(address, ftype)
            else:
                if cw.current_message is not None:
                    cw.current_message.append(word.payload())
        cw.codeword_counter += 1
        return out.drain(), False, 0


def make_decoder() -> Decoder:
    """Equivalent of Pocsag::Decoder (pocsag_decoder.cpp:6-15): messages go
    into the payload stream, no MetaCollector."""
    return Decoder(SyncPhase(), None)
