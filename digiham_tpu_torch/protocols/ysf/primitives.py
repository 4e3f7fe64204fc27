"""YSF bit-level primitives shared by FICH and payload decoding.

All operate on numpy bit/dibit arrays; the Viterbi hot path delegates to
the host decode ``fec.viterbi.viterbi_decode_np`` (the native library for
one sequence).

Copy of ``digiham_tpu/protocols/ysf/primitives.py``.
"""
from __future__ import annotations

import numpy as np

from ...fec.crc import crc16_ysf
from ...fec.lfsr import ysf_whitening
from ...fec.viterbi import viterbi_decode_np


def trellis_decode(dibits: np.ndarray) -> tuple[np.ndarray, int]:
    """Rate-1/2 K=5 Viterbi over a dibit array -> (bits, metric)
    (src/ysf_decoder/trellis.c:32-109)."""
    bits, metric = viterbi_decode_np(np.asarray(dibits, np.int64))
    return bits.astype(np.uint8), int(metric)


def dewhiten(bits: np.ndarray) -> np.ndarray:
    """XOR with the PN keystream (src/ysf_decoder/whitening.c:6-22)."""
    bits = np.asarray(bits, np.uint8)
    return bits ^ ysf_whitening()[:len(bits)]


def crc16_ok(bits: np.ndarray, checksum: int) -> bool:
    """CRC-16 over a bit vector vs a received checksum
    (src/ysf_decoder/crc16.c:3-26)."""
    return int(crc16_ysf(len(bits)).compute_np(bits)) == checksum


def bits_to_int(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """[..., N] dibits -> [..., 2N] bits, high bit first."""
    d = np.asarray(dibits, np.uint8)
    out = np.empty(d.shape[:-1] + (d.shape[-1] * 2,), np.uint8)
    out[..., 0::2] = (d >> 1) & 1
    out[..., 1::2] = d & 1
    return out
