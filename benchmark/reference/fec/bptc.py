"""DMR BPTC(196,96) product-code decode (port of ``digiham_tpu/fec/bptc.py``).

De-interleave with ``source = i*181 % 196``, skip the leading R(3) pad bit,
decode 15 columns as Hamming(13,9) then 9 rows as Hamming(15,11), and
extract 96 data bits (row 0 gives bits 11..4, rows 1-8 bits 14..4).
``decode`` runs on tensors of any device; ``decode_np`` is its numpy twin
for the host phase machines and ``encode`` the TX/test path.
"""
from __future__ import annotations

import functools

import numpy as np

from . import interleave
from .codes import HAMMING_13_9, HAMMING_15_11
from .linear import decode_np as _decode_np


@functools.lru_cache(maxsize=None)
def column_source() -> np.ndarray:
    """[15, 13] indices into the RECEIVED 196 bits: column i, element k is
    de-interleaved bit k*15 + i + 1 (MSB of the 13-bit column word first),
    with the de-interleave folded in so decoding needs one gather."""
    cols = np.array([[k * 15 + i + 1 for k in range(13)] for i in range(15)])
    return interleave.bptc_196()[cols].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _data_bit_gather() -> np.ndarray:
    """[96] (row, bit position) pairs: which row word and which bit of it
    (counted from MSB = 14) hold each of the 96 data bits."""
    pairs = [(0, pos) for pos in range(11, 3, -1)]
    pairs += [(r, pos) for r in range(1, 9) for pos in range(14, 3, -1)]
    return np.asarray(pairs, dtype=np.int32)


def decode_np(bits196: np.ndarray):
    """Host-side numpy twin of :func:`decode`: [..., 196] 0/1 ->
    (data_bits [..., 96] int64, ok [...] bool)."""
    bits196 = np.asarray(bits196, dtype=np.int64)
    cols_bits = bits196[..., column_source()]
    weights13 = np.array([1 << (12 - k) for k in range(13)], dtype=np.int64)
    col_words = (cols_bits * weights13).sum(-1)
    col_corr, col_ok = _decode_np(HAMMING_13_9, col_words)
    ok = col_ok.all(-1)
    row_idx = np.arange(9)
    col_bits = (col_corr[..., None, :] >> (12 - row_idx[:, None])) & 1
    weights15 = np.array([1 << (14 - k) for k in range(15)], dtype=np.int64)
    row_words = (col_bits * weights15).sum(-1)
    row_corr, row_ok = _decode_np(HAMMING_15_11, row_words)
    ok = ok & row_ok.all(-1)
    gb = _data_bit_gather()
    data_bits = (row_corr[..., gb[:, 0]] >> gb[:, 1]) & 1
    return data_bits, ok


def encode(data_bits: np.ndarray) -> np.ndarray:
    """TX/test path: [..., 96] data bits -> [..., 196] interleaved bits."""
    data_bits = np.asarray(data_bits, dtype=np.int64)
    shape = data_bits.shape[:-1]
    # place data bits into rows 0..8 (row 0 top 3 bits reserved = 0)
    gb = _data_bit_gather()
    row_words = np.zeros(shape + (9,), dtype=np.int64)
    for b in range(96):
        r, pos = gb[b]
        row_words[..., r] |= data_bits[..., b] << pos
    # row FEC: bits 3..0 of each row from Hamming(15,11) of its 11 data bits
    enc_rows = HAMMING_15_11.encode(row_words >> 4)
    # column FEC: 15 columns of 9 bits, extended to 13 by Hamming(13,9)
    col_words = np.zeros(shape + (15,), dtype=np.int64)
    for i in range(15):
        col9 = np.zeros(shape, dtype=np.int64)
        for r in range(9):
            col9 = (col9 << 1) | ((enc_rows[..., r] >> (14 - i)) & 1)
        col_words[..., i] = HAMMING_13_9.encode(col9)
    # de-interleaved vector: bit 0 = R(3) pad = 0, bit k*15+i+1 = column i
    # word bit (12-k); then transmitted[source index] = de-interleaved[i]
    flat = np.zeros(shape + (196,), dtype=np.int64)
    for i in range(15):
        for k in range(13):
            flat[..., k * 15 + i + 1] = (col_words[..., i] >> (12 - k)) & 1
    out = np.zeros_like(flat)
    out[..., interleave.bptc_196()] = flat
    return out
