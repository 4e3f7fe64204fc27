"""Static de-interleaver index tables (port of
``digiham_tpu/fec/interleave.py``: the tables of the DMR, YSF, NXDN and
D-Star paths, and the numpy ``deinterleave``/``depuncture`` the host
machines apply them with). Indices map output position -> input position:
``deinterleaved = x[..., table]``."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def bptc_196() -> np.ndarray:
    """DMR BPTC(196,96) de-interleave: out[i] = in[i*181 % 196]
    (src/dmr_decoder/bptc_196_96.c:12-17)."""
    return np.array([(i * 181) % 196 for i in range(196)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ysf_fich() -> np.ndarray:
    """YSF FICH 5x20 dibit de-interleave (src/ysf_decoder/fich.cpp:15-19):
    out dibit i <- in dibit (i*20) % 100 + (i*20) // 100."""
    return np.array([(i * 20) % 100 + (i * 20) // 100 for i in range(100)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ysf_v2_voice() -> np.ndarray:
    """YSF V/D2 voice: 26 rows x 4 cols bit de-interleave over 104 bits
    (src/ysf_decoder/ysf_phase.cpp:180-219): output bit i <- input bit
    (i % 26) * 4 + i // 26."""
    return np.array([(i % 26) * 4 + i // 26 for i in range(104)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ysf_dch_v2() -> np.ndarray:
    """YSF V/D2 data channel: the 20-dibit DCH prefix of each of the 5
    payload blocks with 20x5 interleaving (ysf_phase.cpp:100-106): out
    dibit i <- payload dibit (i % 5) * 72 + i // 5, indices into the
    360-dibit payload."""
    return np.array([(i % 5) * 72 + i // 5 for i in range(100)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ysf_dch_header(block: int = 0) -> np.ndarray:
    """YSF header/terminator data channel: 20x9 dibit de-interleave over 180
    dibits pulled from the first 36 dibits of each 72-dibit payload block
    (ysf_phase.cpp:322-334): streampos = (i % 9) * 20 + i // 9, then
    inpos = (streampos // 36) * 72 + streampos % 36 (+36 for the 2nd DCH)."""
    idx = np.zeros(180, dtype=np.int32)
    for i in range(180):
        streampos = (i % 9) * 20 + i // 9
        idx[i] = (streampos // 36) * 72 + streampos % 36 + 36 * block
    return idx


def _rowcol(rows: int, cols: int) -> np.ndarray:
    """Block de-interleave: out[k*rows + i] = in[i*cols + k]."""
    idx = np.zeros(rows * cols, dtype=np.int32)
    for i in range(rows):
        for k in range(cols):
            idx[k * rows + i] = i * cols + k
    return idx


@functools.lru_cache(maxsize=None)
def nxdn_sacch() -> np.ndarray:
    """NXDN SACCH: 12x5 bit de-interleave over 60 bits
    (src/nxdn_decoder/sacch.cpp:46-55): out[k*12+i] = in[i*5+k]."""
    return _rowcol(12, 5)


@functools.lru_cache(maxsize=None)
def nxdn_facch1() -> np.ndarray:
    """NXDN FACCH1: 16x9 bit de-interleave over 144 bits
    (src/nxdn_decoder/facch1.cpp:40-49): out[k*16+i] = in[i*9+k]."""
    return _rowcol(16, 9)


@functools.lru_cache(maxsize=None)
def dstar_header() -> np.ndarray:
    """D-Star 660-bit radio header de-interleave
    (src/dstar_decoder/header.cpp:56-68): the first 12 columns have 28
    rows, the remaining 12 have 27."""
    idx = np.zeros(660, dtype=np.int32)
    for i in range(12):
        for k in range(28):
            idx[k * 24 + i] = i * 28 + k
    for i in range(12, 24):
        for k in range(27):
            idx[k * 24 + i] = 12 + i * 27 + k
    return idx


def _depuncture(length: int, punctured) -> tuple[np.ndarray, np.ndarray]:
    """(gather_idx, mask) that inflate a punctured bit vector to
    ``length``: output[i] = mask[i] ? input[gather_idx[i]] : 0, with a 0
    wherever ``punctured(i)``."""
    idx = np.zeros(length, dtype=np.int32)
    mask = np.zeros(length, dtype=bool)
    pos = 0
    for i in range(length):
        if not punctured(i):
            idx[i] = pos
            mask[i] = True
            pos += 1
    return idx, mask


@functools.lru_cache(maxsize=None)
def depuncture_mask_sacch() -> tuple[np.ndarray, np.ndarray]:
    """NXDN SACCH 'inflate' (sacch.cpp:57-68): 60 bits -> 72, a 0 at every
    position where (i+1) % 6 == 0."""
    return _depuncture(72, lambda i: (i + 1) % 6 == 0)


@functools.lru_cache(maxsize=None)
def depuncture_mask_facch1() -> tuple[np.ndarray, np.ndarray]:
    """NXDN FACCH1 'inflate' (facch1.cpp:52-61): 144 bits -> 192, a 0
    wherever (i-1) % 4 == 0."""
    return _depuncture(192, lambda i: (i - 1) % 4 == 0)


def deinterleave(x: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Apply a de-interleave gather on the last axis."""
    return x[..., table]


def depuncture(bits: np.ndarray, table: tuple[np.ndarray, np.ndarray]):
    """Inflate [..., N] bits to the padded length using (idx, mask)."""
    idx, mask = table
    return np.where(mask, np.asarray(bits)[..., idx], 0)
