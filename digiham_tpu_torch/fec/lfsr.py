"""LFSR whitening and scrambler keystreams (port of
``digiham_tpu/fec/lfsr.py``: the YSF, D-Star and NXDN streams).

Each scrambler of the reference is an LFSR with a fixed initial state, so
its output is one fixed keystream and descrambling is an XOR with a
constant array (``dewhiten_bits``, ``descramble_dibits_nxdn`` on numpy).

- ysf_whitening: 9-bit LFSR, init 0b111001001, taps 0 and 4, output = LSB
  (src/ysf_decoder/whitening.c:6-22)
- dstar_scrambler: 7-bit LFSR, init 0b1111111, output = bit0 ^ bit3
  (src/dstar_decoder/scrambler.cpp:10-22)
- nxdn_scrambler: 9-bit LFSR, init 0b011100100, output = LSB, applied to
  the high bit of each dibit (src/nxdn_decoder/scrambler.cpp:12-25)
"""
from __future__ import annotations

import functools

import numpy as np


def _keystream(init: int, nbits_reg: int, length: int, *,
               out_fn, fb_fn) -> np.ndarray:
    reg = init
    out = np.zeros(length, dtype=np.uint8)
    mask = (1 << nbits_reg) - 1
    for i in range(length):
        out[i] = out_fn(reg)
        fb = fb_fn(reg)
        reg = ((reg >> 1) | (fb << (nbits_reg - 1))) & mask
    return out


@functools.lru_cache(maxsize=None)
def ysf_whitening(length: int = 4096) -> np.ndarray:
    """Keystream bit i XORs payload bit i (MSB-first packed)."""
    return _keystream(
        0b111001001, 9, length,
        out_fn=lambda r: r & 1,
        fb_fn=lambda r: ((r >> 4) & 1) ^ (r & 1),
    )


@functools.lru_cache(maxsize=None)
def dstar_scrambler(length: int = 4096) -> np.ndarray:
    """Keystream bit i XORs stream bit i (one bit per byte in the reference
    symbol stream). Output bit = reg0 ^ reg3, which is also the feedback."""
    return _keystream(
        0b1111111, 7, length,
        out_fn=lambda r: (r & 1) ^ ((r >> 3) & 1),
        fb_fn=lambda r: (r & 1) ^ ((r >> 3) & 1),
    )


@functools.lru_cache(maxsize=None)
def nxdn_scrambler(length: int = 4096) -> np.ndarray:
    """Keystream bit i flips the *high bit* of dibit i (symbol sign flip)."""
    return _keystream(
        0b011100100, 9, length,
        out_fn=lambda r: r & 1,
        fb_fn=lambda r: ((r >> 4) & 1) ^ (r & 1),
    )


def dewhiten_bits(bits: np.ndarray, keystream: np.ndarray, offset: int = 0):
    """XOR a [..., N] bit array with keystream[offset:offset+N]."""
    n = bits.shape[-1]
    return bits ^ keystream[offset:offset + n]


def descramble_dibits_nxdn(dibits: np.ndarray, offset: int = 0) -> np.ndarray:
    """XOR keystream onto the high bit of each dibit ([..., N] values 0-3)."""
    ks = nxdn_scrambler()[offset:offset + dibits.shape[-1]]
    return dibits ^ (ks.astype(dibits.dtype) << 1)
