"""Reed-Solomon (12,9) over GF(2^8) for DMR full Link Control.

ETSI TS 102 361-1 B.3.6: the 96-bit full LC (voice header / terminator)
is 9 LC bytes + 3 RS parity bytes, generator polynomial

    g(x) = (x + a)(x + a^2)(x + a^3) = x^3 + 0x0e*x^2 + 0x38*x + 0x40

over GF(256) mod the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D),
with the parity XOR-masked per data type (voice header 0x96,
terminator-with-LC 0x99).

THE REFERENCE DOES NOT CHECK THIS CODE (reference src/dmr_decoder/
lc.cpp:8-11 "TODO: check/correct RS(12,9) FEC" — the 3 parity bytes are
parsed and ignored). This module implements the check plus single-error
correction as an improvement over the reference for a caller that wants
it (host numpy twin of ``digiham_tpu/fec/rs129.py``). The DMR phase
machine calls it on the voice LC header only when asked
(``protocols/dmr/phases.py::FramePhase(rs129=True)``); by default it stays
reference-faithful, so byte/metadata parity holds.

The generator constants are derived, not pasted: expanding
(x+a)(x+a^2)(x+a^3) with a=2 gives x^2: a+a^2+a^3 = 2^4^8 = 0x0e,
x^1: a^3+a^4+a^5 = 8^16^32 = 0x38, x^0: a^6 = 0x40 — asserted at import.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x11D

# log/antilog tables for GF(256) mod 0x11D
_EXP = np.zeros(512, np.int64)
_LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
_EXP[255:510] = _EXP[:255]


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gen_poly():
    """(x + a)(x + a^2)(x + a^3), ascending powers [x^0, x^1, ...]."""
    g = [1]
    for i in (1, 2, 3):
        root = int(_EXP[i])
        ng = [0] * (len(g) + 1)
        for k, c in enumerate(g):
            ng[k + 1] ^= c            # c * x
            ng[k] ^= _mul(c, root)    # c * root
        g = ng
    return g


_G = _gen_poly()
assert _G == [0x40, 0x38, 0x0E, 0x01], _G  # derivation self-check


def encode(data9: bytes) -> bytes:
    """3 RS parity bytes for 9 data bytes (systematic: remainder of
    m(x)*x^3 / g(x); codeword = data9 + parity, highest-degree first)."""
    rem = [0, 0, 0]
    for b in data9[:9]:
        factor = b ^ rem[2]
        rem = [_mul(factor, _G[0]),
               rem[0] ^ _mul(factor, _G[1]),
               rem[1] ^ _mul(factor, _G[2])]
    return bytes([rem[2], rem[1], rem[0]])


def _syndromes(word12: bytes):
    """s_i = c(a^i), i=1..3, with c highest-degree-first."""
    out = []
    for i in (1, 2, 3):
        s = 0
        for b in word12:
            s = _mul(s, int(_EXP[i])) ^ b
        out.append(s)
    return out


def check(word12: bytes, mask: int = 0) -> tuple[bool, bytes]:
    """Validate (and single-error correct) a 12-byte full LC codeword.

    mask: the data-type parity mask (0x96 voice header, 0x99 terminator)
    applied to bytes 9..11 before checking.
    Returns (ok, corrected 9 data bytes). ok=False => uncorrectable."""
    w = bytearray(word12[:12])
    for k in (9, 10, 11):
        w[k] ^= mask
    s1, s2, s3 = _syndromes(bytes(w))
    if s1 == 0 and s2 == 0 and s3 == 0:
        return True, bytes(w[:9])
    # single-symbol error at degree p (position 11-p from the left):
    # s_i = e * a^(i*p)  =>  a^p = s2/s1 = s3/s2, e = s1 / a^p
    if 0 in (s1, s2):
        return False, bytes(w[:9])
    r21 = (_LOG[s2] - _LOG[s1]) % 255
    r32 = (_LOG[s3] - _LOG[s2]) % 255 if s3 else -1
    if r21 != r32 or r21 > 11:
        return False, bytes(w[:9])
    e = int(_EXP[(_LOG[s1] - r21) % 255])
    w[11 - r21] ^= e
    if any(_syndromes(bytes(w))):
        return False, bytes(w[:9])
    return True, bytes(w[:9])


# ETSI TS 102 361-1 B.3.6 parity masks per data type
MASK_VOICE_LC_HEADER = 0x96
MASK_TERMINATOR_WITH_LC = 0x99
