"""Systematic GF(2) linear block codes as batched integer tensor ops.

Port of ``digiham_tpu/fec/linear.py``. Each code is described by its
parity-check rows; the syndrome -> error-pattern table is derived in numpy
by enumerating error patterns in the reference syndrome generators' order
(single bits ascending, then pairs ``(i, k<i)``, then triples), first match
wins. Codewords are packed integers, bit 0 (LSB) = last received bit.

``decode`` works on tensors of any device; ``decode_np`` is its numpy twin
for the host phase machines. Decoding is a bit-count parity per check row plus one gather from the
dense ``2**(n-k)`` table. Torch has no popcount, so the parity is an
explicit SWAR bit count on int64: int64 keeps every codeword (n <= 31)
non-negative, where the JAX package's uint32 rows viewed as int32 would
meet torch's arithmetic ``>>``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BlockCode:
    """A systematic GF(2) block code defined by parity-check rows.

    parity_rows: one int per check row; bit ``l`` of the row is the H-matrix
      coefficient of codeword bit ``l`` (LSB = last received bit). Row 0
      gives the most significant syndrome bit.
    correct_bits: error-pattern enumeration depth (1, 2 or 3).
    """

    name: str
    n: int
    k: int
    parity_rows: tuple[int, ...]
    correct_bits: int

    @property
    def r(self) -> int:
        return self.n - self.k

    @functools.cached_property
    def syndrome_table(self) -> np.ndarray:
        """Dense syndrome -> error-pattern table (int64); -1 marks
        uncorrectable."""
        table = np.full(1 << self.r, -1, dtype=np.int64)
        table[0] = 0

        def syndrome(pattern: int) -> int:
            s = 0
            for row in self.parity_rows:
                s = (s << 1) | ((int(row) & pattern).bit_count() & 1)
            return s

        def add(pattern: int) -> None:
            s = syndrome(pattern)
            if s != 0 and table[s] < 0:
                table[s] = pattern

        for i in range(self.n):
            add(1 << i)
            if self.correct_bits >= 2:
                for kk in range(i):
                    add((1 << i) | (1 << kk))
                    if self.correct_bits >= 3:
                        for ll in range(kk):
                            add((1 << i) | (1 << kk) | (1 << ll))
        return table

    @functools.cached_property
    def generator_rows(self) -> np.ndarray:
        """Systematic generator rows (for encoding): data bit j (j=0 is the
        first transmitted bit, i.e. codeword bit n-1) -> full codeword
        mask."""
        rows = []
        for j in range(self.k):
            data_bit = 1 << (self.n - 1 - j)
            word = data_bit
            for ri, row in enumerate(self.parity_rows):
                if (int(row) & data_bit).bit_count() & 1:
                    word |= 1 << (self.r - 1 - ri)  # identity block position
            rows.append(word)
        return np.asarray(rows, dtype=np.int64)

    def encode(self, data: np.ndarray | int) -> np.ndarray:
        """Encode k-bit data ints (numpy, host side; tests and TX)."""
        data = np.asarray(data, dtype=np.int64)
        out = np.zeros_like(data)
        for j in range(self.k):
            bit = (data >> (self.k - 1 - j)) & 1
            out ^= bit * self.generator_rows[j]
        return out

    def table(self, device) -> torch.Tensor:
        """The syndrome table as an int64 tensor on ``device``."""
        return torch.as_tensor(self.syndrome_table, device=device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values below 2**32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def syndrome(code: BlockCode, words: torch.Tensor) -> torch.Tensor:
    """int64 syndromes of int64 codewords, row 0 most significant."""
    s = torch.zeros_like(words)
    for row in code.parity_rows:
        s = (s << 1) | (popcount(words & int(row)) & 1)
    return s


def decode(code: BlockCode, words: torch.Tensor,
           table: torch.Tensor | None = None):
    """Batched syndrome decode.

    words: integer tensor of packed codewords (any leading shape).
    table: the code's syndrome table on ``words.device`` (built when
    omitted; pipelines pass their registered buffer).
    Returns (corrected int32, ok bool) — ``ok`` is False where the
    syndrome is not in the correction table.
    """
    w = words.to(torch.int64) & 0xFFFFFFFF
    if table is None:
        table = code.table(w.device)
    err = table[syndrome(code, w)]
    ok = err >= 0
    corrected = words.to(torch.int64) ^ torch.where(ok, err, 0)
    return corrected.to(torch.int32), ok


_POP8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int64)


def decode_np(code: BlockCode, words) -> tuple[np.ndarray, np.ndarray]:
    """Host-side numpy twin of :func:`decode` for the control plane.

    Scalar fast path uses python int popcounts (the per-frame hot call in
    the protocol phase machines); arrays use byte-LUT parity."""
    if np.isscalar(words) or getattr(words, "ndim", None) == 0:
        w = int(words)
        s = 0
        for row in code.parity_rows:
            s = (s << 1) | ((w & int(row)).bit_count() & 1)
        err = int(code.syndrome_table[s])
        if err < 0:
            return np.int64(w), np.bool_(False)
        return np.int64(w ^ err), np.bool_(True)

    words = np.asarray(words, dtype=np.int64)
    syndrome = np.zeros_like(words)
    nbytes = (code.n + 7) // 8
    for row in code.parity_rows:
        masked = words & row
        pop = np.zeros_like(words)
        for b in range(nbytes):
            pop += _POP8[(masked >> (8 * b)) & 0xFF]
        syndrome = (syndrome << 1) | (pop & 1)
    err = code.syndrome_table[syndrome]
    ok = err >= 0
    corrected = words ^ np.where(ok, err, 0)
    return corrected, ok
