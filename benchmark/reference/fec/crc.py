"""The YSF, NXDN and D-Star checksums as GF(2) affine maps (port of
``digiham_tpu/fec/crc.py``).

Every CRC of the reference is a bit-serial shift register, an affine map
GF(2)^N -> GF(2)^w. Per variant and message length the impulse-response
table is precomputed: ``crc(bits) = const ^ XOR(table[i] for set bits i)``.

:meth:`BitCrc.compute_np` is the host path the phase machines take, with
the bit packers at the end. Torch has no XOR reduction, so
:meth:`BitCrc.compute` takes each checksum bit as the parity of an integer
masked sum over the table's bit planes.
(Integer ``matmul`` is not implemented on CUDA, and a float matmul would
bring TF32 into a decision.)

Variants (step functions as in the reference):
- crc16_ysf  — src/ysf_decoder/crc16.c:3-21
- crc16_dstar — src/dstar_decoder/crc.cpp:9-16
- crc6_nxdn  — src/nxdn_decoder/sacch.cpp:70-84
- crc12_nxdn — src/nxdn_decoder/facch1.cpp:61-74
"""
from __future__ import annotations

import functools

import numpy as np


class BitCrc:
    """An affine CRC over a fixed-length bit vector."""

    def __init__(self, width: int, table: np.ndarray, const: int):
        self.width = width
        self.table = table.astype(np.int64)
        self.const = const

    def compute_np(self, bits: np.ndarray) -> np.ndarray:
        """bits: [..., N] 0/1 -> [...] checksum ints (numpy)."""
        bits = np.asarray(bits, dtype=np.int64)
        contrib = np.where(bits != 0, self.table, 0)
        return np.bitwise_xor.reduce(contrib, axis=-1) ^ self.const

    @functools.cached_property
    def bit_planes(self) -> np.ndarray:
        """[N, width] int32: bit ``width-1-b`` of ``table[i]`` at [i, b]
        (most significant checksum bit first)."""
        shifts = np.arange(self.width - 1, -1, -1)
        return ((self.table[:, None] >> shifts) & 1).astype(np.int32)

def _affine_crc(width: int, nbits: int, init: int, step,
                xor_out: int = 0) -> BitCrc:
    """Build the impulse-response table for an affine bit-serial CRC.
    ``step(reg, bit) -> reg`` must be GF(2)-affine (all of the
    reference's are)."""
    def run(init_reg: int, impulse: int | None) -> int:
        reg = init_reg
        for j in range(nbits):
            reg = step(reg, 1 if j == impulse else 0)
        return reg

    const = run(init, None) ^ xor_out
    table = np.array([run(0, i) for i in range(nbits)], dtype=np.int64)
    return BitCrc(width, table, const)


@functools.lru_cache(maxsize=None)
def crc16_ysf(nbits: int) -> BitCrc:
    """YSF CRC-16: MSB-first, poly x^16+x^12+x^5+1, init 0, final xor
    0xFFFF."""
    def step(reg: int, bit: int) -> int:
        fb = bit ^ ((reg >> 15) & 1)
        reg = (reg << 1) & 0xFFFF
        if fb:
            reg ^= (1 << 12) | (1 << 5) | 1
        return reg

    return _affine_crc(16, nbits, 0, step, xor_out=0xFFFF)


@functools.lru_cache(maxsize=None)
def crc16_dstar(nbits: int) -> BitCrc:
    """D-Star CRC: reflected poly 0x8408, init 0xFFFF, final xor 0xFFFF.
    Input bit order is the reference's processing order: for each byte,
    bit 0 (LSB) first (src/dstar_decoder/crc.cpp:9-16)."""
    def step(reg: int, bit: int) -> int:
        fb = (reg ^ bit) & 1
        reg >>= 1
        if fb:
            reg ^= 0x8408
        return reg

    return _affine_crc(16, nbits, 0xFFFF, step, xor_out=0xFFFF)


@functools.lru_cache(maxsize=None)
def crc6_nxdn(nbits: int = 26) -> BitCrc:
    """NXDN SACCH CRC-6 shift register (sacch.cpp:70-84)."""
    def step(reg: int, bit: int) -> int:
        cb = ((reg >> 5) & 1) ^ bit
        if cb:
            reg ^= 0b00010011
        return ((reg << 1) & 0b00111110) | cb

    return _affine_crc(6, nbits, 0b00111111, step)


@functools.lru_cache(maxsize=None)
def crc12_nxdn(nbits: int = 80) -> BitCrc:
    """NXDN FACCH1 CRC-12 shift register (facch1.cpp:61-74)."""
    def step(reg: int, bit: int) -> int:
        cb = ((reg >> 11) & 1) ^ bit
        if cb:
            reg ^= 0b10000000111
        return ((reg << 1) & 0b111111111110) | cb

    return _affine_crc(12, nbits, 0b111111111111, step)


def bytes_to_bits_msb(data) -> np.ndarray:
    """[..., B] uint8 -> [..., 8B] bits, MSB of each byte first."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)


def bytes_to_bits_lsb(data) -> np.ndarray:
    """[..., B] uint8 -> [..., 8B] bits, LSB of each byte first."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1,
                         bitorder="little")


def bits_to_bytes_msb(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)


def bits_to_bytes_lsb(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1,
                       bitorder="little")
