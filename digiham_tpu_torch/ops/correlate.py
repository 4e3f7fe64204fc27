"""Sync-pattern correlation as an exact integer XOR-popcount (port of
``digiham_tpu/ops/correlate.py::sync_correlate_conv``).

``dist[..., t, p] = sum_k popcount(sym[..., t+k] ^ pat[p, k])`` for every
window offset and pattern at once. The JAX package lowers this to a
one-hot convolution for the TPU's matrix unit; here it is plain integer
work on a window view, exact by construction.
"""
from __future__ import annotations

import torch


def sync_correlate(symbols: torch.Tensor, patterns: torch.Tensor,
                   n_values: int) -> torch.Tensor:
    """symbols [..., T] integers in [0, n_values); patterns [P, K] on the
    same device. Returns [..., T-K+1, P] int32 XOR-popcount distances."""
    K = patterns.shape[-1]
    windows = symbols.to(torch.uint8).unfold(-1, K, 1)   # [..., T', K]
    x = windows[..., None, :] ^ patterns.to(torch.uint8)  # [..., T', P, K]
    bits = (x & 1)
    for b in range(1, max(1, (n_values - 1).bit_length())):
        bits = bits + ((x >> b) & 1)
    return bits.sum(-1, dtype=torch.int32)
