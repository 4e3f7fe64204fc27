"""Kernel K5: the 16-state Viterbi decoder for Hopper.

Replaces ``digiham_tpu/ops/viterbi_pallas.py::viterbi_decode_pallas``. The
CUDA C++ source is ``digiham_tpu_torch/csrc/viterbi.cu`` (one thread per
sequence, metrics in registers, decision masks in shared memory), built
and bound by :mod:`.build`. Its plain version is
``fec.viterbi.viterbi_decode_plain``.

:func:`viterbi16` takes the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..fec.viterbi import (NUM_STATES, TRANSITIONS_16, _branch_tables,
                           _check_blocked_steps, viterbi_decode_plain)
from .build import SMEM_LIMIT, library

SOURCE = "viterbi.cu"
THREADS = 128  # threads of one block; keep in step with csrc/viterbi.cu
# steps whose decision masks ([T][THREADS] uint16) fit one block
MAX_STEPS = SMEM_LIMIT // (2 * THREADS)

LAUNCHES = 0

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {"digiham_viterbi16": [_P, _P, _P, _I, _I, _I, _U, _U, _P]}


@functools.lru_cache(maxsize=None)
def _packed_expected() -> tuple[int, int]:
    """The expected dibit of new state i on its k=0 and k=1 branch, packed
    2 bits per state (state i in bits [2i, 2i+2))."""
    _, expected = _branch_tables(NUM_STATES, TRANSITIONS_16)
    return tuple(sum(int(expected[i, k]) << (2 * i)
                     for i in range(NUM_STATES)) for k in range(2))


def viterbi16(observed: torch.Tensor, blocked_steps: int = 0):
    """K5: observed [..., T] integer dibits (0-3) -> (bits [..., T] int32,
    metric [...] int32). ``blocked_steps``: 0, or 4 for the NXDN blocked
    start. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream."""
    global LAUNCHES
    if observed.device.type == "cpu":
        return viterbi_decode_plain(observed, NUM_STATES, blocked_steps)
    if observed.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {observed.device}")
    _check_blocked_steps(NUM_STATES, blocked_steps)
    if observed.dtype.is_floating_point or observed.dtype == torch.bool:
        raise ValueError(f"observed: want integer dibits, got "
                         f"{observed.dtype}")
    T = observed.shape[-1]
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"K5 takes 1..{MAX_STEPS} steps (decision masks "
                         f"in shared memory), got T={T}")
    dev = observed.device
    obs = observed.to(torch.int32).reshape(-1, T).contiguous()
    B = obs.shape[0]
    bits = torch.empty((B, T), dtype=torch.int32, device=dev)
    metric = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        fn = library(SOURCE, _SIGNATURES).digiham_viterbi16
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(obs.data_ptr(), bits.data_ptr(), metric.data_ptr(), B, T,
                    blocked_steps, *_packed_expected(), stream)
        if rc != 0:
            raise RuntimeError(f"K5 viterbi16 launch failed: CUDA error {rc}")
        LAUNCHES += 1
    return (bits.reshape(observed.shape),
            metric.reshape(observed.shape[:-1]))
