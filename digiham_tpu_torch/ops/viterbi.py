"""Kernel K5: the 16-state Viterbi decoder for Hopper.

Replaces ``digiham_tpu/ops/viterbi_pallas.py::viterbi_decode_pallas``. The
CUDA C++ source is ``digiham_tpu_torch/csrc/viterbi.cu``: a trellis state
per lane (a sequence rides 16 lanes, two sequences a warp), predecessors by
shuffles, a step's 16 decisions as one ballot word in shared memory, the
final state by a minimum over ``(metric << 4) | state``, four steps a turn
of the forward and the traceback loop, inputs and outputs
staged through shared memory so that global memory is read and written
coalesced, and up to ``MAX_SEGMENTS`` batches of sequences in one launch.
It is built and bound by :mod:`.build`. Its plain version is
``fec.viterbi.viterbi_decode_plain``.

:func:`viterbi16` (one batch) and :func:`viterbi16_many` (several batches,
one launch) take the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise. The kernel reads the dibits as they are:
uint8, int32 or int64, unit stride along the steps, any row stride.
``LAUNCHES`` counts kernel launches.

Limits: ``1 <= T <= MAX_STEPS`` (a block keeps its ballot words and its
sequences' dibits in shared memory), at most ``MAX_SEGMENTS`` batches a
launch. A path metric is at most ``2 * T``, so the key ``(metric << 4) |
state`` and the blocked candidate ``1 << 28`` stay far inside int32 at
every T the shared memory allows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..fec.viterbi import (NUM_STATES, TRANSITIONS_16, _branch_tables,
                           _check_blocked_steps, viterbi_decode_plain)
from .build import SMEM_LIMIT, library, on_device, stream_pointer

SOURCE = "viterbi.cu"
# keep in step with csrc/viterbi.cu
WARPS = 2                # warps of one block
SEQS = 2 * WARPS         # sequences of one block, 16 lanes each
MAX_SEGMENTS = 4         # batches one launch covers


def smem_bytes(steps: int) -> int:
    """Dynamic shared memory of a block whose sequences have ``steps``
    steps: a ballot word per warp and step, and a byte per sequence and
    step in rows of whole 32-bit words. Keep in step with smem_of in
    csrc/viterbi.cu."""
    return 4 * WARPS * steps + SEQS * ((steps + 3) & ~3)


# the most steps whose ballot words and dibits fit one block
MAX_STEPS = (SMEM_LIMIT // (4 * WARPS + SEQS)) & ~3

LAUNCHES = 0

_ELEMENT_SIZES = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}
_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_longlong)


# per segment the many-batch entry reads SEGMENT_FIELDS 64-bit integers:
# obs, bits, metric (addresses), row stride, element size, batch, T, blocked
SEGMENT_FIELDS = 8
_SIGNATURES = {
    "digiham_viterbi16": [_P, _I, _L, _P, _P, _I, _I, _I, _U, _U, _P],
    "digiham_viterbi16_many": [_P, _I, _U, _U, _P],
}


@functools.lru_cache(maxsize=None)
def _packed_expected() -> tuple[int, int]:
    """The expected dibit of new state i on its k=0 and k=1 branch, packed
    2 bits per state (state i in bits [2i, 2i+2))."""
    _, expected = _branch_tables(NUM_STATES, TRANSITIONS_16)
    return tuple(sum(int(expected[i, k]) << (2 * i)
                     for i in range(NUM_STATES)) for k in range(2))


@functools.lru_cache(maxsize=None)
def _entries():
    """(the one-batch entry, the many-batch entry, exp0, exp1), resolved
    once: the first call builds and loads the library."""
    lib = library(SOURCE, _SIGNATURES)
    return (lib.digiham_viterbi16, lib.digiham_viterbi16_many,
            *_packed_expected())


def _rows(observed: torch.Tensor, blocked_steps: int):
    """What the kernel reads of one batch: (the tensor whose memory it is,
    element size, row stride, batch, T). No copy, no conversion: what the
    kernel does not take raises."""
    _check_blocked_steps(NUM_STATES, blocked_steps)
    size = _ELEMENT_SIZES.get(observed.dtype)
    if size is None:
        raise ValueError(f"observed: want uint8, int32 or int64 dibits, got "
                         f"{observed.dtype}")
    if observed.dim() < 1:
        raise ValueError("observed: want [..., T]")
    T = observed.shape[-1]
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"K5 takes 1..{MAX_STEPS} steps (ballot words and "
                         f"dibits in shared memory), got T={T}")
    if T > 1 and observed.stride(-1) != 1:
        raise ValueError(f"observed: K5 reads unit stride along the steps, "
                         f"got stride {observed.stride(-1)}")
    if observed.dim() <= 2:
        flat = observed.reshape(-1, T) if observed.dim() == 1 else observed
    else:
        try:
            flat = observed.view(-1, T)
        except RuntimeError:
            raise ValueError(
                f"observed: the leading dimensions of shape "
                f"{tuple(observed.shape)}, strides {observed.stride()} do "
                f"not fold into one row stride") from None
    return flat, size, (flat.stride(0) if flat.shape[0] > 1 else T), \
        flat.shape[0], T


def viterbi16(observed: torch.Tensor, blocked_steps: int = 0):
    """K5: observed [..., T] integer dibits (0-3; uint8, int32 or int64) ->
    (bits [..., T] int32, metric [...] int32). ``blocked_steps``: 0, or 4
    for the NXDN blocked start. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    global LAUNCHES
    if observed.device.type == "cpu":
        return viterbi_decode_plain(observed, NUM_STATES, blocked_steps)
    if observed.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {observed.device}")
    flat, size, stride, B, T = _rows(observed, blocked_steps)
    dev = observed.device
    bits = torch.empty(observed.shape, dtype=torch.int32, device=dev)
    metric = torch.empty(observed.shape[:-1], dtype=torch.int32, device=dev)
    if B:
        fn, _, exp0, exp1 = _entries()
        with on_device(dev):
            rc = fn(flat.data_ptr(), size, stride, bits.data_ptr(),
                    metric.data_ptr(), B, T, blocked_steps, exp0, exp1,
                    stream_pointer(dev))
        if rc != 0:
            raise RuntimeError(f"K5 viterbi16 launch failed: CUDA error {rc}")
        LAUNCHES += 1
    return bits, metric


def viterbi16_many(segments):
    """K5 over several batches in one launch. ``segments``: a sequence of
    ``(observed [..., T], blocked_steps)``, each as :func:`viterbi16` takes
    it, at most ``MAX_SEGMENTS``, all on one device. Returns a list of
    ``(bits, metric)``. CPU tensors take the plain version segment by
    segment; CUDA tensors launch the kernel once on the current stream."""
    global LAUNCHES
    segments = list(segments)
    if not segments:
        return []
    dev = segments[0][0].device
    for observed, _ in segments:
        if observed.device != dev:
            raise ValueError(f"segments on {observed.device} and {dev}")
    if dev.type == "cpu":
        return [viterbi_decode_plain(observed, NUM_STATES, blocked)
                for observed, blocked in segments]
    if dev.type != "cuda":
        raise ValueError(f"no K5 kernel for device {dev}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"K5 takes at most {MAX_SEGMENTS} segments a "
                         f"launch, got {len(segments)}")
    fields, out = [], []
    for observed, blocked in segments:
        flat, size, stride, B, T = _rows(observed, blocked)
        bits = torch.empty(observed.shape, dtype=torch.int32, device=dev)
        metric = torch.empty(observed.shape[:-1], dtype=torch.int32,
                             device=dev)
        out.append((bits, metric))
        if B:
            fields += (flat.data_ptr(), bits.data_ptr(), metric.data_ptr(),
                       stride, size, B, T, blocked)
    if fields:
        _, fn, exp0, exp1 = _entries()
        packed = (_L * len(fields))(*fields)
        with on_device(dev):
            rc = fn(packed, len(fields) // SEGMENT_FIELDS, exp0, exp1,
                    stream_pointer(dev))
        if rc != 0:
            raise RuntimeError(f"K5 viterbi16_many launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES += 1
    return out
