"""Kernel K5: the Viterbi decoder of the 16- and 4-state codes for Hopper.

Replaces ``digiham_tpu/ops/viterbi_pallas.py::viterbi_decode_pallas`` (16
states) and the JAX package's XLA scan at 4 states. The CUDA C++ source is
``digiham_tpu_torch/csrc/viterbi.cu``, one kernel templated on the number of
states S: a trellis state per lane (a sequence rides S lanes, 32 / S
sequences a warp), predecessors by shuffles of width S, a step's S
decisions as an S-bit field of one ballot word in shared memory, the final
state by a minimum over ``(metric << log2 S) | state``, four steps a turn of
the forward and the traceback loop, inputs and outputs staged through
shared memory so that global memory is read and written coalesced, and up
to ``MAX_SEGMENTS`` batches of sequences in one launch. It is built and
bound by :mod:`.build`. Its plain version is
``fec.viterbi.viterbi_decode_plain``.

:func:`viterbi16` (one batch) and :func:`viterbi16_many` (several batches,
one launch) take either code by ``num_states`` (16 by default, the codes
they were first written for). They take the plain version for CPU tensors
only; for CUDA tensors they launch the kernel or raise. The kernel reads the
dibits as they are: uint8, int32 or int64, unit stride along the steps, any
row stride. ``LAUNCHES`` counts kernel launches of either instance,
``LAUNCHES_BY_STATES`` of each, the runs of a launch captured in a CUDA graph
too (:func:`count_launches`).

Limits: ``1 <= T <= max_steps(S)`` (a block keeps its ballot words and its
sequences' dibits in shared memory; ``MAX_STEPS`` at 16 states), at most
``MAX_SEGMENTS`` batches a launch, one number of states a launch. A path
metric is at most ``2 * T``, so the key ``(metric << 4) | state`` and the
blocked candidate ``1 << 28`` stay far inside int32 at every T the shared
memory allows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..fec.viterbi import (NUM_STATES, _branch_tables, _check_blocked_steps,
                           _transitions, viterbi_decode_plain)
from .build import SMEM_LIMIT, library, on_device, stream_pointer

SOURCE = "viterbi.cu"
# keep in step with csrc/viterbi.cu
WARPS = 2                # warps of one block
MAX_SEGMENTS = 4         # batches one launch covers
STATES = (16, 4)         # the instances of the kernel


def seqs(num_states: int = NUM_STATES) -> int:
    """Sequences of one block: 32 / S a warp (States<S>::SEQS)."""
    return WARPS * 32 // num_states


SEQS = seqs(NUM_STATES)  # 16 states: 16 lanes a sequence, 4 a block


def smem_bytes(steps: int, num_states: int = NUM_STATES) -> int:
    """Dynamic shared memory of a block whose sequences have ``steps``
    steps: a ballot word per warp and step, and a byte per sequence and
    step in rows of whole 32-bit words. Keep in step with smem_of in
    csrc/viterbi.cu."""
    return 4 * WARPS * steps + seqs(num_states) * ((steps + 3) & ~3)


def max_steps(num_states: int = NUM_STATES) -> int:
    """The most steps whose ballot words and dibits fit one block."""
    return (SMEM_LIMIT // (4 * WARPS + seqs(num_states))) & ~3


MAX_STEPS = max_steps(NUM_STATES)

LAUNCHES = 0
LAUNCHES_BY_STATES = dict.fromkeys(STATES, 0)

_ELEMENT_SIZES = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}
_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_longlong)


# per segment the many-batch entry reads SEGMENT_FIELDS 64-bit integers:
# obs, bits, metric (addresses), row stride, element size, batch, T, blocked
SEGMENT_FIELDS = 8
_SIGNATURES = {
    f"digiham_viterbi{S}{suffix}": argtypes
    for S in STATES
    for suffix, argtypes in (
        ("", [_P, _I, _L, _P, _P, _I, _I, _I, _U, _U, _P]),
        ("_many", [_P, _I, _U, _U, _P]))}


def _check_states(num_states: int) -> None:
    if num_states not in STATES:
        raise ValueError(f"K5 decodes {STATES} states, got num_states="
                         f"{num_states}")


@functools.lru_cache(maxsize=None)
def _packed_expected(num_states: int = NUM_STATES) -> tuple[int, int]:
    """The expected dibit of new state i on its k=0 and k=1 branch, packed
    2 bits per state (state i in bits [2i, 2i+2))."""
    _, expected = _branch_tables(num_states, _transitions(num_states))
    return tuple(sum(int(expected[i, k]) << (2 * i)
                     for i in range(num_states)) for k in range(2))


@functools.lru_cache(maxsize=None)
def _entries(num_states: int):
    """(the one-batch entry, the many-batch entry, exp0, exp1) of the
    ``num_states`` instance, resolved once: the first call builds and loads
    the library."""
    lib = library(SOURCE, _SIGNATURES)
    return (getattr(lib, f"digiham_viterbi{num_states}"),
            getattr(lib, f"digiham_viterbi{num_states}_many"),
            *_packed_expected(num_states))


def _count(num_states: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_STATES[num_states] += 1


def count_launches(by_states: dict, times: int = 1) -> None:
    """Add ``times`` x ``by_states`` (number of states -> launches) to the
    launch counters: a captured CUDA graph's launches at each replay, and
    -1 times them after its capture, which launched nothing."""
    global LAUNCHES
    for num_states, n in by_states.items():
        LAUNCHES += times * n
        LAUNCHES_BY_STATES[num_states] += times * n


def _rows(observed: torch.Tensor, blocked_steps: int,
          num_states: int = NUM_STATES):
    """What the kernel reads of one batch: (the tensor whose memory it is,
    element size, row stride, batch, T). No copy, no conversion: what the
    kernel does not take raises."""
    _check_states(num_states)
    _check_blocked_steps(num_states, blocked_steps)
    size = _ELEMENT_SIZES.get(observed.dtype)
    if size is None:
        raise ValueError(f"observed: want uint8, int32 or int64 dibits, got "
                         f"{observed.dtype}")
    if observed.dim() < 1:
        raise ValueError("observed: want [..., T]")
    T = observed.shape[-1]
    limit = max_steps(num_states)
    if not 1 <= T <= limit:
        raise ValueError(f"K5 takes 1..{limit} steps at {num_states} states "
                         f"(ballot words and dibits in shared memory), got "
                         f"T={T}")
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


def viterbi16(observed: torch.Tensor, blocked_steps: int = 0,
              num_states: int = NUM_STATES):
    """K5: observed [..., T] integer dibits (0-3; uint8, int32 or int64) ->
    (bits [..., T] int32, metric [...] int32). ``num_states``: 16 or 4;
    ``blocked_steps``: 0, or log2 of it (4: the NXDN blocked start). CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream."""
    if observed.device.type == "cpu":
        return viterbi_decode_plain(observed, num_states, blocked_steps)
    if observed.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {observed.device}")
    flat, size, stride, B, T = _rows(observed, blocked_steps, num_states)
    dev = observed.device
    bits = torch.empty(observed.shape, dtype=torch.int32, device=dev)
    metric = torch.empty(observed.shape[:-1], dtype=torch.int32, device=dev)
    if B:
        fn, _, exp0, exp1 = _entries(num_states)
        with on_device(dev):
            rc = fn(flat.data_ptr(), size, stride, bits.data_ptr(),
                    metric.data_ptr(), B, T, blocked_steps, exp0, exp1,
                    stream_pointer(dev))
        if rc != 0:
            raise RuntimeError(f"K5 viterbi{num_states} launch failed: CUDA "
                               f"error {rc}")
        _count(num_states)
    return bits, metric


def viterbi16_many(segments, num_states: int = NUM_STATES):
    """K5 over several batches in one launch. ``segments``: a sequence of
    ``(observed [..., T], blocked_steps)``, each as :func:`viterbi16` takes
    it, at most ``MAX_SEGMENTS``, all on one device and of the one code of
    ``num_states``. Returns a list of ``(bits, metric)``. CPU tensors take
    the plain version segment by segment; CUDA tensors launch the kernel
    once on the current stream."""
    segments = list(segments)
    if not segments:
        return []
    dev = segments[0][0].device
    for observed, _ in segments:
        if observed.device != dev:
            raise ValueError(f"segments on {observed.device} and {dev}")
    if dev.type == "cpu":
        return [viterbi_decode_plain(observed, num_states, blocked)
                for observed, blocked in segments]
    if dev.type != "cuda":
        raise ValueError(f"no K5 kernel for device {dev}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"K5 takes at most {MAX_SEGMENTS} segments a "
                         f"launch, got {len(segments)}")
    fields, out = [], []
    for observed, blocked in segments:
        flat, size, stride, B, T = _rows(observed, blocked, num_states)
        bits = torch.empty(observed.shape, dtype=torch.int32, device=dev)
        metric = torch.empty(observed.shape[:-1], dtype=torch.int32,
                             device=dev)
        out.append((bits, metric))
        if B:
            fields += (flat.data_ptr(), bits.data_ptr(), metric.data_ptr(),
                       stride, size, B, T, blocked)
    if fields:
        _, fn, exp0, exp1 = _entries(num_states)
        packed = (_L * len(fields))(*fields)
        with on_device(dev):
            rc = fn(packed, len(fields) // SEGMENT_FIELDS, exp0, exp1,
                    stream_pointer(dev))
        if rc != 0:
            raise RuntimeError(f"K5 viterbi{num_states}_many launch failed: "
                               f"CUDA error {rc}")
        _count(num_states)
    return out
