"""The least time the card could take for a kernel's work, computed from
the shapes (the copy of ``digiham_tpu_torch/bench/kernels.py``'s bound
arithmetic): the larger of the bytes over the memory rate and the
operations over the float32 rate, at the published peaks of one NVIDIA
H100 SXM (data sheet, dense, at its 700 W limit). Bytes count each input
read once and each output written once; operations count what the inputs
need, whatever the kernel does besides."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(bytes_moved: float, operations: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, operations / FP32_OPS_PER_S)


def demod_operations(channels, length, ntaps, n_centuries, sps):
    """Float operations of the RRC + 4FSK century demod on these shapes:
    per input sample the FIR's ntaps multiply-adds; per consumed sample
    the century sums (volume, mid third, column mean, variance: about 6);
    per symbol the AGC window and slicer (about 10)."""
    symbols = channels * n_centuries * 100
    return channels * length * 2 * ntaps + symbols * sps * 6 + symbols * 10


def demod_bytes(channels, length, ntaps, n_centuries):
    """K2's function: float32 samples and RRC history in, the taps, the
    carry (pos, offset, 100-volume ring) in and out, the dibits and the
    new history out."""
    carry = 4 + 4 + 4 * 100
    return (channels * (4 * length + 4 * (ntaps - 1) + 2 * carry
                        + n_centuries * 100 + 4 * (ntaps - 1))
            + 4 * ntaps)


def viterbi_operations(rows, steps, num_states=16):
    """Integer operations of a decode: per step and state two 2-bit
    distances, two adds, a compare, a select and a mask update (about 14),
    and about 5 per traceback step."""
    return rows * steps * (num_states * 14 + 5)


def viterbi_bytes(rows, steps):
    """A dibit in and a decoded bit out a step, a byte each, and a
    metric out a row."""
    return rows * (2 * steps + 4)
