"""Kernel K4: the many-channel FIR (the standalone RRC filter) for Hopper,
and its plain PyTorch version.

Replaces ``digiham_tpu/ops/fir.py::pallas_fir_cmajor`` and its entry
``rrc_filter_block_pallas``. The CUDA C++ source is
``digiham_tpu_torch/csrc/fir.cu`` (grid over channel and time tile of
1,792 outputs; the tile's inputs staged in shared memory by 16-byte
asynchronous copies at any pointer alignment; 7 consecutive outputs a
thread through the register-window FIR of ``csrc/fir_span.cuh``, which K1
and K2 run too; a warp's outputs stored through shared memory), built and
bound by :mod:`.build`.

Both versions sum in one order: ``taps[0] * x[t]``, then ``+ taps[j] *
x[t + j]`` for ``j = 1 .. ntaps-1``, every product and every sum rounded
to float32 on its own. That is the order of the FIR inside K1/K2
(``csrc/demod_front.cu``), so on the card K4 equals its plain version and
K2's internal filtered row bit for bit. Multiply and add may not fuse, so
half the card's operations bound is the kernel's ceiling. No cuDNN
convolution is involved, so no TF32 setting can round the operands
(reduced-precision RRC flips slicer decisions:
digiham_tpu/dsp/rrc.py:278-280).

:func:`fir_cmajor` and :func:`rrc_filter_block_kernel` take the plain
version for CPU tensors only; for a CUDA tensor they launch the kernel or
raise. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .build import SMEM_LIMIT, library, on_device, stream_pointer

SOURCE = "fir.cu"
# keep in step with csrc/fir.cu
THREADS = 256
FIR_OUTPUTS = 7               # consecutive outputs of one thread
TILE = THREADS * FIR_OUTPUTS  # outputs of one block
MAX_GRID_Y = 65535

LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"digiham_fir": [_P, _L, _P, _L, _P, _P, _I, _I, _I, _P],
               "digiham_fir_occupancy": [_I, _P, _P]}


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(ntaps: int) -> int:
    """Dynamic shared memory of one block: the taps (tap j at word j + 3),
    the tile's inputs with their halo and up to 3 words of alignment shift,
    and the tile's outputs. Keep in step with smem_of in csrc/fir.cu."""
    return 4 * (_round4(ntaps + 3) + _round4(TILE + ntaps - 1 + 3) + TILE)


def occupancy(ntaps: int) -> tuple[int, int]:
    """(blocks of K4 the CUDA runtime keeps resident on one SM at this tap
    count, the card's SM count). Needs the card: builds the source at first
    use."""
    blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = library(SOURCE, _SIGNATURES).digiham_fir_occupancy(
        ntaps, ctypes.byref(blocks), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"K4 occupancy query failed: CUDA error {rc}")
    return blocks.value, sms.value


def fir_cmajor_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The plain version of K4, on any device: x [C, T + ntaps-1], taps
    [ntaps] -> y [C, T], ``y[:, t] = sum_j taps[j] * x[:, t + j]`` summed
    tap by tap in the fixed order."""
    ntaps = taps.shape[0]
    T = x.shape[-1] - (ntaps - 1)
    y = taps[0] * x[:, 0:T]
    for j in range(1, ntaps):
        y = y + taps[j] * x[:, j:j + T]
    return y


def _as_f32(name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A float32 tensor of ``ndim`` dimensions whose rows are contiguous;
    anything else raises (never reinterpreted, never converted)."""
    if t.dtype != torch.float32 or t.dim() != ndim:
        raise ValueError(f"{name}: want float32 with {ndim} dimension(s), "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    return t


def _launch(hist: torch.Tensor, samples: torch.Tensor,
            taps: torch.Tensor) -> torch.Tensor:
    """y [C, T] of the row ``[hist | samples]``: hist [C, ntaps-1] and
    samples [C, T] are float32 CUDA tensors with unit stride along time
    (any row stride), taps [ntaps] float32 contiguous."""
    global LAUNCHES
    C, T = samples.shape
    ntaps = taps.shape[0]
    dev = samples.device
    y = torch.empty((C, T), dtype=torch.float32, device=dev)
    if C == 0 or T == 0:
        return y
    if smem_bytes(ntaps) > SMEM_LIMIT:
        raise ValueError(f"K4 with {ntaps} taps needs {smem_bytes(ntaps)} B "
                         f"of shared memory, over the {SMEM_LIMIT} B a block "
                         "may use")
    if -(-T // TILE) > MAX_GRID_Y:
        raise ValueError(f"K4 takes at most {MAX_GRID_Y * TILE} samples per "
                         f"row, got {T}")
    fn = library(SOURCE, _SIGNATURES).digiham_fir
    with on_device(dev):
        stream = stream_pointer(dev)
        rc = fn(hist.data_ptr(), hist.stride(0), samples.data_ptr(),
                samples.stride(0), taps.data_ptr(), y.data_ptr(), C, T,
                ntaps, stream)
    if rc != 0:
        raise RuntimeError(f"K4 digiham_fir launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y


def _route(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True: the plain version (CPU tensor). False: the kernel."""
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {x.device}")
    return False


def fir_cmajor(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """K4 over a channel-major block: x [C, T + ntaps-1] float32 (the
    leading ntaps-1 columns are the history), taps [ntaps] float32 ->
    y [C, T]. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream."""
    x = _as_f32("x", x, 2)
    taps = _as_f32("taps", taps, 1)
    halo = taps.shape[0] - 1
    if taps.shape[0] < 1 or x.shape[1] < halo:
        raise ValueError(f"x of {x.shape[1]} columns is shorter than the "
                         f"history of {taps.shape[0]} taps")
    if _route(x, taps):
        return fir_cmajor_plain(x, taps)
    return _launch(x[:, :halo], x[:, halo:], taps.contiguous())


def rrc_filter_block_plain(samples: torch.Tensor, history: torch.Tensor,
                           taps: torch.Tensor):
    """The plain version of :func:`rrc_filter_block_kernel`, on any
    device: (y [C, T], new history [C, ntaps-1], a copy)."""
    x = torch.cat([history, samples], dim=-1)
    halo = taps.shape[0] - 1
    return fir_cmajor_plain(x, taps), x[:, x.shape[-1] - halo:].clone()


def rrc_filter_block_kernel(samples: torch.Tensor, history: torch.Tensor,
                            taps: torch.Tensor):
    """K4 behind the streaming interface: samples [C, T], history
    [C, ntaps-1], taps [ntaps], all float32 -> (y [C, T], new history
    [C, ntaps-1]). The new history is the last ntaps-1 columns of
    ``[history | samples]``, always a copy. On the card the two rows go to
    the kernel as they are (no concatenated copy). CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream."""
    samples = _as_f32("samples", samples, 2)
    history = _as_f32("history", history, 2)
    taps = _as_f32("taps", taps, 1)
    C, T = samples.shape
    halo = taps.shape[0] - 1
    if taps.shape[0] < 1 or tuple(history.shape) != (C, halo):
        raise ValueError(f"history: want {(C, halo)} for {taps.shape[0]} "
                         f"taps, got {tuple(history.shape)}")
    if _route(samples, history, taps):
        return rrc_filter_block_plain(samples, history, taps)
    if T >= halo:
        new_history = samples[:, T - halo:].clone()
    else:
        new_history = torch.cat([history[:, T:], samples], dim=-1)
    return _launch(history, samples, taps.contiguous()), new_history
