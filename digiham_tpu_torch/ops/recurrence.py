"""Kernel K6: the serial recurrences of the audio path for Hopper, and
their plain PyTorch versions.

| entry              | replaces                                          |
|--------------------|---------------------------------------------------|
| ``digitalvoice_iir`` | ``digiham_tpu/dsp/audio.py::digitalvoice_filter`` |
| ``dc_block``       | ``digiham_tpu/dsp/fm.py::dc_block``               |

The JAX package runs both as XLA scans; neither has a Pallas counterpart.
Both are one CUDA C++ source, ``digiham_tpu_torch/csrc/recurrence.cu``
(one thread per channel, the delay lines in registers, input and output
staged through shared memory), built and bound by :mod:`.build`. As plain
tensor code on the card each sample would cost about ten launches.

Kernel and plain version share one rounding order, every product,
quotient and sum rounded to float32 on its own, so on the card they agree
bit for bit:

- IIR: ``xin = (x / scale) / gain``; the forward sum ``fw[0]*x[0] + ... +
  fw[10]*xin`` left to right over the inputs, oldest first; the feedback
  sum ``fb[0]*y[0] + ... + fb[9]*y[9]`` left to right over the outputs,
  oldest first; ``y = forward + feedback``; the output ``y * scale``
  clamped to [-32768, 32767] and truncated toward zero (XLA's float to
  int16 conversion saturates; a plain cast would wrap).
- DC blocker: ``y = (x - x1) + alpha * y1`` in sequence.

:func:`digitalvoice_iir` and :func:`dc_block` take the plain version for
CPU tensors only; for a CUDA tensor they launch the kernel or raise.
``LAUNCHES[entry]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import library, on_device, stream_pointer

SOURCE = "recurrence.cu"
# keep in step with csrc/recurrence.cu
ORDER = 10  # the IIR's delay line
TILE = 160  # samples a block stages per turn

LAUNCHES = {"digitalvoice_iir": 0, "dc_block": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "digiham_digitalvoice_iir": [_P, _L, _P, _P, _P, _P, _P, _P, _I, _L, _P],
    "digiham_dc_block": [_P, _L, _P, _P, _P, _P, _P, _I, _L, ctypes.c_float,
                         _P],
}


def _f32(values) -> list[float]:
    return [float(v) for v in np.asarray(values, dtype=np.float32)]


def digitalvoice_iir_plain(pcm: torch.Tensor, xv: torch.Tensor,
                           yv: torch.Tensor, forward, feedback, scale: float,
                           gain: float):
    """The plain version of the IIR, on any device: pcm [C, T] int16, xv and
    yv [C, 10] float32 (last inputs and outputs, oldest first), forward
    [11] and feedback [10] taps -> (out [C, T] int16, new xv, new yv).

    The forward sums depend on inputs only, so they are taken for the whole
    block at once, term by term in the fixed order. The feedback sum of
    output ``t`` needs ``y[t-10] .. y[t-1]``, which arrive one a sample and
    in the order of its terms: each output's sum is built in ten slots of
    a [C, 10] accumulator as its terms arrive, ``A[:, t % 10]`` completes at
    sample ``t``, and the slot then starts the sum of output ``t + 10``."""
    from ..dsp.demod import _div  # dsp imports this module

    C, T = pcm.shape
    dev = pcm.device
    if T == 0:
        return (torch.empty((C, 0), dtype=torch.int16, device=dev),
                xv.clone(), yv.clone())
    fw = torch.tensor(_f32(forward), device=dev)
    fb = _f32(feedback)
    x = _div(_div(pcm.to(torch.float32), float(np.float32(scale))),
             float(np.float32(gain)))
    xs = torch.cat([xv, x], dim=1)  # [C, 10 + T]
    f = fw[0] * xs[:, 0:T]
    for j in range(1, ORDER + 1):
        f = f + fw[j] * xs[:, j:j + T]
    # slot coefficients: at sample t (h = t % 10) output t + d, d = 1..10,
    # sits in slot (h + d) % 10 and takes y[t] as its term 10 - d
    coef = torch.zeros((ORDER, ORDER), dtype=torch.float32)
    for h in range(ORDER):
        for d in range(1, ORDER + 1):
            coef[h, (h + d) % ORDER] = fb[ORDER - d]
    coef = coef.to(dev)
    acc = torch.zeros((C, ORDER), dtype=torch.float32, device=dev)
    for s in range(-ORDER, 0):  # the carried outputs start slots 0..9
        h = s % ORDER
        acc[:, h] = 0.0
        acc += coef[h] * yv[:, s + ORDER, None]
    y = torch.empty((C, T), dtype=torch.float32, device=dev)
    for t in range(T):
        h = t % ORDER
        y_t = f[:, t] + acc[:, h]
        y[:, t] = y_t
        acc[:, h] = 0.0
        acc += coef[h] * y_t[:, None]
    out = (y * float(np.float32(scale))).clamp(-32768.0, 32767.0).to(
        torch.int16)
    ys = torch.cat([yv, y], dim=1)
    return out, xs[:, -ORDER:].clone(), ys[:, -ORDER:].clone()


def dc_block_plain(x: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
                   alpha: float):
    """The plain version of the DC blocker, on any device: x [C, T], x1 and
    y1 [C] float32 -> (y [C, T], new x1, new y1)."""
    C, T = x.shape
    if T == 0:
        return torch.empty_like(x), x1.clone(), y1.clone()
    d = x - torch.cat([x1[:, None], x[:, :-1]], dim=1)
    a = torch.full((), float(np.float32(alpha)), dtype=torch.float32,
                   device=x.device)
    y = torch.empty_like(x)
    y_t = y1
    for t in range(T):
        y_t = d[:, t] + a * y_t
        y[:, t] = y_t
    return y, x[:, -1].clone(), y[:, -1].clone()


def _rows(name: str, t: torch.Tensor, dtype) -> torch.Tensor:
    """A 2-D tensor of ``dtype`` with unit stride along time; anything else
    raises (never converted)."""
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{name}: want {dtype} [C, T], got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t


def _carry(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _route(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True: the plain version (CPU tensor). False: the kernel."""
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {x.device}")
    return False


def _check(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"K6 {entry} launch failed: CUDA error {rc}")


def digitalvoice_iir(pcm: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                     forward, feedback, scale: float, gain: float):
    """K6's IIR: pcm [C, T] int16, xv and yv [C, 10] float32 ->
    (out [C, T] int16, new xv, new yv). CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    pcm = _rows("pcm", pcm, torch.int16)
    C, T = pcm.shape
    xv = _carry("xv", xv, (C, ORDER))
    yv = _carry("yv", yv, (C, ORDER))
    if _route(pcm, xv, yv):
        return digitalvoice_iir_plain(pcm, xv, yv, forward, feedback, scale,
                                      gain)
    if C == 0 or T == 0:
        return (torch.empty((C, T), dtype=torch.int16, device=pcm.device),
                xv.clone(), yv.clone())
    coeffs = _f32(forward) + _f32(feedback) + _f32([scale, gain])
    if len(coeffs) != 2 * ORDER + 3:
        raise ValueError(f"want {ORDER + 1} forward and {ORDER} feedback "
                         "taps")
    host = (ctypes.c_float * len(coeffs))(*coeffs)
    dev = pcm.device
    out = torch.empty((C, T), dtype=torch.int16, device=dev)
    xv_out = torch.empty_like(xv)
    yv_out = torch.empty_like(yv)
    fn = library(SOURCE, _SIGNATURES).digiham_digitalvoice_iir
    with on_device(dev):
        rc = fn(pcm.data_ptr(), pcm.stride(0), xv.data_ptr(), yv.data_ptr(),
                ctypes.addressof(host), out.data_ptr(), xv_out.data_ptr(),
                yv_out.data_ptr(), C, T, stream_pointer(dev))
    _check(rc, "digitalvoice_iir")
    LAUNCHES["digitalvoice_iir"] += 1
    return out, xv_out, yv_out


def dc_block(x: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
             alpha: float):
    """K6's DC blocker: x [C, T], x1 and y1 [C] float32 -> (y [C, T], new
    x1, new y1). CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream."""
    x = _rows("x", x, torch.float32)
    C, T = x.shape
    x1 = _carry("x1", x1, (C,))
    y1 = _carry("y1", y1, (C,))
    if _route(x, x1, y1):
        return dc_block_plain(x, x1, y1, alpha)
    if C == 0 or T == 0:
        return torch.empty((C, T), dtype=torch.float32, device=x.device), \
            x1.clone(), y1.clone()
    dev = x.device
    y = torch.empty((C, T), dtype=torch.float32, device=dev)
    x1_out = torch.empty_like(x1)
    y1_out = torch.empty_like(y1)
    fn = library(SOURCE, _SIGNATURES).digiham_dc_block
    with on_device(dev):
        rc = fn(x.data_ptr(), x.stride(0), x1.data_ptr(), y1.data_ptr(),
                y.data_ptr(), x1_out.data_ptr(), y1_out.data_ptr(), C, T,
                float(np.float32(alpha)), stream_pointer(dev))
    _check(rc, "dc_block")
    LAUNCHES["dc_block"] += 1
    return y, x1_out, y1_out
