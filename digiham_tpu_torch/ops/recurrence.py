"""Kernel K6: the serial recurrences of the audio path for Hopper, and
their plain PyTorch versions.

| entry              | replaces                                          |
|--------------------|---------------------------------------------------|
| ``digitalvoice_iir`` | ``digiham_tpu/dsp/audio.py::digitalvoice_filter`` |
| ``dc_block``       | ``digiham_tpu/dsp/fm.py::dc_block``               |

The JAX package runs both as XLA scans; neither has a Pallas counterpart.
Both are one CUDA C++ source, ``digiham_tpu_torch/csrc/recurrence.cu``,
built and bound by :mod:`.build`: a block of ``ROWS`` channels, whose
chain warp (one lane a channel, the feedback window in registers) does only
the recurrence while helper warps stage each tile of ``TILE`` samples,
compute what depends on the inputs alone (the IIR's scaled inputs and
forward sums, the DC blocker's differences) and convert and write out the
tile before. As plain tensor code on the card each sample would cost about
ten launches. ``csrc/recurrence_serial.cu`` keeps the earlier one-warp
design for timing beside it (:mod:`.variants`); nothing here launches it.

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
import functools

import numpy as np
import torch

from .build import library, on_device, stream_pointer

SOURCE = "recurrence.cu"
SERIAL_SOURCE = "recurrence_serial.cu"  # the earlier design, timed only
# keep in step with csrc/recurrence.cu
ORDER = 10  # the IIR's delay line
ROWS = 16  # most channels a block
TILE = 320  # samples a tile
PCM_TYPES = (torch.int16, torch.int32)  # what the IIR takes

LAUNCHES = {"digitalvoice_iir": 0, "dc_block": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IIR = [_P, _L, _P, _P, _P, _P, _P, _P, _I, _L]
_DC = [_P, _L, _P, _P, _P, _P, _P, _I, _L, ctypes.c_float]
_SIGNATURES = {  # then the channels a block takes, and the stream
    "digiham_digitalvoice_iir": _IIR + [_I, _P],
    "digiham_digitalvoice_iir32": _IIR + [_I, _P],
    "digiham_dc_block": _DC + [_I, _P],
}
# the serial design: 32 channels a block, always; no int32 entry
SERIAL_SIGNATURES = {"digiham_digitalvoice_iir": _IIR + [_P],
                     "digiham_dc_block": _DC + [_P]}


def block_rows(channels: int, sms: int) -> int:
    """Channels a block of the kernel takes: the channels spread over the
    card's ``sms`` multiprocessors, one block (one chain warp) an SM while
    they last, at most ``ROWS``. A chain warp takes as long for one channel
    as for many; its helper warps' work grows with the channels."""
    return min(ROWS, max(1, -(-channels // sms)))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _block_rows_on(dev, channels: int) -> int:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return block_rows(channels, sm_count(index))


def _f32(values) -> list[float]:
    return [float(v) for v in np.asarray(values, dtype=np.float32)]


def digitalvoice_iir_plain(pcm: torch.Tensor, xv: torch.Tensor,
                           yv: torch.Tensor, forward, feedback, scale: float,
                           gain: float):
    """The plain version of the IIR, on any device: pcm [C, T] int16 or
    int32 (converted to float32 as it is), xv and
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


def _rows(name: str, t: torch.Tensor, dtypes) -> torch.Tensor:
    """A 2-D tensor of one of ``dtypes`` with unit stride along time;
    anything else raises (never converted)."""
    if t.dtype not in dtypes or t.dim() != 2:
        raise ValueError(f"{name}: want {' or '.join(map(str, dtypes))} "
                         f"[C, T], got {t.dtype} {tuple(t.shape)}")
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


def iir_launch(lib: ctypes.CDLL, pcm: torch.Tensor, xv: torch.Tensor,
               yv: torch.Tensor, forward, feedback, scale: float,
               gain: float, rows: int | None):
    """Launch the IIR entry of ``lib`` on checked, non-empty CUDA inputs,
    without counting: the launch the wrapper makes, shared with
    :mod:`.variants`. ``rows``: the channels a block takes (a build of
    ``SOURCE``), or None for a build of ``SERIAL_SOURCE`` (int16 only)."""
    coeffs = _f32(forward) + _f32(feedback) + _f32([scale, gain])
    if len(coeffs) != 2 * ORDER + 3:
        raise ValueError(f"want {ORDER + 1} forward and {ORDER} feedback "
                         "taps")
    host = (ctypes.c_float * len(coeffs))(*coeffs)
    C, T = pcm.shape
    dev = pcm.device
    out = torch.empty((C, T), dtype=torch.int16, device=dev)
    xv_out = torch.empty_like(xv)
    yv_out = torch.empty_like(yv)
    fn = (lib.digiham_digitalvoice_iir if pcm.dtype == torch.int16
          else lib.digiham_digitalvoice_iir32)
    layout = () if rows is None else (rows,)
    with on_device(dev):
        rc = fn(pcm.data_ptr(), pcm.stride(0), xv.data_ptr(), yv.data_ptr(),
                ctypes.addressof(host), out.data_ptr(), xv_out.data_ptr(),
                yv_out.data_ptr(), C, T, *layout, stream_pointer(dev))
    _check(rc, "digitalvoice_iir")
    return out, xv_out, yv_out


def dc_launch(lib: ctypes.CDLL, x: torch.Tensor, x1: torch.Tensor,
              y1: torch.Tensor, alpha: float, rows: int | None):
    """Launch the DC blocker entry of ``lib``, as :func:`iir_launch`."""
    C, T = x.shape
    dev = x.device
    y = torch.empty((C, T), dtype=torch.float32, device=dev)
    x1_out = torch.empty_like(x1)
    y1_out = torch.empty_like(y1)
    layout = () if rows is None else (rows,)
    with on_device(dev):
        rc = lib.digiham_dc_block(
            x.data_ptr(), x.stride(0), x1.data_ptr(), y1.data_ptr(),
            y.data_ptr(), x1_out.data_ptr(), y1_out.data_ptr(), C, T,
            float(np.float32(alpha)), *layout, stream_pointer(dev))
    _check(rc, "dc_block")
    return y, x1_out, y1_out


def digitalvoice_iir(pcm: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                     forward, feedback, scale: float, gain: float):
    """K6's IIR: pcm [C, T] int16 or int32, xv and yv [C, 10] float32 ->
    (out [C, T] int16, new xv, new yv). CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    pcm = _rows("pcm", pcm, PCM_TYPES)
    C, T = pcm.shape
    xv = _carry("xv", xv, (C, ORDER))
    yv = _carry("yv", yv, (C, ORDER))
    if _route(pcm, xv, yv):
        return digitalvoice_iir_plain(pcm, xv, yv, forward, feedback, scale,
                                      gain)
    if C == 0 or T == 0:
        return (torch.empty((C, T), dtype=torch.int16, device=pcm.device),
                xv.clone(), yv.clone())
    got = iir_launch(library(SOURCE, _SIGNATURES), pcm, xv, yv, forward,
                     feedback, scale, gain, _block_rows_on(pcm.device, C))
    LAUNCHES["digitalvoice_iir"] += 1
    return got


def dc_block(x: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
             alpha: float):
    """K6's DC blocker: x [C, T], x1 and y1 [C] float32 -> (y [C, T], new
    x1, new y1). CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream."""
    x = _rows("x", x, (torch.float32,))
    C, T = x.shape
    x1 = _carry("x1", x1, (C,))
    y1 = _carry("y1", y1, (C,))
    if _route(x, x1, y1):
        return dc_block_plain(x, x1, y1, alpha)
    if C == 0 or T == 0:
        return torch.empty((C, T), dtype=torch.float32, device=x.device), \
            x1.clone(), y1.clone()
    got = dc_launch(library(SOURCE, _SIGNATURES), x, x1, y1, alpha,
                    _block_rows_on(x.device, C))
    LAUNCHES["dc_block"] += 1
    return got
