"""Kernels K1, K2 and K3: the century demodulator for Hopper behind one of
three fronts, and their plain PyTorch versions.

| kernel | front  | input            | replaces, in ops/demod_pallas.py |
|--------|--------|------------------|----------------------------------|
| K1     | fm_rrc | raw I/Q planes   | ``pallas_demod_fm_front_block``  |
| K2     | rrc    | FM audio         | ``pallas_demod_front_block``     |
| K3     | none   | filtered samples | ``pallas_demod_block``           |

(``ops/demod_pallas.py`` of ``digiham_tpu``.)

The three are one CUDA C++ source, ``digiham_tpu_torch/csrc/demod_front.cu``
(a ``FRONT`` template parameter beside ``MODE``, one C entry per front),
built and bound by :mod:`.build`.

One block per channel filters one century window at a time: century ``c``
can only read inside :func:`century_window`, known before the loop
starts, so some warps filter that window (and start the copies of the
next one's inputs) while the others take the statistics of century
``c - 1``. Shared memory (:func:`smem_bytes`) does not depend
on the block length, every channel of a 256-channel bank is resident at
once (:func:`occupancy`), and a block of any length runs.

:func:`demod_fm_front`, :func:`demod_front` and :func:`demod` take the
plain version for CPU tensors only; for a CUDA tensor they launch the
kernel or raise. ``LAUNCHES[front]`` counts kernel launches, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..dsp.demod import (CENTURY, DemodState, _demod_block_plain,
                         _eval_bounds)
from ..dsp.fm import fm_discriminator
from .build import SMEM_LIMIT, library, on_device, stream_pointer
from .fir import rrc_filter_block_plain

SOURCE = "demod_front.cu"
MIN_SPS, MAX_SPS = 3, 128  # the JAX kernel's range (demod_pallas.py:85)
MODES = {("gfsk", False): 0, ("fsk", False): 1, ("fsk", True): 2}
KERNELS = {"fm_rrc": "K1", "rrc": "K2", "none": "K3"}

LAUNCHES = dict.fromkeys(KERNELS, 0)

FRONTS = {"fm_rrc": 0, "rrc": 1, "none": 2}  # enum Front of the source
SLACK = 8  # floats past a window that the kernel's FIR may read

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "digiham_demod_fm_front": [_P] * 14 + [_I] * 8 + [ctypes.c_float, _P],
    "digiham_demod_front": [_P] * 11 + [_I] * 8 + [_P],
    "digiham_demod": [_P] * 8 + [_I] * 7 + [_P],
    "digiham_demod_occupancy": [_I] * 5 + [ctypes.POINTER(_I)] * 2,
}


def century_window(c: int, sps: int) -> tuple[int, int]:
    """(start, length) of the filtered samples century ``c`` of a block
    can read, ``start`` relative to the ``pos`` the block entered with.

    Century ``c`` reads ``pos_c + e + (offset_c if e >= sps else 0)`` for
    ``e < 100*sps``; ``pos_c`` is the entry pos plus ``c*100*sps`` plus the
    entry offset and the ``c - 1`` slews since, each in {-1, 0, 1}. So it
    stays inside ``[c*n - c - 1, (c+1)*n + c + 1]`` with ``n = 100*sps``:
    ``n + 2c + 3`` samples. Keep in step with window_start() and
    window_len() in csrc/demod_front.cu."""
    n = CENTURY * sps
    return c * n - c - 1, n + 2 * c + 3


def _round4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(ntaps: int, sps: int, n_centuries: int,
               front: str = "fm_rrc") -> int:
    """Dynamic shared memory of one block; keep in step with carve() in
    csrc/demod_front.cu. Two input slots (two planes each for raw I/Q)
    hold the inputs of the widest century window with their RRC history;
    fronts with an RRC add two slots of the filtered widest window and the
    taps, "fm_rrc" one discriminated window too; the row-fold scratch,
    ring + volumes, mid means and two sets of ``sps`` column variances are
    common. Nothing depends on the block length. ``ntaps`` is ignored for front
    "none"."""
    halo = 0 if front == "none" else ntaps - 1
    lead = 1 if front == "fm_rrc" else 0
    widest = century_window(n_centuries - 1, sps)[1]
    floats = (2 * (2 if front == "fm_rrc" else 1)
              * _round4(widest + halo + lead + SLACK))
    if front == "fm_rrc":
        floats += _round4(widest + halo + SLACK)
    if front != "none":
        floats += 2 * _round4(widest) + _round4(ntaps + 3)
    floats += CENTURY * ((sps + 1) // 2)
    floats += ((n_centuries + 1) * CENTURY + n_centuries * CENTURY
               + 2 * sps)
    return 4 * floats


def occupancy(front: str, ntaps: int, sps: int, n_centuries: int,
              mode: str = "gfsk", invert: bool = False) -> tuple[int, int]:
    """(blocks of this front's kernel the CUDA runtime keeps resident on
    one SM at this carve-up, the current device's SM count): their product
    is the number of channels that run at once. Needs the card."""
    blocks, sms = _I(0), _I(0)
    fn = library(SOURCE, _SIGNATURES).digiham_demod_occupancy
    rc = fn(FRONTS[front], MODES[(mode, bool(invert))], ntaps, sps,
            n_centuries, ctypes.byref(blocks), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"{KERNELS[front]} occupancy query failed: CUDA "
                           f"error {rc}")
    return blocks.value, sms.value


def demod_fm_front_plain(re, im, last_re, last_im, hist, taps, pos, offset,
                         ring, *, n_centuries: int, sps: int,
                         mode: str = "gfsk", invert: bool = False,
                         fm_scale: float = 5000.0):
    """The plain version of K1: FM discriminator, then the RRC over
    ``[hist | audio * fm_scale]``, then the century demod. Runs on any
    device. Returns (dibits [C, nc*100] uint8, pos, offset, ring,
    new_hist [C, ntaps-1])."""
    audio, _ = fm_discriminator(re, im, last_re, last_im)
    return demod_front_plain(audio * fm_scale, hist, taps, pos, offset, ring,
                             n_centuries=n_centuries, sps=sps, mode=mode,
                             invert=invert)


def demod_front_plain(samples, hist, taps, pos, offset, ring, *,
                      n_centuries: int, sps: int, mode: str = "gfsk",
                      invert: bool = False):
    """The plain version of K2: the RRC over ``[hist | samples]`` (K4's
    plain version, so no kernel runs here on any device), then the
    century demod. Runs on any device. Returns (dibits, pos, offset, ring,
    new_hist), the new history being the raw input tail."""
    filt, new_hist = rrc_filter_block_plain(samples, hist, taps)
    return (*demod_plain(filt, pos, offset, ring, n_centuries=n_centuries,
                         sps=sps, mode=mode, invert=invert), new_hist)


def demod_plain(samples, pos, offset, ring, *, n_centuries: int, sps: int,
                mode: str = "gfsk", invert: bool = False):
    """The plain version of K3: the century demod of filtered samples.
    Runs on any device. Returns (dibits, pos, offset, ring)."""
    dib, st = _demod_block_plain(samples, DemodState(pos, offset, ring),
                                 n_centuries, sps, mode, invert)
    return dib, st.pos, st.offset, st.volume_ring


def _check(front, want, ntaps, n_centuries, sps, mode, invert):
    """Raise on what the kernel does not take. ``want``: name -> (tensor,
    dtype, shape); the first entry is the [C, L] row. ``ntaps``: 0 for
    front "none"."""
    first = next(iter(want.values()))[0]
    for name, (t, dtype, shape) in want.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    L = first.shape[1]
    if (mode, bool(invert)) not in MODES:
        raise ValueError(f"mode={mode!r} invert={invert!r} not supported")
    if not MIN_SPS <= sps <= MAX_SPS or n_centuries < 1:
        raise ValueError(f"sps={sps} ({MIN_SPS}..{MAX_SPS}), n_centuries="
                         f"{n_centuries} not supported")
    if front != "none" and (ntaps < 2 or L <= ntaps):
        raise ValueError(f"block length {L} must exceed ntaps={ntaps} >= 2")
    need = smem_bytes(ntaps, sps, n_centuries, front)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{KERNELS[front]} at sps {sps} with {ntaps} taps and "
            f"{n_centuries} centuries needs {need} B of shared memory, "
            f"over the {SMEM_LIMIT} B a block may use")


def _launch(front, entry, inputs, ntaps, n_centuries, sps, mode, invert,
            extra=()):
    """Allocate the outputs, launch ``entry`` on the current stream, count
    the launch. ``inputs``: the input tensors in the C entry's order, the
    [C, L] row first. ``ntaps``: 0 for front "none" (no history out)."""
    C, L = inputs[0].shape
    dev = inputs[0].device
    lo, hi = _eval_bounds(sps)
    inputs = [t.contiguous() for t in inputs]
    outs = [torch.empty((C, n_centuries * CENTURY), dtype=torch.uint8,
                        device=dev),
            torch.empty((C,), dtype=torch.int32, device=dev),
            torch.empty((C,), dtype=torch.int32, device=dev),
            torch.empty((C, CENTURY), dtype=torch.float32, device=dev)]
    dims = [C, L]
    if ntaps:
        outs.append(torch.empty((C, ntaps - 1), dtype=torch.float32,
                                device=dev))
        dims.append(ntaps)
    fn = getattr(library(SOURCE, _SIGNATURES), entry)
    with on_device(dev):
        stream = stream_pointer(dev)
        rc = fn(*[t.data_ptr() for t in inputs + outs], *dims, sps, lo, hi,
                n_centuries, MODES[(mode, bool(invert))], *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNELS[front]} {entry} launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[front] += 1
    return tuple(outs)


def _route(front, row):
    """True: the plain version (CPU tensor). False: the kernel."""
    if row.device.type == "cpu":
        return True
    if row.device.type != "cuda":
        raise ValueError(f"no {KERNELS[front]} kernel for device "
                         f"{row.device}")
    return False


def demod_fm_front(re, im, last_re, last_im, hist, taps, pos, offset, ring,
                   *, n_centuries: int, sps: int, mode: str = "gfsk",
                   invert: bool = False, fm_scale: float = 5000.0):
    """K1: FM discriminator + RRC + century demod of raw I/Q planes.

    re/im: [C, L] float32; last_re/last_im: [C] float32 carry; hist:
    [C, ntaps-1] float32 scaled-audio RRC history; taps: [ntaps] float32
    (the design's scaled taps); pos/offset: [C] int32; ring: [C, 100]
    float32. Requires pos >= 0, offset in {-1, 0, 1} (what the demod
    produces; the kernel takes anything else as 0) and L >= max(pos) +
    n_centuries*(100*sps+1) + 1; reads past L give 0. L may be any length
    over ntaps.
    Returns (dibits [C, n_centuries*100] uint8, pos, offset, ring,
    new_hist). CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream."""
    if _route("fm_rrc", re):
        return demod_fm_front_plain(
            re, im, last_re, last_im, hist, taps, pos, offset, ring,
            n_centuries=n_centuries, sps=sps, mode=mode, invert=invert,
            fm_scale=fm_scale)
    C, L = re.shape
    ntaps = taps.shape[0]
    _check("fm_rrc", {
        "re": (re, torch.float32, (C, L)),
        "im": (im, torch.float32, (C, L)),
        "last_re": (last_re, torch.float32, (C,)),
        "last_im": (last_im, torch.float32, (C,)),
        "hist": (hist, torch.float32, (C, ntaps - 1)),
        "taps": (taps, torch.float32, (ntaps,)),
        "pos": (pos, torch.int32, (C,)),
        "offset": (offset, torch.int32, (C,)),
        "ring": (ring, torch.float32, (C, CENTURY)),
    }, ntaps, n_centuries, sps, mode, invert)
    return _launch("fm_rrc", "digiham_demod_fm_front",
                   [re, im, last_re, last_im, hist, taps, pos, offset, ring],
                   ntaps, n_centuries, sps, mode, invert, extra=(fm_scale,))


def demod_front(samples, hist, taps, pos, offset, ring, *, n_centuries: int,
                sps: int, mode: str = "gfsk", invert: bool = False):
    """K2: RRC + century demod of FM audio.

    samples: [C, L] float32 unfiltered; hist: [C, ntaps-1] float32 input
    history; taps, pos, offset, ring and the window contract as
    :func:`demod_fm_front`. Returns (dibits, pos, offset, ring, new_hist);
    the new history is the raw input tail ``samples[:, L-ntaps+1:]``."""
    if _route("rrc", samples):
        return demod_front_plain(samples, hist, taps, pos, offset, ring,
                                 n_centuries=n_centuries, sps=sps, mode=mode,
                                 invert=invert)
    C, L = samples.shape
    ntaps = taps.shape[0]
    _check("rrc", {
        "samples": (samples, torch.float32, (C, L)),
        "hist": (hist, torch.float32, (C, ntaps - 1)),
        "taps": (taps, torch.float32, (ntaps,)),
        "pos": (pos, torch.int32, (C,)),
        "offset": (offset, torch.int32, (C,)),
        "ring": (ring, torch.float32, (C, CENTURY)),
    }, ntaps, n_centuries, sps, mode, invert)
    return _launch("rrc", "digiham_demod_front",
                   [samples, hist, taps, pos, offset, ring], ntaps,
                   n_centuries, sps, mode, invert)


def demod(samples, pos, offset, ring, *, n_centuries: int, sps: int,
          mode: str = "gfsk", invert: bool = False):
    """K3: century demod of samples that are filtered already.

    samples: [C, L] float32 of any length; pos, offset, ring and the
    window contract as :func:`demod_fm_front`.
    Returns (dibits, pos, offset, ring)."""
    if _route("none", samples):
        return demod_plain(samples, pos, offset, ring,
                           n_centuries=n_centuries, sps=sps, mode=mode,
                           invert=invert)
    C, L = samples.shape
    _check("none", {
        "samples": (samples, torch.float32, (C, L)),
        "pos": (pos, torch.int32, (C,)),
        "offset": (offset, torch.int32, (C,)),
        "ring": (ring, torch.float32, (C, CENTURY)),
    }, 0, n_centuries, sps, mode, invert)
    return _launch("none", "digiham_demod", [samples, pos, offset, ring], 0,
                   n_centuries, sps, mode, invert)
