"""Kernel K1: the fused raw-IQ front (FM discriminator + RRC + century
demod) for Hopper, and its plain PyTorch version.

Replaces ``digiham_tpu/ops/demod_pallas.py::pallas_demod_fm_front_block``
(the Pallas body ``_make_kernel(front="fm_rrc")``). The CUDA C++ source is
``digiham_tpu_torch/csrc/demod_front.cu``; it is compiled with ``nvcc``
for ``sm_90a`` into ``build/digiham_tpu_torch/`` at first use, keyed by a
hash of the source, and bound with ``ctypes``.

:func:`demod_fm_front` takes the plain version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..dsp.demod import (CENTURY, DemodState, _demod_block_plain,
                         _eval_bounds)
from ..dsp.fm import fm_discriminator
from ..dsp.rrc import RrcState, rrc_filter_block

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "demod_front.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "digiham_tpu_torch"
# shared memory a Hopper block may opt into (H100: 227 KB = 232448 B),
# less headroom for the kernel's static shared variables
SMEM_LIMIT = 232448 - 1024
MIN_SPS, MAX_SPS = 3, 64
MODES = {("gfsk", False): 0, ("fsk", False): 1, ("fsk", True): 2}

LAUNCHES = 0
_LIB = None


def smem_bytes(L: int, ntaps: int, sps: int, n_centuries: int) -> int:
    """Dynamic shared memory of one block; keep in step with the carve-up
    at the top of the kernel in csrc/demod_front.cu."""
    lo, hi = _eval_bounds(sps)
    floats = ((ntaps - 1 + L) + L + ntaps + CENTURY * sps
              + CENTURY * (hi - lo) + (n_centuries + 1) * CENTURY
              + n_centuries * CENTURY + sps)
    return 4 * floats


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple[Path, float, str]:
    """Compile the kernel's shared library unless this source's build
    exists. Returns (path, seconds spent compiling, nvcc's -Xptxas -v
    report; empty when nothing was compiled)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libdemod_front_{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.digiham_demod_fm_front
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def demod_fm_front_plain(re, im, last_re, last_im, hist, taps, pos, offset,
                         ring, *, n_centuries: int, sps: int,
                         mode: str = "gfsk", invert: bool = False,
                         fm_scale: float = 5000.0):
    """The plain version of K1: FM discriminator, then the RRC over
    ``[hist | audio * fm_scale]``, then the century demod. Runs on any
    device. Returns (dibits [C, nc*100] uint8, pos, offset, ring,
    new_hist [C, ntaps-1])."""
    audio, _ = fm_discriminator(re, im, last_re, last_im)
    filt, rrc = rrc_filter_block(audio * fm_scale, RrcState(hist), taps=taps)
    dib, st = _demod_block_plain(filt, DemodState(pos, offset, ring),
                                 n_centuries, sps, mode, invert)
    return dib, st.pos, st.offset, st.volume_ring, rrc.history


def _check(re, im, last_re, last_im, hist, taps, pos, offset, ring,
           n_centuries, sps, mode, invert):
    C, L = re.shape
    ntaps = taps.shape[0]
    want = {
        "re": (re, torch.float32, (C, L)),
        "im": (im, torch.float32, (C, L)),
        "last_re": (last_re, torch.float32, (C,)),
        "last_im": (last_im, torch.float32, (C,)),
        "hist": (hist, torch.float32, (C, ntaps - 1)),
        "taps": (taps, torch.float32, (ntaps,)),
        "pos": (pos, torch.int32, (C,)),
        "offset": (offset, torch.int32, (C,)),
        "ring": (ring, torch.float32, (C, CENTURY)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != re.device:
            raise ValueError(f"{name} is on {t.device}, re on {re.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if (mode, bool(invert)) not in MODES:
        raise ValueError(f"mode={mode!r} invert={invert!r} not supported")
    if not MIN_SPS <= sps <= MAX_SPS or n_centuries < 1 or ntaps < 2:
        raise ValueError(f"sps={sps} ({MIN_SPS}..{MAX_SPS}), n_centuries="
                         f"{n_centuries}, ntaps={ntaps} not supported")
    if L <= ntaps:
        raise ValueError(f"block length {L} must exceed ntaps={ntaps}")
    need = smem_bytes(L, ntaps, sps, n_centuries)
    if need > SMEM_LIMIT:
        raise ValueError(f"block length {L} needs {need} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block may use")


def demod_fm_front(re, im, last_re, last_im, hist, taps, pos, offset, ring,
                   *, n_centuries: int, sps: int, mode: str = "gfsk",
                   invert: bool = False, fm_scale: float = 5000.0):
    """K1: FM discriminator + RRC + century demod of raw I/Q planes.

    re/im: [C, L] float32; last_re/last_im: [C] float32 carry; hist:
    [C, ntaps-1] float32 scaled-audio RRC history; taps: [ntaps] float32
    (the design's scaled taps); pos/offset: [C] int32; ring: [C, 100]
    float32. Requires pos >= 0 and L >= max(pos) + n_centuries*(100*sps+1)
    + 1; reads past L give 0.
    Returns (dibits [C, n_centuries*100] uint8, pos, offset, ring,
    new_hist). CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream."""
    global LAUNCHES
    if re.device.type == "cpu":
        return demod_fm_front_plain(
            re, im, last_re, last_im, hist, taps, pos, offset, ring,
            n_centuries=n_centuries, sps=sps, mode=mode, invert=invert,
            fm_scale=fm_scale)
    if re.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {re.device}")
    _check(re, im, last_re, last_im, hist, taps, pos, offset, ring,
           n_centuries, sps, mode, invert)
    args = [t.contiguous() for t in (re, im, last_re, last_im, hist, taps,
                                     pos, offset, ring)]
    C, L = re.shape
    ntaps = taps.shape[0]
    lo, hi = _eval_bounds(sps)
    dev = re.device
    dib = torch.empty((C, n_centuries * CENTURY), dtype=torch.uint8,
                      device=dev)
    pos_out = torch.empty((C,), dtype=torch.int32, device=dev)
    off_out = torch.empty((C,), dtype=torch.int32, device=dev)
    ring_out = torch.empty((C, CENTURY), dtype=torch.float32, device=dev)
    hist_out = torch.empty((C, ntaps - 1), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.digiham_demod_fm_front(
            *[t.data_ptr() for t in args],
            dib.data_ptr(), pos_out.data_ptr(), off_out.data_ptr(),
            ring_out.data_ptr(), hist_out.data_ptr(),
            C, L, ntaps, sps, lo, hi, n_centuries,
            MODES[(mode, bool(invert))], fm_scale, stream)
    if rc != 0:
        raise RuntimeError(f"K1 demod_fm_front launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return dib, pos_out, off_out, ring_out, hist_out
