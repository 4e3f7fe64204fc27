"""Native host runtime (C++ through ctypes): the port of
``digiham_tpu/native``.

The library, ``src/digiham_native.cpp`` with its public header
``include/digiham_native.h``, holds the stream plumbing around the device
(SPSC ring buffer, packing, sync-pattern scanning, interleaved-stream
deframing) and the control plane's per-frame Viterbi decode, which
``fec/viterbi.py::viterbi_decode_np`` sends every 1-D sequence to (the YSF
header DCH, NXDN, the D-Star header). It is built with the host compiler at
the first call, never at import, by ``ops/build.py::build_host``: into the
package's build directory (``build/digiham_tpu_torch/`` of a checkout, else
the user's cache), named by a hash of the source and the header, written to
a temporary file and moved into place, so processes that reach their first
call together each find one whole library. ``CMakeLists.txt`` builds the
same source as a CMake package for C/C++ consumers.

Unlike the JAX package, nothing falls back: a failed build raises with the
compiler's output, and so does a failed allocation. The numpy bodies of the
JAX package's fallbacks are kept, public, as the plain versions
(``*_plain``, ``RingBufferPlain``) that the tests hold the library to; no
entry point switches to them. ``HAVE_NATIVE`` is kept for the JAX
package's API: reading it builds and loads the library (True, or the build
raises).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..fec.viterbi import _check_blocked_steps, viterbi_decode_np_plain
from ..ops import build

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "src" / "digiham_native.cpp"
HEADER = HERE / "include" / "digiham_native.h"

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source is (or will be) built."""
    return build.host_library_path(SOURCE, [HEADER])


def load():
    """The loaded library, built at the first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build.build_host(SOURCE, [HEADER])
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def __getattr__(name):
    if name == "HAVE_NATIVE":
        return load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _bind(lib):
    """Set argtypes/restypes; raises AttributeError on missing symbols."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dh_hamming_distance.restype = ctypes.c_int32
    lib.dh_hamming_distance.argtypes = [u8p, u8p, ctypes.c_size_t]
    lib.dh_sync_scan.restype = ctypes.c_int64
    lib.dh_sync_scan.argtypes = [u8p, ctypes.c_size_t, u8p,
                                 ctypes.c_size_t, ctypes.c_int32]
    lib.dh_sync_distances.restype = None
    lib.dh_sync_distances.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32)]
    for name in ("dh_pack_dibits", "dh_pack_bits_msb",
                 "dh_pack_bits_lsb", "dh_unpack_dibits"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.dh_rb_create.restype = ctypes.c_void_p
    lib.dh_rb_create.argtypes = [ctypes.c_size_t]
    lib.dh_rb_destroy.restype = None
    lib.dh_rb_destroy.argtypes = [ctypes.c_void_p]
    for name in ("dh_rb_available", "dh_rb_writeable"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.dh_rb_write.restype = ctypes.c_uint64
    lib.dh_rb_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.dh_rb_peek.restype = ctypes.c_uint64
    lib.dh_rb_peek.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.dh_rb_consume.restype = ctypes.c_uint64
    lib.dh_rb_consume.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dh_deinterleave_f32.restype = None
    lib.dh_deinterleave_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_float)]
    lib.dh_viterbi.restype = ctypes.c_int64
    lib.dh_viterbi.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, u8p]
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _windows(data: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Bit distance of the pattern at every offset (numpy)."""
    win = np.lib.stride_tricks.sliding_window_view(data, pattern.size)
    return np.unpackbits(win ^ pattern, axis=1).sum(axis=1)


def hamming_distance(a, b) -> int:
    """Bit distance of two byte arrays of one size (popcount of XOR)."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.size != b.size:
        raise ValueError(f"sizes differ: {a.size} and {b.size}")
    return int(load().dh_hamming_distance(_u8(a), _u8(b), a.size))


def hamming_distance_plain(a, b) -> int:
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    return int(np.unpackbits(a ^ b).sum())


def sync_scan(data, pattern, max_dist: int) -> int:
    """First offset with hamming distance <= max_dist, or -1."""
    data = np.ascontiguousarray(data, np.uint8)
    pattern = np.ascontiguousarray(pattern, np.uint8)
    return int(load().dh_sync_scan(_u8(data), data.size, _u8(pattern),
                                   pattern.size, max_dist))


def sync_scan_plain(data, pattern, max_dist: int) -> int:
    data = np.ascontiguousarray(data, np.uint8)
    pattern = np.ascontiguousarray(pattern, np.uint8)
    if data.size < pattern.size:
        return -1
    hits = np.nonzero(_windows(data, pattern) <= max_dist)[0]
    return int(hits[0]) if len(hits) else -1


def sync_distances(data, pattern) -> np.ndarray:
    """The pattern's bit distance at every offset: int32 [n - plen + 1]."""
    data = np.ascontiguousarray(data, np.uint8)
    pattern = np.ascontiguousarray(pattern, np.uint8)
    n = data.size - pattern.size + 1
    if n <= 0:
        raise ValueError(f"data of {data.size} bytes is shorter than the "
                         f"pattern of {pattern.size}")
    out = np.zeros(n, np.int32)
    load().dh_sync_distances(_u8(data), data.size, _u8(pattern),
                             pattern.size,
                             out.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_int32)))
    return out


def sync_distances_plain(data, pattern) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    pattern = np.ascontiguousarray(pattern, np.uint8)
    return _windows(data, pattern).astype(np.int32)


def pack_dibits(dibits) -> bytes:
    """Dibits 4 a byte, MSB first."""
    d = np.ascontiguousarray(dibits, np.uint8)
    out = np.zeros((d.size + 3) // 4, np.uint8)
    load().dh_pack_dibits(_u8(d), d.size, _u8(out))
    return out.tobytes()


def pack_dibits_plain(dibits) -> bytes:
    d = np.ascontiguousarray(dibits, np.uint8)
    out = np.zeros((d.size + 3) // 4, np.uint8)
    for i in range(d.size):
        out[i // 4] |= (d[i] & 3) << (6 - 2 * (i % 4))
    return out.tobytes()


def pack_bits_lsb(bits) -> bytes:
    """Bits 8 a byte, LSB first (the D-Star voice convention)."""
    b = np.ascontiguousarray(bits, np.uint8)
    out = np.zeros((b.size + 7) // 8, np.uint8)
    load().dh_pack_bits_lsb(_u8(b), b.size, _u8(out))
    return out.tobytes()


def pack_bits_lsb_plain(bits) -> bytes:
    b = np.ascontiguousarray(bits, np.uint8)
    return np.packbits(b, bitorder="little").tobytes()


def pack_bits_msb(bits) -> bytes:
    """Bits 8 a byte, MSB first."""
    b = np.ascontiguousarray(bits, np.uint8)
    out = np.zeros((b.size + 7) // 8, np.uint8)
    load().dh_pack_bits_msb(_u8(b), b.size, _u8(out))
    return out.tobytes()


def pack_bits_msb_plain(bits) -> bytes:
    b = np.ascontiguousarray(bits, np.uint8)
    return np.packbits(b).tobytes()


def deinterleave_f32(interleaved: np.ndarray, channels: int) -> np.ndarray:
    """[frames*channels] interleaved f32 -> [channels, frames]."""
    x = np.ascontiguousarray(interleaved, np.float32)
    frames = x.size // channels
    out = np.zeros((channels, frames), np.float32)
    load().dh_deinterleave_f32(_f32(x), frames, channels, _f32(out))
    return out


def deinterleave_f32_plain(interleaved: np.ndarray,
                           channels: int) -> np.ndarray:
    x = np.ascontiguousarray(interleaved, np.float32)
    frames = x.size // channels
    return x[:frames * channels].reshape(frames, channels).T.copy()


def viterbi(dibits: np.ndarray, num_states: int = 16,
            blocked_steps: int = 0):
    """Native 16/4-state Viterbi: [T] dibits (each taken & 3) -> (bits [T]
    uint8, metric int). T = 0 gives no bits and metric 0. Raises
    MemoryError if the library cannot allocate its decisions."""
    if num_states not in (4, 16):
        raise ValueError(f"num_states must be 4 or 16, got {num_states}")
    _check_blocked_steps(num_states, blocked_steps)
    d = np.ascontiguousarray(dibits, np.uint8)
    if d.ndim != 1:
        raise ValueError(f"dibits: want [T], got shape {d.shape}")
    out = np.zeros(d.size, np.uint8)
    lib = load()
    if d.size == 0:  # malloc(0) may give NULL: nothing to decode
        return out, 0
    metric = lib.dh_viterbi(_u8(d), d.size, num_states, blocked_steps,
                            _u8(out))
    if metric < 0:
        raise MemoryError(f"dh_viterbi could not allocate the decisions of "
                          f"{d.size} steps")
    return out, int(metric)


def viterbi_plain(dibits: np.ndarray, num_states: int = 16,
                  blocked_steps: int = 0):
    """The numpy decode of one sequence, returned as :func:`viterbi`
    returns it."""
    bits, metric = viterbi_decode_np_plain(
        np.asarray(dibits, np.int64), num_states, blocked_steps)
    return bits.astype(np.uint8), int(metric)


class RingBuffer:
    """Native SPSC byte ring buffer; capacity rounds up to a power of 2."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = load()
        self._handle = self._lib.dh_rb_create(capacity)
        if not self._handle:
            raise MemoryError("ring buffer allocation failed")

    def available(self) -> int:
        return int(self._lib.dh_rb_available(self._handle))

    def write(self, data: bytes) -> int:
        arr = np.frombuffer(bytes(data), np.uint8)
        return int(self._lib.dh_rb_write(self._handle, _u8(arr), arr.size))

    def peek(self, n: int) -> bytes:
        out = np.zeros(n, np.uint8)
        got = int(self._lib.dh_rb_peek(self._handle, _u8(out), n))
        return out[:got].tobytes()

    def consume(self, n: int) -> int:
        return int(self._lib.dh_rb_consume(self._handle, n))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dh_rb_destroy(self._handle)
            self._handle = None


class RingBufferPlain:
    """The plain version of :class:`RingBuffer`: a locked bytearray of
    ``capacity`` bytes."""

    def __init__(self, capacity: int = 1 << 20):
        self._buf = bytearray()
        self._cap = capacity
        self._lock = threading.Lock()

    def available(self) -> int:
        with self._lock:
            return len(self._buf)

    def write(self, data: bytes) -> int:
        data = bytes(data)
        with self._lock:
            n = min(len(data), self._cap - len(self._buf))
            self._buf.extend(data[:n])
            return n

    def peek(self, n: int) -> bytes:
        with self._lock:
            return bytes(self._buf[:n])

    def consume(self, n: int) -> int:
        with self._lock:
            n = min(n, len(self._buf))
            del self._buf[:n]
            return n
