"""The port's native host runtime (``digiham_tpu_torch/native``): every case
of tests/test_native.py against it; its results against the JAX package's
``digiham_tpu.native`` and against the port's numpy plain versions on the
same seeded inputs (the Viterbi with ties, blocked starts, T = 0 and 1, 4
and 16 states); what it refuses and how it fails (no fallback); its build
(lazily, into the build directory, named by a hash, two processes at once);
and its CMake package, built, installed beside the JAX package's into one
prefix and consumed. Tolerance: none, everything is integer or copied
bytes."""
import os
import re
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from digiham_tpu import native as j_native
from digiham_tpu_torch import native
from digiham_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "digiham_tpu_torch", "native")
J_NATIVE = os.path.join(ROOT, "digiham_tpu", "native")


def test_native_built():
    assert native.HAVE_NATIVE
    assert native.load() is native.load()
    assert native.library_path().parent == build.BUILD_DIR
    assert native.library_path().exists()


# --- the cases of tests/test_native.py ------------------------------------

class TestPacking:
    def test_hamming_distance(self):
        a = np.array([3, 1, 3, 3], np.uint8)
        b = np.array([3, 3, 3, 1], np.uint8)
        assert native.hamming_distance(a, b) == 2
        assert native.hamming_distance(a, a) == 0

    def test_pack_dibits(self):
        d = np.array([1, 3, 0, 2, 2, 0, 3, 1], np.uint8)
        want = bytes([(1 << 6) | (3 << 4) | (0 << 2) | 2,
                      (2 << 6) | (0 << 4) | (3 << 2) | 1])
        assert native.pack_dibits(d) == want

    def test_pack_bits(self):
        bits = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.uint8)
        assert native.pack_bits_msb(bits) == b"\xAA"
        assert native.pack_bits_lsb(bits) == b"\x55"

    def test_unpack_matches_pack(self):
        rng = np.random.default_rng(0)
        d = rng.integers(0, 4, 400).astype(np.uint8)
        packed = np.frombuffer(native.pack_dibits(d), np.uint8)
        # cross-check against the protocol-layer packer
        from digiham_tpu_torch.protocols.dmr.phases import (
            pack_dibits as py_pack)
        assert packed.tobytes() == py_pack(d)


class TestSyncScan:
    def test_finds_pattern(self):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 4, 1000).astype(np.uint8)
        pattern = np.array([3, 1, 3, 3, 3, 3, 1, 1, 1, 3], np.uint8)
        data[531:541] = pattern
        off = native.sync_scan(data, pattern, 0)
        assert 0 <= off <= 531
        d = native.sync_distances(data, pattern)
        assert d[531] == 0

    def test_tolerance(self):
        data = np.zeros(100, np.uint8)
        pattern = np.full(10, 3, np.uint8)
        corrupted = pattern.copy()
        corrupted[[2, 7]] = 0  # 4 bit errors
        data[50:60] = corrupted
        assert native.sync_scan(data, pattern, 3) == -1
        assert native.sync_scan(data, pattern, 4) == 50

    def test_no_match(self):
        assert native.sync_scan(np.zeros(5, np.uint8),
                                np.ones(10, np.uint8), 0) == -1


RING_BUFFERS = [native.RingBuffer, native.RingBufferPlain]


@pytest.mark.parametrize("ring", RING_BUFFERS, ids=["native", "plain"])
class TestRingBuffer:
    def test_write_peek_consume(self, ring):
        rb = ring(1 << 10)
        assert rb.write(b"hello world") == 11
        assert rb.available() == 11
        assert rb.peek(5) == b"hello"
        assert rb.consume(6) == 6
        assert rb.peek(5) == b"world"

    def test_wraparound(self, ring):
        rb = ring(16)
        for i in range(100):
            data = bytes([i % 256]) * 7
            assert rb.write(data) == 7
            assert rb.peek(7) == data
            assert rb.consume(7) == 7

    def test_full_buffer_partial_write(self, ring):
        rb = ring(16)
        assert rb.write(b"x" * 16) == 16
        assert rb.write(b"y") == 0
        rb.consume(4)
        assert rb.write(b"y" * 8) == 4

    def test_threaded_producer_consumer(self, ring):
        rb = ring(1 << 12)
        total = 200_000
        src = np.random.default_rng(2).integers(
            0, 256, total).astype(np.uint8).tobytes()
        received = bytearray()

        def producer():
            sent = 0
            while sent < total:
                n = rb.write(src[sent:sent + 1024])
                sent += n

        t = threading.Thread(target=producer)
        t.start()
        while len(received) < total:
            chunk = rb.peek(4096)
            if chunk:
                rb.consume(len(chunk))
                received.extend(chunk)
        t.join(timeout=60)
        assert not t.is_alive()
        assert bytes(received) == src


class TestDeinterleave:
    def test_matches_numpy(self):
        rng = np.random.default_rng(3)
        frames, channels = 1000, 8
        x = rng.normal(0, 1, frames * channels).astype(np.float32)
        got = native.deinterleave_f32(x, channels)
        want = x.reshape(frames, channels).T
        np.testing.assert_array_equal(got, want)


# --- against the JAX package's native and the port's plain versions -------

def _bytes(seed, n, top=256):
    return np.random.default_rng(seed).integers(0, top, n).astype(np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_plumbing_equals_jax_and_plain(seed):
    """Each function on seeded inputs: the port's native result equals the
    JAX package's and the port's plain version."""
    a, b = _bytes(seed, 301), _bytes(seed + 10, 301)
    dibits, bits = _bytes(seed, 403, 4), _bytes(seed, 1001, 2)
    pattern = _bytes(seed + 20, 24, 4)
    data = _bytes(seed + 30, 2000, 4)
    data[700 + seed:724 + seed] = pattern
    x = np.random.default_rng(seed).normal(0, 1, 6 * 777).astype(np.float32)
    for fn, args in (
            ("hamming_distance", (a, b)),
            ("sync_scan", (data, pattern, 0)),
            ("sync_scan", (data, pattern, 5)),
            ("sync_scan", (data[:10], pattern, 0)),
            ("pack_dibits", (dibits,)),
            ("pack_bits_lsb", (bits,)),
            ("pack_bits_msb", (bits,))):
        got = getattr(native, fn)(*args)
        assert got == getattr(j_native, fn)(*args), fn
        assert got == getattr(native, f"{fn}_plain")(*args), fn
    got = native.sync_distances(data, pattern)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, j_native.sync_distances(data, pattern))
    np.testing.assert_array_equal(got,
                                  native.sync_distances_plain(data, pattern))
    for channels in (1, 6, 7):  # 7: a partial last frame is dropped
        got = native.deinterleave_f32(x, channels)
        np.testing.assert_array_equal(got, j_native.deinterleave_f32(
            x, channels))
        np.testing.assert_array_equal(got, native.deinterleave_f32_plain(
            x, channels))


def _viterbi_input(kind, seed, T, states, blocked):
    rng = np.random.default_rng(seed)
    if kind == "noisy":
        from digiham_tpu_torch.fec.viterbi import conv_encode

        sent = rng.integers(0, 2, T)
        sent[:blocked] = 0
        obs = conv_encode(sent, states)
        flips = rng.random(T) < 0.1
        return np.where(flips, obs ^ rng.integers(1, 4, T), obs)
    if kind == "noise":  # uniform dibits: the most ties
        return rng.integers(0, 4, T)
    return np.full(T, 3 * (seed % 2))  # every path equal


VITERBI_CASES = [(states, blocked, T)
                 for states, blocked in ((16, 0), (16, 4), (4, 0), (4, 2))
                 for T in (1, 2, 5, 36, 96, 100, 330)]


@pytest.mark.parametrize("kind", ["noisy", "noise", "constant"])
@pytest.mark.parametrize("states,blocked,T", VITERBI_CASES)
def test_viterbi_equals_jax_and_plain(states, blocked, T, kind):
    """Bits and metric of one sequence: the port's native decode, JAX's
    native decode, the port's numpy plain version and JAX's numpy batch
    path, for two seeds; ties, blocked starts, 4 and 16 states."""
    for seed in (T, T + 1):
        obs = _viterbi_input(kind, seed, T, states, blocked)
        bits, metric = native.viterbi(obs, states, blocked)
        assert bits.dtype == np.uint8 and bits.shape == (T,)
        assert isinstance(metric, int)
        j_bits, j_metric = j_native.viterbi(obs, states, blocked)
        np.testing.assert_array_equal(bits, j_bits)
        assert metric == j_metric
        p_bits, p_metric = native.viterbi_plain(obs, states, blocked)
        np.testing.assert_array_equal(bits, p_bits)
        assert metric == p_metric
        from digiham_tpu.fec.viterbi import viterbi_decode_np

        n_bits, n_metric = viterbi_decode_np(obs[None], states, blocked)
        np.testing.assert_array_equal(bits, n_bits[0])
        assert metric == n_metric[0]


@pytest.mark.parametrize("states", [4, 16])
def test_viterbi_edges(states):
    """T = 0 gives no bits and metric 0 (the library is not asked to
    allocate nothing), as JAX's native decode gives; values above 3 are
    taken & 3, as the C code does."""
    bits, metric = native.viterbi(np.zeros(0, np.uint8), states, 0)
    assert bits.shape == (0,) and bits.dtype == np.uint8 and metric == 0
    j_bits, j_metric = j_native.viterbi(np.zeros(0, np.uint8), states, 0)
    assert j_bits.shape == (0,) and j_metric == 0
    obs = _bytes(states, 50)  # 0..255
    got = native.viterbi(obs, states, 0)
    want = native.viterbi(obs & 3, states, 0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == j_native.viterbi(obs, states, 0)[1]


def test_viterbi_refuses_what_the_library_cannot_take():
    with pytest.raises(ValueError, match="num_states"):
        native.viterbi(np.zeros(5, np.uint8), 8, 0)
    with pytest.raises(ValueError, match="blocked_steps"):
        native.viterbi(np.zeros(5, np.uint8), 16, 2)
    with pytest.raises(ValueError, match="dibits"):
        native.viterbi(np.zeros((2, 5), np.uint8), 16, 0)
    with pytest.raises(ValueError, match="sizes"):
        native.hamming_distance(np.zeros(3, np.uint8), np.zeros(4, np.uint8))
    with pytest.raises(ValueError, match="shorter"):
        native.sync_distances(np.zeros(3, np.uint8), np.zeros(4, np.uint8))


def test_a_failed_allocation_raises(monkeypatch):
    """dh_viterbi returns -1 when its malloc fails: no fallback, an
    error."""
    class Stub:
        @staticmethod
        def dh_viterbi(*args):
            return -1

    monkeypatch.setattr(native, "load", lambda: Stub)
    with pytest.raises(MemoryError):
        native.viterbi(np.zeros(10, np.uint8), 16, 0)


# --- the build --------------------------------------------------------------

def test_import_builds_nothing():
    """A fresh interpreter imports the module with no library loaded;
    HAVE_NATIVE is resolved at first read."""
    code = textwrap.dedent("""
        from digiham_tpu_torch import native
        assert native._lib is None
        assert "HAVE_NATIVE" not in vars(native)
        assert native.HAVE_NATIVE is True and native._lib is not None
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-800:]


def test_library_is_named_by_its_source_and_header(tmp_path):
    src = tmp_path / "x.cpp"
    hdr = tmp_path / "x.h"
    src.write_text('#include "x.h"\nextern "C" int f() { return X; }\n')
    hdr.write_text("#define X 7\n")
    first = build.host_library_path(src, [hdr], tmp_path)
    hdr.write_text("#define X 8\n")
    second = build.host_library_path(src, [hdr], tmp_path)
    assert first != second and first.parent == tmp_path
    assert first.name.startswith("libx_") and first.suffix == ".so"
    path, seconds, _ = build.build_host(src, [hdr], tmp_path)
    assert path == second and path.exists() and seconds > 0
    assert build.build_host(src, [hdr], tmp_path) == (path, 0.0, "")
    import ctypes

    assert ctypes.CDLL(str(path)).f() == 8


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return; }\n")
    with pytest.raises(RuntimeError, match="error"):
        build.build_host(src, [], tmp_path)
    assert list(tmp_path.glob("*.so")) == []  # no partial library left


def test_two_processes_building_at_once_leave_one_good_library(tmp_path):
    """Workers that reach their first call together: each compiles into a
    temporary file and moves it into place; one library is left, whole,
    and no temporary file."""
    out = tmp_path / "lib"
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import ctypes, os, time
        from pathlib import Path
        from digiham_tpu_torch import native
        from digiham_tpu_torch.ops import build
        while not os.path.exists({str(go)!r}):
            time.sleep(0.01)
        path, seconds, _ = build.build_host(native.SOURCE, [native.HEADER],
                                            Path({str(out)!r}))
        lib = native._bind(ctypes.CDLL(str(path)))
        a = (ctypes.c_uint8 * 2)(3, 1)
        print(path.name, seconds > 0, lib.dh_hamming_distance(a, a, 2))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.write_text("")
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-800:]
    names = {stdout.split()[0] for stdout, _ in results}
    assert [stdout.split()[2] for stdout, _ in results] == ["0", "0"]
    assert len(names) == 1
    assert sorted(f.name for f in out.iterdir()) == sorted(names)


# --- the CMake package ------------------------------------------------------

needs_cmake = pytest.mark.skipif(
    shutil.which("cmake") is None or shutil.which("g++") is None,
    reason="cmake/g++ not available")

CONSUMER_CMAKE = """
cmake_minimum_required(VERSION 3.16)
project(consumer CXX)
find_package(DigihamTpuTorchNative REQUIRED)
add_executable(consumer consumer.cpp)
target_link_libraries(consumer PRIVATE
    DigihamTpuTorchNative::digiham_tpu_torch_native)
"""

CONSUMER_CPP = r"""
#include <digiham_native.h>
#include <cstdio>
#include <cstring>

int main() {
    // hamming distance + pack round trip + ring buffer + the 4-state
    // Viterbi through the installed public header and shared library
    const uint8_t a[4] = {1, 3, 0, 2}, b[4] = {1, 1, 0, 2};
    if (dh_hamming_distance(a, b, 4) != 1) return 1;
    uint8_t packed[1];
    dh_pack_dibits(a, 4, packed);
    if (packed[0] != 0x72) return 2;  // 01 11 00 10
    uint8_t un[4];
    dh_unpack_dibits(packed, 4, un);
    if (memcmp(a, un, 4) != 0) return 3;
    dh_ringbuffer* rb = dh_rb_create(64);
    if (!rb) return 4;
    if (dh_rb_write(rb, packed, 1) != 1) return 5;
    uint8_t out[1];
    if (dh_rb_peek(rb, out, 1) != 1 || out[0] != 0x72) return 6;
    dh_rb_destroy(rb);
    const uint8_t coded[4] = {3, 1, 1, 3};  // bits 1 1 0 0 at 4 states
    uint8_t bits[4];
    if (dh_viterbi(coded, 4, 4, 0, bits) != 0) return 7;
    if (bits[0] != 1 || bits[1] != 1 || bits[2] != 0 || bits[3] != 0)
        return 8;
    printf("CONSUMER OK\n");
    return 0;
}
"""


def _run(cmd, **kw):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kw)
    assert r.returncode == 0, (cmd, r.stdout[-800:], r.stderr[-800:])
    return r


@needs_cmake
def test_cmake_package_installs_beside_the_jax_one_and_serves_a_consumer(
        tmp_path):
    """Both packages' CMake builds install into one prefix without a
    clash; a downstream project finds the port's with find_package and
    runs against it."""
    prefix = tmp_path / "prefix"
    for name, source in (("jax", J_NATIVE), ("port", NATIVE)):
        build_dir = tmp_path / f"build_{name}"
        _run(["cmake", "-S", source, "-B", str(build_dir),
              "-DCMAKE_BUILD_TYPE=Release"])
        _run(["cmake", "--build", str(build_dir), "-j2"])
        _run(["cmake", "--install", str(build_dir), "--prefix", str(prefix)])
    assert (prefix / "include" / "digiham_native.h").exists()  # the JAX one
    assert (prefix / "include" / "digiham_tpu_torch"
            / "digiham_native.h").exists()
    libdir = next(d for d in ("lib", "lib64")
                  if (prefix / d / "cmake" / "DigihamTpuTorchNative"
                      / "DigihamTpuTorchNativeConfig.cmake").exists())
    assert (prefix / libdir / "pkgconfig"
            / "digiham_tpu_torch_native.pc").exists()
    assert (prefix / libdir / "pkgconfig" / "digiham_tpu_native.pc").exists()
    assert list((prefix / libdir).glob("libdigiham_tpu_torch_native.so*"))
    assert list((prefix / libdir).glob("libdigiham_native.so*"))

    consumer = tmp_path / "consumer"
    consumer.mkdir()
    (consumer / "CMakeLists.txt").write_text(CONSUMER_CMAKE)
    (consumer / "consumer.cpp").write_text(CONSUMER_CPP)
    cbuild = tmp_path / "cbuild"
    _run(["cmake", "-S", str(consumer), "-B", str(cbuild),
          f"-DCMAKE_PREFIX_PATH={prefix}"])
    _run(["cmake", "--build", str(cbuild), "-j2"])
    r = _run([str(cbuild / "consumer")])
    assert "CONSUMER OK" in r.stdout


def test_header_matches_ctypes_binding():
    """Every dh_* symbol the ctypes binding loads is declared in the
    public header (the -dev contract), and the source is the JAX
    package's but for its comments."""
    with open(os.path.join(NATIVE, "include", "digiham_native.h")) as f:
        header = f.read()
    with open(os.path.join(NATIVE, "__init__.py")) as f:
        binding = f.read()
    used = set(re.findall(r"\bdh_[a-z0-9_]+\b", binding))
    declared = set(re.findall(r"\bdh_[a-z0-9_]+\b", header))
    missing = {s for s in used if s not in declared
               and not s.startswith("dh_ringbuffer")}
    assert not missing, f"ctypes uses symbols absent from header: {missing}"

    def code(path):
        with open(path) as f:
            text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
        return [ln.split("//")[0].rstrip() for ln in text.splitlines()
                if ln.split("//")[0].strip()]

    for part in ("src/digiham_native.cpp", "include/digiham_native.h"):
        assert code(os.path.join(NATIVE, part)) == code(
            os.path.join(J_NATIVE, part)), part
