"""Build and load the package's CUDA sources (``csrc/*.cu``) and its host
C++ library (``native/``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, named by a hash of the source and of
every header beside it (``csrc/*.cuh``; the sources include them with
``-I csrc``): a changed source or header is a new library, an unchanged
one is reused. Libraries go to ``build/digiham_tpu_torch/`` at the root
of the checkout when the package runs from one (a ``pyproject.toml``
beside the package), and otherwise, for an installed package, to the
user's cache, ``~/.cache/digiham_tpu_torch`` (:func:`build_dir_for`).
Nothing is built when a module is imported; the first launch of a kernel
builds its source. :func:`build_host` builds a C++ source with the host
compiler (``g++``, or ``$CXX``) the same way, for ``native/``. A library is
written to a temporary file and moved into place, so processes that build
at once each leave a whole library and none loads a partial one. A failed
build raises with the compiler's output: no caller falls back to a plain
version.

``python3 -m digiham_tpu_torch.ops.build`` builds every library ahead of
its first use: each ``csrc/*.cu`` with ``nvcc`` and ``native/`` with the
host compiler, all started together, and prints one JSON line a library
(its path, the seconds spent, whether it was built or found); a second run
finds them all. An image build or a post-install step runs it so that the
first kernel of the ``*_torch`` tools does not wait on a compiler. Without
``nvcc`` or the host compiler it names the missing tool and exits 1.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"


def build_dir_for(package: Path) -> Path:
    """Where the libraries of the package at ``package`` are built: the
    checkout's ``build/digiham_tpu_torch`` (ignored by git) when the package
    sits in a checkout, else the user's cache. An installed package lies in
    ``site-packages``, whose parent directories need not be writable."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "digiham_tpu_torch"
    return Path.home() / ".cache" / "digiham_tpu_torch"


BUILD_DIR = build_dir_for(PACKAGE)
# shared memory a Hopper block may opt into (H100: 227 KB = 232448 B),
# less headroom for a kernel's static shared variables
SMEM_LIMIT = 232448 - 1024

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return found


def _named_by(path: Path, parts, build_dir: Path) -> Path:
    """``build_dir/lib<stem of path>_<hash>.so``, the hash taken over every
    part (by name, then content)."""
    digest = hashlib.sha256()
    for part in parts:
        data = part.read_bytes()
        digest.update(f"{part.name}:{len(data)}:".encode())
        digest.update(data)
    return build_dir / f"lib{path.stem}_{digest.hexdigest()[:16]}.so"


def library_path(source: str, csrc: Path = CSRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``<csrc>/<source>`` is built: its name carries a
    hash of the source and of every ``*.cuh`` in ``csrc`` (by name, then
    content), so an edit to a shared header never finds a stale library."""
    path = csrc / source
    return _named_by(path, [path, *sorted(csrc.glob("*.cuh"))], build_dir)


def host_library_path(source: Path, headers=(),
                      build_dir: Path = BUILD_DIR) -> Path:
    """Where :func:`build_host` builds ``source``: named by a hash of it and
    of the headers it includes."""
    return _named_by(source, [source, *headers], build_dir)


def _compile(out: Path, command, what: str) -> tuple[float, str]:
    """Run ``command(tmp)``, which writes a library to ``tmp``, a new file
    beside ``out``, then move it to ``out`` (``os.replace``: a process that
    loads ``out`` finds the old library or the whole new one). Returns
    (seconds, the compiler's output); raises with that output if it
    fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return seconds, proc.stdout + proc.stderr


def build(source: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless this source's build exists.
    Returns (library path, seconds spent compiling, nvcc's -Xptxas -v
    report; empty when nothing was compiled)."""
    path = CSRC / source
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    seconds, report = _compile(out, lambda tmp: [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-I", str(CSRC), "-o", tmp, str(path)], f"nvcc on {source}")
    return out, seconds, report


def build_host(source: Path, headers=(),
               build_dir: Path = BUILD_DIR) -> tuple[Path, float, str]:
    """Compile the C++ file ``source`` with the host compiler (``-O3
    -shared -fPIC -std=c++17``) into ``build_dir`` unless this build of it
    and its ``headers`` exists. Returns (library path, seconds spent
    compiling, the compiler's output; empty when nothing was compiled)."""
    out = host_library_path(source, headers, build_dir)
    if out.exists():
        return out, 0.0, ""
    compiler = cxx()
    seconds, report = _compile(out, lambda tmp: [
        compiler, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
        str(source)], f"{compiler} on {source.name}")
    return out, seconds, report


def library(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` (built at first use).
    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry returns a ``cudaError_t`` as int. Pointers and the stream must
    be ``ctypes.c_void_p``, or ctypes cuts them to 32 bits."""
    lib = _LIBS.get(source)
    if lib is None:
        path, _, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def on_device(dev):
    """A context in which ``dev`` (a CUDA ``torch.device``) is the current
    device: entered only when it is not already, since most launches run on
    the current device and the switch costs the host as much as a launch."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_pointer(dev) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on ``dev`` as an
    integer. ``torch.cuda.current_stream`` builds a Stream object on every
    call, which costs the host more than the launch it is for; the raw
    getter behind it is taken where this PyTorch has it."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def sources() -> list[str]:
    """Every CUDA source of the package, ``csrc/*.cu``: what
    :func:`build_all` builds."""
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build_all() -> list[tuple[str, Path, float, str]]:
    """Build every CUDA source (:func:`sources`) and the native host
    library, all started together, unless built already. Returns (source
    as a path in the package, library, seconds compiling, the compiler's
    report) for each, the host library last; raises on the first failed
    build."""
    from .. import native

    names = sources()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(build_host, native.SOURCE, [native.HEADER])
        built = list(pool.map(build, names))
        done = [(f"csrc/{n}", *b) for n, b in zip(names, built)]
        return done + [(str(native.SOURCE.relative_to(PACKAGE)),
                        *host.result())]


def missing_tools() -> list[str]:
    """The compilers :func:`build_all` needs and cannot find, each with
    its error."""
    out = []
    for find in (nvcc, cxx):
        try:
            find()
        except RuntimeError as e:
            out.append(str(e))
    return out


def main(argv=None) -> int:
    missing = missing_tools()
    if missing:
        print("cannot build: " + "; ".join(missing), file=sys.stderr)
        return 1
    for source, path, seconds, _ in build_all():
        print(json.dumps({"source": f"digiham_tpu_torch/{source}",
                          "library": str(path), "seconds": seconds,
                          "cached": seconds == 0.0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
