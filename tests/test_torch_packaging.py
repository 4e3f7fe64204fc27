"""The port's installed package must carry what it builds from: every file
under ``digiham_tpu_torch/csrc/`` (the kernels' CUDA sources and the
headers they include), ``digiham_tpu_torch/data/`` (the smoke fixtures)
and ``digiham_tpu_torch/native/`` (the host library's C++ source, header
and CMake package; its Python module is a package module) matches a
``package-data`` glob of ``pyproject.toml``. Its ten
command-line scripts (``<tool>_torch``) resolve to callables beside the
JAX package's ten, and an installed copy builds its kernels into the
user's cache, not beside ``site-packages``."""
import fnmatch
import importlib
import os
import tomllib
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "digiham_tpu_torch")


TOOLS = ("rrc_filter", "fsk_demodulator", "gfsk_demodulator",
         "digitalvoice_filter", "dmr_decoder", "ysf_decoder",
         "dstar_decoder", "nxdn_decoder", "pocsag_decoder",
         "mbe_synthesizer")


def _config():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _globs():
    return _config()["tool"]["setuptools"]["package-data"][
        "digiham_tpu_torch"]


@pytest.mark.parametrize("folder", ["csrc", "data", "native"])
def test_package_data_covers_every_file(folder):
    top = os.path.join(PACKAGE, folder)
    files = sorted(os.path.relpath(os.path.join(d, name), top)
                   for d, dirs, names in os.walk(top)
                   if "__pycache__" not in d
                   for name in names if not name.endswith(".py"))
    assert files
    globs = _globs()
    missing = [name for name in files
               if not any(fnmatch.fnmatch(f"{folder}/{name}", g)
                          for g in globs)]
    assert not missing, f"not shipped by {globs}: {missing}"


def test_the_shared_header_is_shipped():
    """csrc/fir_span.cuh, which fir.cu and demod_front.cu include."""
    for source in ("fir.cu", "demod_front.cu"):
        with open(os.path.join(PACKAGE, "csrc", source)) as f:
            assert '#include "fir_span.cuh"' in f.read(), source
    assert any(fnmatch.fnmatch("csrc/fir_span.cuh", g) for g in _globs())


@pytest.mark.parametrize("path", ["csrc/recurrence.cu",
                                  "csrc/recurrence_serial.cu",
                                  "data/cli_smoke.npz",
                                  "native/src/digiham_native.cpp",
                                  "native/include/digiham_native.h",
                                  "native/CMakeLists.txt"])
def test_this_slices_files_are_shipped(path):
    assert os.path.isfile(os.path.join(PACKAGE, path))
    assert any(fnmatch.fnmatch(path, g) for g in _globs())


@pytest.mark.parametrize("tool", TOOLS)
def test_scripts_resolve(tool):
    """``<tool>_torch`` is the port's, ``<tool>`` stays the JAX package's."""
    scripts = _config()["project"]["scripts"]
    assert scripts[tool] == f"digiham_tpu.cli.tools:{tool}_main"
    module, _, name = scripts[f"{tool}_torch"].partition(":")
    assert module == "digiham_tpu_torch.cli.tools"
    assert callable(getattr(importlib.import_module(module), name))


def test_build_directory_of_a_checkout():
    from digiham_tpu_torch.ops import build

    assert build.BUILD_DIR == Path(ROOT) / "build" / "digiham_tpu_torch"
    assert build.build_dir_for(Path(PACKAGE)) == build.BUILD_DIR


def test_build_directory_of_an_installed_package(tmp_path, monkeypatch):
    """Installed, the package lies in site-packages, with no pyproject.toml
    beside it: the libraries go to the user's cache, which is writable,
    and not to ``<prefix>/lib/python3.x/build``."""
    from digiham_tpu_torch.ops import build

    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    site = tmp_path / "prefix" / "lib" / "python3.12" / "site-packages"
    (site / "digiham_tpu_torch").mkdir(parents=True)
    site.parent.chmod(0o555)  # as a system prefix is to its users
    try:
        out = build.build_dir_for(site / "digiham_tpu_torch")
        assert out == home / ".cache" / "digiham_tpu_torch"
        assert site not in out.parents and site.parent not in out.parents
        out.mkdir(parents=True)
        assert os.access(out, os.W_OK)
    finally:
        site.parent.chmod(0o755)
