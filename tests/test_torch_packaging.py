"""The port's installed package must carry what it builds from: every file
under ``digiham_tpu_torch/csrc/`` (the kernels' CUDA sources and the
headers they include) and ``digiham_tpu_torch/data/`` (the smoke
fixtures) matches a ``package-data`` glob of ``pyproject.toml``."""
import fnmatch
import os
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "digiham_tpu_torch")


def _globs():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        config = tomllib.load(f)
    return config["tool"]["setuptools"]["package-data"]["digiham_tpu_torch"]


@pytest.mark.parametrize("folder", ["csrc", "data"])
def test_package_data_covers_every_file(folder):
    files = sorted(os.listdir(os.path.join(PACKAGE, folder)))
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
