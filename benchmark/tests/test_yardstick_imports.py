"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: each walked in a fresh process.
Top-level module names are compared whole (``digiham_tpu_torch`` begins
with ``digiham_tpu``)."""
import subprocess
import sys

import pytest

from benchmark import run
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "digiham_tpu"}


def _top_level(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys\nsys.path.insert(0, "
         f"{str(ROOT)!r})\n{code}\nprint(sorted({{m.split('.')[0] for m "
         f"in sys.modules}}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(eval(proc.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    pytest.importorskip("digiham_tpu_torch")
    names = _top_level(
        "import pkgutil, importlib, time, torch\n"
        "import benchmark, benchmark.run as run, benchmark.control\n"
        "for pkg in ('benchmark.harness', 'benchmark.reference',\n"
        "            'benchmark.synth'):\n"
        "    p = importlib.import_module(pkg)\n"
        "    for m in pkgutil.walk_packages(p.__path__, pkg + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "from benchmark.harness import spec\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import small_cell, run_small\n"
        "for m in spec.json.loads(spec.BENCHMARK_JSON.read_text())"
        "['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "for name in ('dmr_site.busy', 'ysf_site.live'):\n"
        "    run_small(small_cell(name), seconds=1.0, trace=True)\n")
    assert "digiham_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(
        "import pkgutil, importlib\n"
        "import numpy as np, torch\n"
        "for pkg in ('benchmark.reference', 'benchmark.synth'):\n"
        "    p = importlib.import_module(pkg)\n"
        "    for m in pkgutil.walk_packages(p.__path__, pkg + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "from benchmark.reference import dsp, stream\n"
        "from benchmark.synth import dmr, ysf\n"
        "rng = np.random.default_rng(1)\n"
        "for proto, tx in (('dmr', dmr), ('ysf', ysf)):\n"
        "    d = tx.call(rng, 2.0)\n"
        "    audio = torch.from_numpy(np.repeat(d, 10)[None].astype("
        "np.float32) * 300)\n"
        "    dib, _, _ = dsp.demodulate(audio, 10, 'wide')\n"
        "    stream.decode_channel(proto, d)\n")
    assert not names & (FORBIDDEN | {"digiham_tpu_torch"})


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "digiham_tpu_torch_probe", sys)
    assert "digiham_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "digiham_tpu.probe", sys)
    assert run.forbidden_modules() == ["digiham_tpu"]
