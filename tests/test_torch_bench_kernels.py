"""The kernel A/B program (``digiham_tpu_torch/bench/kernels.py``, the port
of tools/bench_fir.py, tools/bench_demod_pallas.py and tools/bench_trellis.py),
its bound arithmetic, K3's ablations in ``ops/variants.py`` and the prebuild
(``python3 -m digiham_tpu_torch.ops.build``) on the CPU:

- the moved bound arithmetic reproduces PERF.md's K1, K4 and K5 rows
  (bytes, operations and bound of the shapes they were measured at), and
  ``chip_smoke.py`` takes it from ``bench/kernels.py`` instead of its own
  (its phase 5 times every kernel through ``kernels.ab``);
- ``bench.common.plain_versions`` puts each K1-K5 wrapper's plain version
  where its callers look it up, and restores the wrapper after;
- the program needs a card: without one, and with ``--device cpu``, it
  prints the failure line and exits 1;
- K3's ablations replace text that the committed source has;
- ``ops.build`` builds every ``csrc/*.cu`` and the native source; without
  ``nvcc`` it exits 1 and names it.
"""
import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from digiham_tpu_torch import native
from digiham_tpu_torch.bench import kernels
from digiham_tpu_torch.ops import build, demod_front, variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


def _t(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_k1_row():
    """K1 at 256 ch x 16 centuries, sps 10, 81 taps, L 16,128: 33.8 MB,
    0.863 GFLOP, 0.01288 ms by operations (PERF.md)."""
    C, L, n, ntaps = 256, 16128, 1600, 81
    i32 = torch.int32
    inputs = [_t((C, L)), _t((C, L)), _t((C,)), _t((C,)), _t((C, ntaps - 1)),
              _t((ntaps,)), _t((C,), i32), _t((C,), i32), _t((C, 100))]
    outputs = [_t((C, n), torch.uint8), _t((C,), i32), _t((C,), i32),
               _t((C, 100)), _t((C, ntaps - 1))]
    moved = kernels.nbytes(inputs + outputs)
    ops = kernels.demod_operations(C, L, ntaps, 16, 10, True)
    ms, by = kernels.bound(moved, ops)
    assert round(moved / 1e6, 1) == 33.8
    assert round(ops / 1e9, 3) == 0.863
    assert round(ms, 5) == 0.01288 and by == "operations"


def test_k4_row():
    """K4 at 256 ch x 16,128 samples, 81 taps: 33.2 MB, 0.669 GFLOP,
    0.00998 ms by operations."""
    C, L, ntaps = 256, 16128, 81
    inputs = [_t((C, L)), _t((C, ntaps - 1)), _t((ntaps,))]
    outputs = [_t((C, L)), _t((C, ntaps - 1))]
    moved = kernels.nbytes(inputs + outputs)
    ops = kernels.fir_operations(C, L, ntaps)
    ms, by = kernels.bound(moved, ops)
    assert round(moved / 1e6, 1) == 33.2
    assert round(ops / 1e9, 3) == 0.669
    assert round(ms, 5) == 0.00998 and by == "operations"


def test_k5_rows():
    """K5: YSF FICH + DCH in one launch, 2 x (512 x 100) uint8: 0.52 MB,
    23.4 MOP, 0.00035 ms; the NXDN round 512 x 36 + 1,024 x 96: 0.94 MB,
    26.7 MOP, 0.00040 ms; the 4-state D-Star header 256 x 330: 423,424 B,
    5.15 M ops, 0.00013 ms by bytes."""
    def row(segments, dtype, states=16):
        ins = [_t((b, t), dtype) for b, t in segments]
        outs = [x for b, t in segments
                for x in (_t((b, t), torch.int32), _t((b,), torch.int32))]
        moved = kernels.nbytes(ins + outs)
        ops = sum(kernels.viterbi_operations(b, t, states)
                  for b, t in segments)
        return moved, ops, *kernels.bound(moved, ops)

    moved, ops, ms, by = row([(512, 100), (512, 100)], torch.uint8)
    assert (round(moved / 1e6, 2), round(ops / 1e6, 1)) == (0.52, 23.4)
    assert round(ms, 5) == 0.00035 and by == "operations"
    moved, ops, ms, by = row([(512, 36), (1024, 96)], torch.int32)
    assert (round(moved / 1e6, 2), round(ops / 1e6, 1)) == (0.94, 26.7)
    assert round(ms, 5) == 0.00040 and by == "operations"
    moved, ops, ms, by = row([(256, 330)], torch.uint8, 4)
    assert moved == 423424 and round(ops / 1e6, 2) == 5.15
    assert round(ms, 5) == 0.00013 and by == "bytes"


def test_chip_smoke_takes_the_arithmetic_from_the_program():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    moved = {"bound", "demod_operations", "viterbi_operations",
             "conv1d_library", "kernel_device_ms", "time_ms", "nbytes"}
    assert not defined & moved
    imported = {a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                and n.module == "digiham_tpu_torch.bench.kernels"
                for a in n.names}
    # ``bound`` through ``kernels.ab``, phase 5's one A/B of every kernel
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "kernels"}
    assert {"ab", "measure", "workloads"} <= used
    assert moved - {"bound"} <= imported
    for name in moved:
        assert callable(getattr(kernels, name))


def test_plain_versions_swap_each_wrapper_and_restore_it():
    from digiham_tpu_torch.bench import common
    from digiham_tpu_torch.ops import demod_front, fir

    targets = common.kernel_wrappers()
    assert [t[0] for t in targets] == ["K1", "K2", "K3", "K4", "K5", "K5"]
    before = [getattr(m, n) for _, m, n, _ in targets]
    with common.plain_versions():
        inside = [getattr(m, n) for _, m, n, _ in targets]
        assert inside[2] is demod_front.demod_plain
        assert inside[3] is fir.rrc_filter_block_plain
    assert [getattr(m, n) for _, m, n, _ in targets] == before
    assert all(i is not b for i, b in zip(inside, before))


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]])
def test_the_program_needs_a_card(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = kernels.main(argv)
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 1 and line["value"] is None and "error" in line
    assert line["metric"] == kernels.METRIC


def test_k3_ablations_find_their_text():
    source = (build.CSRC / demod_front.SOURCE).read_text()
    texts = variants._k3_sources(source)
    assert list(texts) == list(variants.K3_VARIANTS)
    committed, *ablated = texts.values()
    assert committed == source
    assert len(ablated) == 2 and len({committed, *ablated}) == 3
    assert "scan100<false>(bmn" not in ablated[1]
    assert "const int new_off = 0;" in ablated[0]


def test_build_lists_every_source(monkeypatch):
    cu = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert build.sources() == cu
    assert {"demod_front.cu", "fir.cu", "viterbi.cu", "recurrence.cu",
            "recurrence_serial.cu"} <= set(cu)
    assert native.SOURCE.is_file() and native.HEADER.is_file()
    # what build_all hands the compilers, without compiling
    monkeypatch.setattr(build, "build", lambda name: (
        build.library_path(name), 0.0, ""))
    monkeypatch.setattr(build, "build_host", lambda src, headers: (
        build.host_library_path(src, headers), 0.0, ""))
    done = build.build_all()
    assert [d[0] for d in done] == [f"csrc/{n}" for n in cu] + [
        "native/src/digiham_native.cpp"]
    assert done[-1][1] == build.host_library_path(native.SOURCE,
                                                  [native.HEADER])


def test_build_without_nvcc_names_it(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "digiham_tpu_torch.ops.build"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1
    assert "nvcc" in r.stderr and not r.stdout
