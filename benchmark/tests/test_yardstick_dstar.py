"""The D-Star site (``dstar_site.busy``): BENCHMARK.json lists the cell
with K3's share in place of K2's and K5's; the K3 reader counts a step's
bytes and operations as its docstring states, and finds nothing without a
profiler session; the site's front is K3's; on the card the cell runs
through ``benchmark/run.py`` (marker ``cuda``). The comparisons of the
reference with the program on the CPU are tier-1 tests
(``tests/test_torch_dstar_site.py``)."""
import json
import subprocess
import sys
import types

import pytest

from benchmark.harness import layers, roofline, spec
from conftest import ROOT

CELL = "dstar_site.busy"


def site_cell():
    return spec.load_cell(CELL)


def test_the_cell_is_listed_as_a_busy_cell_with_k3s_share():
    """One chip, the ``busy`` mix, the busy cells' end-to-end and host
    metrics, and of the kernels' shares K3's alone, which lists only this
    cell."""
    cell = site_cell()
    busy = spec.load_cell("nxdn_site.busy")
    assert cell.chips == 1 and cell.mix == busy.mix
    assert cell.end_to_end == busy.end_to_end
    names = [m["name"] for m in cell.per_layer]
    assert names == [m["name"] for m in busy.per_layer
                     if not m["name"].startswith(("k2_", "k5_"))] + [
                         "k3_roofline"]
    k3 = cell.per_layer[-1]
    assert (k3["unit"], k3["better"], k3["source"], k3["layer"],
            k3["moves"], k3["workloads"]) == (
                "%", "higher", "device_trace", "kernels", "throughput_msps",
                [CELL])


def _context(session, cell):
    return layers.Context(cell=cell, steps=1, push_s=1.0, step_s=0.0,
                          decode_s=0.0,
                          slice=None if session is None
                          else (session, 1.0, 0, 1),
                          slice_rounds=[])


def test_k3_roofline_counts_a_steps_bytes_and_operations():
    """256 channels, 4 centuries at sps 10: 4,006 float32 samples in a
    channel, the 408-byte carry in and out, 400 bit bytes out; the
    century sums and the slicer's operations. The bytes bound it."""
    cell = site_cell()
    reader = spec.metric_reader("k3_roofline")
    C, nc, sps = 256, 4, 10
    L = nc * (100 * sps + 1) + 2
    assert L == 4006
    moved = C * (4 * L + 2 * (4 + 4 + 400) + nc * 100)
    ops = C * nc * 100 * (sps * 6 + 10)
    least = max(moved / roofline.HBM_BYTES_PER_S,
                ops / roofline.FP32_OPS_PER_S)
    assert least == moved / 3.35e12
    session = types.SimpleNamespace(device=[
        ("void demod_kernel<0, 0>(...)", 0.0, 10.0),
        ("Memcpy HtoD (Pinned -> Device)", 10.0, 30.0),
        ("void demod_kernel<0, 0>(...)", 30.0, 40.0)])  # us
    got = reader(_context(session, cell))
    assert got == pytest.approx(100.0 * 2 * least / 20e-6)
    assert 0 < got <= 100


def test_k3_roofline_is_none_without_a_session_or_a_launch():
    cell = site_cell()
    reader = spec.metric_reader("k3_roofline")
    assert reader(_context(None, cell)) is None
    session = types.SimpleNamespace(device=[
        ("Memcpy HtoD (Pinned -> Device)", 0.0, 5.0)])
    assert reader(_context(session, cell)) is None


def test_the_sites_front_is_k3s():
    """No filter and the 2FSK slicer: K2's reader, which counts a filter,
    is refused on the site, and K3's is taken."""
    cell = site_cell()
    assert cell.config["rrc"] == "none" and "rrc_taps" not in cell.config
    assert spec.slicer("dstar") == ("fsk", False)
    k2 = {"name": "k2_roofline"}
    with pytest.raises(ValueError, match="k2_roofline"):
        spec.check_front(spec.Cell(cell.name, cell.config, cell.mix, 1, [],
                                   [k2]))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147484024", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = site_cell()
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    else:
        assert result["device"]["busy_s"] > 0
        assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
        assert 0 < result["metrics"]["k3_roofline"]["value"] <= 100
