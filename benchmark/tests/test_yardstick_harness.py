"""The harness's arithmetic and its contract, on the CPU: latency from due
times, the window's throughput from drained steps only, the rooflines'
bytes and operations from shapes, the last line's schema, the card-less
failure, cells, mixes and metrics found by name, and a cell's front and
TX levels for every protocol the port runs."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import conftest
from benchmark.harness import check, devtrace, roofline, spec, window
from conftest import ROOT, run_small, small_cell


def _window(**kw):
    base = dict(t_start=100.0, t_end=130.0, steps_before=3, n_start=48000,
                n_end=48000 * 31, steps=90, pushes=[],
                schedule_t0=100.0)
    base.update(kw)
    return window.Window(**base)


def test_latency_from_due_times():
    w = _window()
    # a frame ending at sample n_start + 4,800 is due 0.1 s into the
    # window; handed over at 100.35 s it is 250 ms late
    chk = check.Check({}, 3, 0, [(48000 + 4800, 100.35),
                                  (48000 * 31, 130.5),
                                  (48000, 99.0)])  # due before the window
    lat = check.latency_ms(chk, w, 48000)
    assert np.allclose(lat, [250.0, 500.0])


def test_failed_frames_miss_every_limit():
    got = [(1.0, b"a"), (2.0, b"X")]
    want = [(10, b"a"), (20, b"b"), (30, b"c"), (99, b"d")]
    wrong, missing, due, failed, passed = check._side(got, want, 30)
    assert (wrong, missing, due, failed, passed) == (1, 1, 3, 2, [0])
    # a frame beyond all the reference's is wrong
    assert check._side(want[:1] and [(0, b"a"), (0, b"z")], [(1, b"a")],
                       5)[0] == 1


def test_throughput_counts_drained_steps_only():
    cell = small_cell("dmr_site.busy")
    cell.config = dict(cell.config, channels=256, n_centuries=16)
    w = _window(steps=300, t_start=0.0, t_end=30.0)
    # a step takes 16 centuries x 100 symbols x 10 samples of 256 channels
    assert window.throughput_msps(cell, w) == pytest.approx(
        300 * 256 * 16000 / 30.0 / 1e6)
    # pushed but not yet stepped samples do not count
    w2 = _window(steps=300, t_start=0.0, t_end=30.0, n_end=10**9)
    assert window.throughput_msps(cell, w2) == window.throughput_msps(cell, w)


def test_roofline_from_shapes():
    C, L, ntaps, nc, sps = 256, 16018, 81, 16, 10
    ops = roofline.demod_operations(C, L, ntaps, nc, sps)
    assert ops == C * L * 162 + C * 1600 * 10 * 6 + C * 1600 * 10
    by = roofline.demod_bytes(C, L, ntaps, nc)
    assert by == C * (4 * L + 320 + 2 * 408 + 1600 + 320) + 4 * 81
    assert roofline.bound_s(by, ops) == max(by / 3.35e12, ops / 67e12)
    assert roofline.viterbi_operations(10, 100) == 10 * 100 * (16 * 14 + 5)
    assert roofline.viterbi_bytes(10, 100) == 10 * 204


def test_busy_time_is_a_union():
    assert devtrace.union_us([(0, 10), (5, 15), (20, 30), (29, 31)]) == 26
    assert devtrace.union_us([]) == 0


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    pytest.importorskip("digiham_tpu_torch")
    cell = small_cell("dmr_site.busy")
    result, said = run_small(cell, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(check.LIMITS)
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(result)
    assert "setup" in said[0] and "window" in said[1]


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dmr_site.busy",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    # pretend a card: the check for the program comes after the card's
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            "lambda: True; sys.argv = ['run.py', '--workload', "
            "'dmr_site.busy', '--seed', '1', '--seconds', '1']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "digiham_tpu_torch" in proc.stderr


def test_cells_mixes_and_metrics_found_by_name(tmp_path, benchmark_spec):
    """A configuration, a mix and a metric added as files and entries
    alone, in a copy: the harness finds and runs them."""
    pytest.importorskip("digiham_tpu_torch")
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs" / "dmr_site.json").read_text())
    cfg.update(name="stub_site", channels=4, n_centuries=4)
    (bench / "configs" / "stub_site.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "busy.json").read_text())
    mix.update(name="stub", calls_per_loop=1, call_seconds=[1.0, 2.0],
               checked_channels=4, warm_up_blocks=2)
    (bench / "traffic" / "stub.json").write_text(json.dumps(mix))
    (bench / "metrics" / "stub_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.steps) or None\n")
    s = dict(benchmark_spec)
    s["configs"] = s["configs"] + [dict(
        s["configs"][0], name="stub_site",
        file="benchmark/configs/stub_site.json")]
    s["workloads"] = s["workloads"] + [dict(
        s["workloads"][0], name="stub_site.stub", config="stub_site",
        traffic="stub")]
    s["end_to_end"] = [dict(m, workloads=m["workloads"] + ["stub_site.stub"])
                       if m["name"] == "throughput_msps" else m
                       for m in s["end_to_end"]]
    s["per_layer"] = s["per_layer"] + [dict(
        s["per_layer"][0], name="stub_steps", unit="steps",
        workloads=["stub_site.stub"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    code = (
        "import json, sys, time, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from benchmark.harness import spec\n"
        "from benchmark import run\n"
        "assert spec.ROOT.parent.as_posix() == sys.path[0]\n"
        "cell = spec.load_cell('stub_site.stub')\n"
        "for trace in (False, True):\n"
        "    r, _ = run.measure(cell, 5, 1.5, trace, torch.device('cpu'),\n"
        "                       time.perf_counter(), n_workers=1)\n"
        "    print(json.dumps({'correct': r['correct'],\n"
        "                      'metrics': sorted(r['metrics'])}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = [json.loads(x) for x in proc.stdout.splitlines()[-2:]]
    assert plain == {"correct": True,
                     "metrics": ["setup_s", "throughput_msps"]}
    assert traced["correct"] and "stub_steps" in traced["metrics"]


def test_benchmark_json_names_what_exists(benchmark_spec):
    for c in benchmark_spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in benchmark_spec["workloads"]:
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
    for m in benchmark_spec["per_layer"]:
        assert spec.metric_reader(m["name"])


@pytest.mark.parametrize("front", ["nxdn", "dstar"])
def test_the_banks_symbols_equal_the_reference_on_every_front(front,
                                                              monkeypatch):
    """A test-only configuration for each front no cell runs yet whose
    pipeline the harness builds with its defaults (NXDN; D-Star), its
    pipeline and adapter the port's for that protocol: through
    ``check.reference`` and ``window.Symbols`` every step's symbols equal
    the reference's. Symbols only: no reference machines of these
    protocols exist yet, so the DMR ones decode (and the frames
    differ)."""
    pytest.importorskip("digiham_tpu_torch")
    cell = conftest.front_cell(front, monkeypatch)
    cell.config.update({
        "nxdn": dict(pipeline="NxdnPipeline", adapter="NxdnAdapter"),
        "dstar": dict(pipeline="FskPipeline", adapter="DstarAdapter")}[front])
    spec.check_front(cell)
    result, said = run_small(cell, seconds=1.5)
    reference = next(x["reference"] for x in said if "reference" in x)
    assert reference["symbols_due"] >= 2000
    assert result["checks"]["symbols_wrong"]["value"] == 0


def test_a_tx_modules_own_levels(monkeypatch):
    """A two-level TX module's calls are at its two levels only, the
    replaced symbols too (half of them here), and gaps are silent."""
    from benchmark.harness import traffic

    tx = conftest.two_level_tx([-1.0, 1.0], 4800)
    monkeypatch.setattr(traffic, "synth_module", lambda protocol: tx)
    cell = small_cell("dmr_site.busy", dibit_error_rate=0.5, noise_sigma=0.0)
    loop = traffic.make(cell, 2**31 + 9, "cpu").loop
    assert set(np.unique(loop).tolist()) == {-1000.0, 0.0, 1000.0}


# a configuration's edit, or the protocol's slicer, and what the error names
BAD_FRONTS = {
    "rrc": ({"rrc": "medium"}, None, "rrc 'medium'"),
    "rrc_taps": ({"rrc": "narrow"}, None, "rrc_taps 81"),
    "k2_roofline": ({"rrc": "none"}, None, "k2_roofline"),
    "DEMOD": ({}, ("DEMOD", "psk"), "DEMOD 'psk'"),
    "INVERT": ({}, ("INVERT", "yes"), "INVERT 'yes'"),
}


@pytest.mark.parametrize("key", list(BAD_FRONTS))
def test_an_unknown_front_fails_at_load_cell(key, tmp_path, monkeypatch,
                                             benchmark_spec):
    """A front the reference does not have, or whose K2 reader would
    count another filter or none, fails at ``load_cell``, naming the
    key; a bad slicer names its constant in ``reference/dmr/``."""
    from benchmark.reference import dmr as reference

    edit, slicer, says = BAD_FRONTS[key]
    cfg = json.loads((ROOT / "benchmark/configs/dmr_site.json").read_text())
    cfg.update(edit)
    if slicer is not None:
        monkeypatch.setattr(reference, *slicer, raising=False)
    (tmp_path / "bad_site.json").write_text(json.dumps(cfg))
    s = dict(benchmark_spec)
    s["configs"] = [dict(s["configs"][0], name="bad_site",
                         file=str(tmp_path / "bad_site.json"))]
    s["workloads"] = [dict(s["workloads"][0], name="bad_site.busy",
                           config="bad_site")]
    s["per_layer"] = [dict(m, workloads=["bad_site.busy"])
                      for m in s["per_layer"] if m["name"] == "k2_roofline"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    with pytest.raises(ValueError, match=re.escape(says)):
        spec.load_cell("bad_site.busy", tmp_path / "BENCHMARK.json")
    monkeypatch.undo()
    assert spec.load_cell("dmr_site.busy").name == "dmr_site.busy"
