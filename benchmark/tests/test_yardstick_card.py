"""On the card: one short run of each cell through ``benchmark/run.py``,
as the check runs it, comes out correct with its metrics. Skips without
a card (marker ``cuda``)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["dmr_site.busy", "ysf_site.busy", "dmr_site.live", "ysf_site.live"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(name, trace, benchmark_spec):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if not trace:
        want = {m["name"] for m in benchmark_spec["end_to_end"]
                if name in m.get("workloads", [name])}
        assert set(result["metrics"]) == want
    else:
        assert result["device"]["busy_s"] > 0
