"""Shared helpers of the benchmark's CPU tests: the repository's root on
the path, and small cells of the benchmark's own configurations and
mixes, run through the harness on the CPU (the program's plain
versions)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, **mix_over):
    """Cell ``name`` of BENCHMARK.json at a size the CPU runs in seconds:
    4 channels, 4-century blocks, loops of two 1-3 s calls, every channel
    checked; the metrics as BENCHMARK.json lists them for the cell."""
    from benchmark.harness import spec

    cell = spec.load_cell(name)
    cell.config = dict(cell.config, channels=4, n_centuries=4)
    mix = dict(cell.mix, calls_per_loop=2, call_seconds=[1.0, 3.0],
               checked_channels=4, warm_up_blocks=2)
    if mix["gap_seconds"][0] > 5:
        mix["gap_seconds"] = [2.0, 4.0]
    mix.update(mix_over)
    cell.mix = mix
    return cell


def run_small(cell, seed=20260917, seconds=2.0, trace=False):
    """One run of the harness on the CPU: (result line, earlier lines)."""
    import time

    import torch

    from benchmark import run

    return run.measure(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), n_workers=1)


@pytest.fixture
def benchmark_spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
