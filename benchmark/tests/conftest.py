"""Shared helpers of the benchmark's CPU tests: the repository's root on
the path, and small cells of the benchmark's own configurations and
mixes, run through the harness on the CPU (the program's plain
versions)."""
import json
import sys
import types
from pathlib import Path

import numpy as np
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


# the receive fronts the port's pipelines run: (rrc, sps, demod, invert)
FRONTS = {"dmr_ysf": ("wide", 10, "gfsk", False),
          "nxdn": ("narrow", 20, "gfsk", False),
          "dstar": ("none", 10, "fsk", False),
          "pocsag": ("none", 40, "fsk", True)}


def two_level_tx(levels, symbol_rate: int):
    """A TX module of random 2FSK bits, each bit at ``levels[bit]``."""
    def call(rng, seconds, variant=0):
        n = int(round(seconds * symbol_rate))
        return rng.integers(0, 2, n).astype(np.uint8)

    return types.SimpleNamespace(SYMBOL_RATE=symbol_rate, LEVELS=levels,
                                 call=call)


def front_cell(front: str, monkeypatch, channels: int = 4):
    """``small_cell("dmr_site.busy")`` with the receive front ``front`` of
    :data:`FRONTS`: its filter, ``rrc_taps`` and sps in the configuration
    (the K2 reader left out where there is no filter), its slicer set on
    the stand-in protocol's reference subpackage (DMR's, whose machines
    decode), and a TX at the front's symbol rate, 48 kS/s over sps: the
    DMR bursts (as 4FSK at 2400 Bd for NXDN's sps 20), or random bits at
    the 2FSK levels, inverted where the front is."""
    from benchmark.harness import traffic
    from benchmark.reference import dmr as reference
    from benchmark.reference import dsp
    from benchmark.synth import dmr

    rrc, sps, demod, invert = FRONTS[front]
    cell = small_cell("dmr_site.busy")
    cell.config = dict(cell.config, channels=channels, rrc=rrc, sps=sps)
    if dsp.FILTERS[rrc] is None:
        del cell.config["rrc_taps"]
        cell.per_layer = [m for m in cell.per_layer
                          if m["name"] != "k2_roofline"]
    else:
        cell.config["rrc_taps"] = len(dsp.FILTERS[rrc][0])
    monkeypatch.setattr(reference, "DEMOD", demod, raising=False)
    monkeypatch.setattr(reference, "INVERT", invert, raising=False)
    rate = cell.config["sample_rate"] // sps
    if demod == "fsk":
        tx = two_level_tx([1.0, -1.0] if invert else [-1.0, 1.0], rate)
    else:
        tx = types.SimpleNamespace(SYMBOL_RATE=rate, call=lambda rng, s, v=0:
                                   dmr.call(rng, s * rate / dmr.SYMBOL_RATE,
                                            v))
    monkeypatch.setattr(traffic, "synth_module", lambda protocol: tx)
    return cell


@pytest.fixture
def benchmark_spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
