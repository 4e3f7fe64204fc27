"""What a run of one cell needs, found by the names in BENCHMARK.json:
the cell, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the protocol's TX and reference modules
(``synth/<protocol>.py``, ``reference/<protocol>/``) and the readers of
the cell's per-layer metrics (``metrics/<metric>.py``). Adding a
configuration, a mix or a metric is adding files and entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the benchmark's folder
BENCHMARK_JSON = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def protocol(self) -> str:
        return self.config["protocol"]

    @property
    def block_samples(self) -> int:
        """Samples a bank step consumes, at most: n_centuries x (100 sps
        + 1)."""
        return self.config["n_centuries"] * (100 * self.config["sps"] + 1)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = BENCHMARK_JSON) -> Cell:
    """The cell ``name`` of ``benchmark``; raises KeyError when there is
    none."""
    spec = json.loads(Path(benchmark).read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return Cell(
        name=name,
        config=json.loads((ROOT.parent / config["file"]).read_text()),
        mix=json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                       .read_text()),
        chips=cell["chips"],
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``: the metric's value from
    a traced run's context, or None when it finds nothing to read."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
