"""What a run of one cell needs, found by the names in BENCHMARK.json:
the cell, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the protocol's TX and reference modules
(``synth/<protocol>.py``, ``reference/<protocol>/``) and the readers of
the cell's per-layer metrics (``metrics/<metric>.py``). Adding a
configuration, a mix or a metric is adding files and entries.

The keys of a configuration that the harness reads:

- ``protocol``: names ``synth/<protocol>.py`` (``call(rng, seconds,
  variant)`` -> symbols, ``SYMBOL_RATE``, and ``LEVELS``, each symbol's
  level, where it is not the 4FSK table of :mod:`.traffic`) and
  ``reference/<protocol>/`` (``make_decoder()``, and the slicer of the
  reference's front: ``DEMOD``, ``gfsk`` where it is not set, or
  ``fsk``, and ``INVERT``, false where it is not set);
- ``channels``, ``sample_rate``, ``sps``, ``n_centuries``,
  ``slot_filter``;
- ``pipeline`` and ``adapter``: class names in ``digiham_tpu_torch.
  pipeline`` and ``digiham_tpu_torch.runtime.tracked_bank``, built with
  the pipeline's defaults besides ``sps`` and ``n_centuries``;
- ``rrc``, the reference's filter as the pipeline runs it (a name of
  ``reference/dsp.py``'s ``FILTERS``: ``wide``, ``narrow``, ``none``),
  and ``rrc_taps``, its length, which the K2 roofline's reader counts.

A new protocol brings its TX module, its reference subpackage and, for
a kernel no reader counts yet, its roofline reader under ``metrics/``."""
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


def slicer(protocol: str) -> tuple[str, bool]:
    """The reference front's ``(mode, invert)`` for ``protocol``: its
    reference subpackage's ``DEMOD`` and ``INVERT``, as the port's
    pipeline of that protocol slices."""
    module = importlib.import_module(f"benchmark.reference.{protocol}")
    return getattr(module, "DEMOD", "gfsk"), getattr(module, "INVERT", False)


def check_front(cell: Cell) -> None:
    """Raises ValueError, naming the key, where the cell's front is one
    the reference does not have or its K2 reader would miscount: an
    unknown ``rrc``, an ``rrc_taps`` that is not the design's length, a
    ``k2_roofline`` without a filter, or a slicer that is not one of
    ``reference/dsp.py``'s."""
    from benchmark.reference import dsp

    cfg = cell.config
    rrc = cfg.get("rrc")
    if rrc not in dsp.FILTERS:
        raise ValueError(f"{cell.name}: rrc {rrc!r} is none of "
                         f"{sorted(dsp.FILTERS)}")
    if dsp.FILTERS[rrc] is not None:
        ntaps = len(dsp.FILTERS[rrc][0])
        if cfg.get("rrc_taps") != ntaps:
            raise ValueError(f"{cell.name}: rrc_taps {cfg.get('rrc_taps')!r}"
                             f" is not the {ntaps} taps of rrc {rrc!r}")
    elif any(m["name"] == "k2_roofline" for m in cell.per_layer):
        raise ValueError(f"{cell.name}: k2_roofline counts a filter, and "
                         f"rrc is 'none'")
    mode, invert = slicer(cell.protocol)
    where = f"{cell.name}: reference/{cell.protocol}'s"
    if mode not in dsp.MODES:
        raise ValueError(f"{where} DEMOD {mode!r} is none of "
                         f"{list(dsp.MODES)}")
    if not isinstance(invert, bool):
        raise ValueError(f"{where} INVERT {invert!r} is not a bool")


def load_cell(name: str, benchmark: Path = BENCHMARK_JSON) -> Cell:
    """The cell ``name`` of ``benchmark``; raises KeyError when there is
    none, ValueError when its front is not the reference's
    (:func:`check_front`)."""
    spec = json.loads(Path(benchmark).read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cell = Cell(
        name=name,
        config=json.loads((ROOT.parent / config["file"]).read_text()),
        mix=json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                       .read_text()),
        chips=cell["chips"],
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])
    check_front(cell)
    return cell


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``: the metric's value from
    a traced run's context, or None when it finds nothing to read."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
