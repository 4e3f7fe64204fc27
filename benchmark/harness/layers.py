"""What a traced run hands the per-layer readers (``metrics/<name>.py``):
the window's split by layer, from the harness's spans, and the device
trace's best slice."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Context:
    """``steps``, ``push_s``, ``step_s`` and ``decode_s`` sum the window's
    pushes outside the profiler's slices: the bank steps they made, the
    pushes' wall time, the wrapped ``step_symbols`` and ``decode_fields``
    time. ``slice`` is the best profiler slice
    (:meth:`devtrace.Slicer.best`) or None; ``slice_rounds`` lists the
    frames of each decode round inside it."""

    cell: object
    steps: int
    push_s: float
    step_s: float
    decode_s: float
    slice: tuple | None
    slice_rounds: list

    @property
    def session(self):
        return None if self.slice is None else self.slice[0]

    @property
    def slice_wall_s(self) -> float:
        return self.slice[1]


def _steps(window, pushes) -> set:
    """The bank steps, numbered as the probe counts them, that the given
    pushes made."""
    ends = [0] + [p[2] for p in window.pushes]
    return {window.steps_before + s for i in pushes
            for s in range(ends[i] + 1, ends[i + 1] + 1)}


def context(cell, window, probe, slicer) -> Context:
    profiled = set(window.profiled)
    kept = [i for i in range(len(window.pushes)) if i not in profiled]
    kept_steps = _steps(window, kept)
    best = None if slicer is None else slicer.best()
    slice_steps = (set() if best is None
                   else _steps(window, range(best[2], best[3])))
    return Context(
        cell=cell,
        steps=len(kept_steps),
        push_s=sum(window.pushes[i][1] - window.pushes[i][0] for i in kept),
        step_s=sum(s for k, s in probe.step_s if k in kept_steps),
        decode_s=sum(s for k, s, _ in probe.decode_s if k in kept_steps),
        slice=best,
        slice_rounds=[n for k, _, n in probe.decode_s if k in slice_steps])
