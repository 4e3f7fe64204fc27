"""Run one cell of the benchmark of ``digiham_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/``) and a traffic mix (``benchmark/traffic/``). Set-up
builds the program's libraries (cached inside the checkout), makes the
traffic from the seed, builds the program's ``TrackedChannelBank`` and
pushes it a few blocks; then the window pushes the traffic for
``--seconds``, closed or open loop as the mix says. After it the bank is
drained and freed, and the plain reference decides ``correct`` on the
same samples.

The last line of standard output is the result: ``correct``,
``attempted`` and ``failed`` (voice frames due on the checked channels),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each compared number with its limit, which also end standard
error. Without a card, with fewer cards than the cell asks for, without
the program beside the benchmark, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the caches a run may write, inside the checkout at fixed paths (the
# program's own libraries go to build/digiham_tpu_torch/ of the checkout)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
          "TRITON_CACHE_DIR": "build/benchmark/triton"}
# one thread a process: the bank is one Python thread, and torch's CPU
# thread pool would otherwise spin on every core beside it
THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
FORBIDDEN = ("jax", "jaxlib", "flax", "digiham_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``digiham_tpu_torch`` is not
    ``digiham_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(line: dict) -> None:
    print(json.dumps(line), flush=True)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, n_workers: int | None = None):
    """One run of ``cell`` on ``device``: (the result line, the lines said
    before it). ``t_process`` is the host clock at the process's start."""
    import numpy as np
    import torch

    from benchmark.harness import check, devtrace, layers, spec, traffic
    from benchmark.harness import window as win

    said, split = [], {}
    mark = [T0 if t_process is None else t_process]

    def lap(name):
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    lap("start_s")
    import digiham_tpu_torch.runtime.tracked_bank  # noqa: F401
    lap("program_import_s")
    on_card = device.type == "cuda"
    if on_card:
        from digiham_tpu_torch.ops import build
        build.build_all()
    lap("build_cache_s")
    cfg = cell.config
    stream = traffic.make(cell, seed, device)
    lap("traffic_s")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    outputs = win.Outputs(cfg["channels"])
    bank = win.build_bank(cell, device, outputs)
    probe = win.Probe(bank, device, spans=trace)
    channels = check.checked_channels(cell, seed)
    symbols = win.Symbols(bank, channels)
    lap("bank_s")
    n = win.warm_up(bank, stream, cell)
    win.synchronize(device)
    if trace and on_card:
        devtrace.start_profiler(device)
    lap("warm_up_s")
    setup_s = time.perf_counter() - (T0 if t_process is None else t_process)
    said.append({"setup": {**split, "setup_s": setup_s}})

    slicer = (devtrace.Slicer(device, probe, seconds)
              if trace and on_card else None)
    host = win.HostMeter()
    w = win.run(cell, bank, stream, probe, seconds, n, slicer)
    host = host.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n_total = win.drain(bank, stream, cell, w.n_end)
    push_ms = np.array([b - a for a, b, _ in w.pushes]) * 1e3
    window_line = {"window_s": w.seconds, "steps": w.steps,
                   "pushes": len(w.pushes), "samples_per_channel":
                   w.n_end - w.n_start,
                   "push_ms": [float(np.percentile(push_ms, q))
                               for q in (10, 50, 90, 100)],
                   **win.lateness_summary(w), **host}
    said.append({"window": window_line})
    ctx = layers.context(cell, w, probe, slicer) if trace else None
    del bank, probe
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = check.reference(cell, stream, channels, n_total, device,
                          n_workers=check.workers() if n_workers is None
                          else n_workers)
    chk = check.compare(outputs, symbols, ref, w.n_end)
    said.append({"reference": {"channels": len(channels),
                               "samples_per_channel": n_total,
                               "symbols_due": ref.symbols_due,
                               **ref.seconds,
                               "seconds": time.perf_counter() - t,
                               "probe_ms": win.HostMeter.probe_ms()}})

    values = {"setup_s": setup_s}
    if w.schedule_t0 is None:
        values["throughput_msps"] = win.throughput_msps(cell, w)
    else:
        lat = check.latency_ms(chk, w, cfg["sample_rate"])
        late = check.due_in_window(ref, w) - lat.size
        lat = np.concatenate([lat, np.full(late, np.inf)])
        if lat.size:
            # a sample, not an interpolation: with a failed frame among
            # the last, the tail is that frame's, infinitely late
            p95 = float(np.percentile(lat, 95, method="inverted_cdf"))
            values["frame_latency_p95_ms"] = p95 if np.isfinite(p95) else None
            said.append({"latency": {
                "frames": int(lat.size), "p50_ms": float(np.median(lat)),
                "p95_ms": values["frame_latency_p95_ms"],
                "max_ms": float(lat[np.isfinite(lat)].max(initial=0.0)),
                "failed": int(late)}})
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"{cell.name}: no {m['name']} measured")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": chk.correct, "attempted": chk.attempted,
              "failed": chk.failed, "metrics": metrics, "device": dev}
    if trace and ctx.session is not None:
        s = ctx.session
        dev["busy_s"] = devtrace.union_us(
            (a, b) for _, a, b in s.device) / 1e6
        dev["window_s"] = ctx.slice_wall_s
        result["breakdown"] = devtrace.breakdown(s)
        said.append({"trace": {"complete": s.complete, "lost": s.lost_by,
                               "slices": len(slicer.slices)}})
    result["checks"] = chk.lines()
    return result, said


def provenance() -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    torch and CUDA versions."""
    import subprocess

    import torch

    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        out["card"] = f"nvidia-smi failed: {e}"
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    for key in THREADS:
        os.environ[key] = "1"
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    try:
        import digiham_tpu_torch  # noqa: F401
        from benchmark.harness import spec
        cell = spec.load_cell(args.workload)
    except (ImportError, OSError, KeyError, ValueError) as e:
        print(f"cannot set up {args.workload}: {e!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, said = measure(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"), T0)
    _say({"provenance": provenance()})
    for line in said:
        _say(line)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    _say(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
