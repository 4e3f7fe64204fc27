"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, its arithmetic one precision below
the configuration's (bfloat16 for float32), judged against the reference
by the same comparison on the same samples, at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 \
        [--samples N]

For each seed: the cell's traffic, the reference in float32 and in
bfloat16 over the checked channels' first ``--samples`` samples (by
default what a run of ``run_seconds`` pushes: the warm-up, the window at
the cell's rate and the drain), and the compared numbers with their
limits. A control that comes out correct on any seed means the comparison
cannot see the precision a later change might drop to. Not part of a
benchmark run; needs a card (the CPU tests call :func:`control` at a small
size).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class _Outputs:
    """A reference's symbols, frames and events in the shape of the
    program's: (time, bytes) for every channel, symbols by checked
    channel as far as a bank's steps would hand them over."""

    def __init__(self, ref, channels: int):
        self.frames = [[] for _ in range(channels)]
        self.events = [[] for _ in range(channels)]
        for i, c in enumerate(ref.channels):
            self.frames[c] = [(0.0, b) for _, b in ref.frames[i]]
            self.events[c] = [(0.0, b) for _, b in ref.events[i]]
        self.dibits = ref.dibits
        self.due = ref.symbols_due

    def channel(self, i: int):
        return self.dibits[i][:self.due]


def control(cell, seed: int, n_samples: int, device, n_workers=None):
    """(numbers, frames compared, seconds) of the bfloat16 reference
    against the float32 one on ``seed``'s traffic."""
    import torch

    from benchmark.harness import check, traffic

    t = time.perf_counter()
    stream = traffic.make(cell, seed, device)
    channels = check.checked_channels(cell, seed)
    workers = check.workers() if n_workers is None else n_workers
    want = check.reference(cell, stream, channels, n_samples, device,
                           n_workers=workers)
    got = check.reference(cell, stream, channels, n_samples, device,
                          dtype=torch.bfloat16, n_workers=workers)
    outputs = _Outputs(got, cell.config["channels"])
    chk = check.compare(outputs, outputs, want, n_samples)
    return chk.lines(), chk.attempted, time.perf_counter() - t


def default_samples(cell, run_seconds: float, rate_msps: float) -> int:
    """Samples a channel gets in a run: warm-up, the window at ``rate``
    (channel-samples a second over all channels; real time for an open
    loop) and the drain."""
    cfg, mix = cell.config, cell.mix
    if mix["push"] == "open":
        per_s = cfg["sample_rate"]
    else:
        per_s = rate_msps * 1e6 / cfg["channels"]
    blocks = mix["warm_up_blocks"] + mix["drain_blocks"]
    return int(blocks * cell.block_samples + run_seconds * per_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--samples", type=int, default=0)
    p.add_argument("--rate-msps", type=float, default=40.0,
                   help="a closed loop's throughput, for --samples 0")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import spec

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    run_seconds = json.loads(spec.BENCHMARK_JSON.read_text())["run_seconds"]
    n = args.samples or default_samples(cell, run_seconds, args.rate_msps)
    failed_all = True
    for seed in args.seeds:
        numbers, frames, seconds = control(cell, seed, n, device)
        bad = any(v["value"] > v["limit"] for v in numbers.values())
        failed_all &= bad
        print(json.dumps({"control": cell.name, "seed": seed,
                          "samples_per_channel": n, "frames": frames,
                          "seconds": seconds, "correct": not bad,
                          "checks": numbers}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
