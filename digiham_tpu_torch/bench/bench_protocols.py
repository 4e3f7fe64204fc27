"""Per-protocol pipeline throughput on one card (the port of
tools/bench_protocols.py).

    python3 -m digiham_tpu_torch.bench.bench_protocols [--channels 256]
        [--steps 64] [--reps 8] [--centuries N]
        [--seed 0] [--profile] [--device cpu]

The five bank pipelines at the JAX tool's long blocks (:128-141): DMR 32
centuries, YSF 40, NXDN 16 at sps 20, D-Star 32, POCSAG 8 (``--centuries``
sets one block for all). DMR, YSF and NXDN run kernel K2 (YSF and NXDN K5
too), D-Star and POCSAG ``FskPipeline``, kernel K3 alone. Each protocol's
rep draws one FM-audio base stream (normal x 100) on the device, runs
``steps`` dependent ``step`` calls on its windows and fetches one float32
checksum of every output and the final state (the JAX tool's
``bench_pipe``). Before its timing each protocol's pipeline runs over its
fixture (``data/<protocol>_smoke.npz``, at the fixture's block) and every
field must equal the JAX package's. Prints one JSON line per protocol.
"""
from __future__ import annotations

import argparse
import json
import time

from ..pipeline import PROTOCOLS
from . import common

# tools/bench_protocols.py:128-141, in its order
BLOCKS = {"dmr": 32, "ysf": 40, "nxdn": 16, "dstar": 32, "pocsag": 8}
METRIC = "protocol_pipeline_throughput"


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m digiham_tpu_torch.bench.bench_protocols",
        description="per-protocol pipeline throughput on one card")
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--steps", type=int, default=64,
                   help="dependent steps a rep (the JAX tool's unroll)")
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--centuries", type=int, default=None,
                   help="one block for every protocol (default: each "
                        "protocol's own)")
    common.add_arguments(p)
    return p.parse_args(argv)


def bench_pipe(name, pipe, args, dev, prov, checked) -> dict:
    """The JAX tool's ``bench_pipe``: warm-up, three serial reps, then
    ``reps`` reps under one wall."""
    loop = common.Loop(pipe, "step", args.steps)
    for w in range(2):
        loop.run(args.seed + 900000 + w)
    serial = []
    for r in range(3):
        t0 = time.perf_counter()
        loop.run(args.seed + 800000 + r)
        serial.append(time.perf_counter() - t0)
    t = common.timed_reps(loop, [args.seed + 1 + r
                                 for r in range(args.reps)])
    if not common.distinct(t["checksums"]):
        raise RuntimeError(f"{name}: identical checksums across reps")
    dt = t["wall"] / t["n_steps"]
    msps = loop.samples_per_step / dt / 1e6
    out = {
        "metric": f"{name}_pipeline_throughput", "value": msps,
        "unit": common.UNIT,
        "realtime_channels": msps / common.BASELINE_MSPS,
        "channels": pipe.channels,
        "samples_per_step": pipe.n_centuries * 100 * pipe.sps,
        "n_centuries": pipe.n_centuries, "sps": pipe.sps,
        "block_len": loop.L, "steps": args.steps, "async_calls": args.reps,
        "per_step_seconds": dt, "sustained_wall_seconds": t["wall"],
        "serial_call_seconds": serial, "rep_checksums": t["checksums"],
        "rep_seconds": t["rep_seconds"],
        "generation_ms_per_rep": t["generation_ms"],
        "launches_per_step": t["launches_per_step"],
        "backend": common.backend(dev), "correct": True, "gate": checked,
        **prov}
    if args.profile:
        short = common.Loop(pipe, "step", min(args.steps, 16))
        out["profile"] = dict(common.profile_window(
            lambda: short.run(args.seed + 700000), short.steps, dev),
            steps=short.steps, note="one rep, its base stream's "
                                    "generation included")
    return out


def body(argv=None) -> int:
    args = parse(argv)
    dev = common.open_device(args.device)
    prov = common.provenance(dev)
    for name in BLOCKS:
        checked = common.gate(name, args.channels, dev)
        pipe = PROTOCOLS[name].pipeline(
            args.channels, n_centuries=args.centuries or BLOCKS[name],
            device=dev)
        print(json.dumps(bench_pipe(name, pipe, args, dev, prov, checked)),
              flush=True)
    return 0


def main(argv=None) -> int:
    return common.run_main(METRIC, body, argv)


if __name__ == "__main__":
    raise SystemExit(main())
