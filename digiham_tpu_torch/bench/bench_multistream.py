"""The aggregate of N processes on one card (the port of
tools/bench_multistream.py).

    python3 -m digiham_tpu_torch.bench.bench_multistream [--procs 2]
        [--protocol dmr] [--stage step|step_iq|fm|rrc|demod|fm_rrc]
        [--channels 256]
        [--centuries 16] [--steps 32] [--reps 6] [--seed 0] [--device cpu]

N spawned processes on the one card each run the step loop of the
headline (``--stage step_iq``: raw I/Q planes through the DMR pipeline's
``step_iq_planes``, kernel K1) or of bench_protocols (``--stage step``, the
default: FM audio through ``--protocol``'s pipeline ``step``), or one of
the JAX tool's stage prefixes of the raw-IQ chain, which attribute the
step's cost by stage under process overlap (``fm``: the FM discriminator;
``rrc``: ``rrc_filter_block``, K4; ``demod``: ``gfsk_demod_block``, K3, pos
reset every step; ``fm_rrc``: the two chained; DMR only,
``common.stage_steps``). Each builds
its pipeline and warms up, reports ready, and waits for a GO file of this
run's own (a fresh temporary directory), so all start their timed reps
together. The parent runs the gate (the protocol's fixture, every field
equal to the JAX package's) before it spawns them. One JSON line: the
aggregate MS/s (all processes' samples over the slowest wall), each
process's wall, each rep's time and checksums, and launches per step, so
that a collapse can be read from the line.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

from . import common

METRIC = "pipeline_multistream"
READY_TIMEOUT_S = 900  # a worker's start, build and warm-up
DONE_TIMEOUT_S = 1800  # its timed reps


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m digiham_tpu_torch.bench.bench_multistream",
        description="the aggregate of N processes on one card")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--protocol", default="dmr",
                   choices=list(common.PROTOCOLS))
    p.add_argument("--stage", default="step",
                   choices=("step", "step_iq") + tuple(common.STAGE_PREFIXES),
                   help="step: FM audio through the protocol's step; "
                        "step_iq: raw I/Q planes through the DMR "
                        "pipeline's step_iq_planes; fm, rrc, demod, fm_rrc: "
                        "the stage prefixes of the raw-IQ chain (DMR)")
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--centuries", type=int, default=16)
    p.add_argument("--steps", type=int, default=32,
                   help="dependent steps a rep (the JAX tool's unroll)")
    p.add_argument("--reps", type=int, default=6)
    common.add_arguments(p)
    return p.parse_args(argv)


def _worker(rank, args, go_file, q):
    """Any exception goes to the parent as ("error", rank, traceback): a
    worker that died silently would leave the parent waiting."""
    try:
        _worker_body(rank, args, go_file, q)
    except BaseException:
        q.put(("error", rank, traceback.format_exc()[-1500:]))
        raise


def _worker_body(rank, args, go_file, q):
    dev = common.open_device(args.device)
    pipe = common.make_pipeline(args.protocol, args.channels, args.centuries,
                                dev)
    loop = common.Loop(pipe, args.stage, args.steps)
    seed = args.seed + 10007 * rank
    for w in range(2):
        loop.run(seed + 900000 + w)
    q.put(("ready", rank))
    while not os.path.exists(go_file):
        if os.getppid() == 1:
            return  # the parent died: do not run on alone
        time.sleep(0.005)
    t = common.timed_reps(loop, [seed + r + 1 for r in range(args.reps)])
    q.put(("done", rank, t["wall"], t["n_steps"] * loop.samples_per_step,
           t["rep_seconds"], t["checksums"], t["launches_per_step"]))


def _collect(q, procs, expect, n, pending):
    """``n`` messages of kind ``expect``; a message of another kind is
    kept for its own collect. A worker's error raises with its
    traceback."""
    got = [m for m in pending if m[0] == expect][:n]
    for m in got:
        pending.remove(m)
    timeout = READY_TIMEOUT_S if expect == "ready" else DONE_TIMEOUT_S
    deadline = time.monotonic() + timeout
    while len(got) < n:
        try:
            msg = q.get(timeout=5)
        except queue.Empty:
            dead = [p.pid for p in procs if not p.is_alive()]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"workers {dead or 'all'} gave no "
                                   f"{expect!r} (exited or timed out)")
            continue
        if msg[0] == "error":
            raise RuntimeError(f"worker {msg[1]}: {msg[2]}")
        (got if msg[0] == expect else pending).append(msg)
    return got


def body(argv=None) -> int:
    args = parse(argv)
    iq = args.stage != "step"  # step_iq and its stage prefixes
    if iq and args.protocol != "dmr":
        raise ValueError(f"stage {args.stage} takes --protocol dmr")
    dev = common.open_device(args.device)
    prov = common.provenance(dev)
    checked = common.gate(args.protocol, args.channels, dev, iq=iq)
    run_dir = tempfile.mkdtemp(prefix="bench_multistream_")
    go_file = os.path.join(run_dir, "go")
    ctx = mp.get_context("spawn")  # CUDA cannot cross a fork
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, args, go_file, q))
             for r in range(args.procs)]
    pending = []
    try:
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        _collect(q, procs, "ready", args.procs, pending)
        start_s = time.perf_counter() - t0
        with open(go_file, "w") as f:
            f.write("go")
        results = sorted(_collect(q, procs, "done", args.procs, pending),
                         key=lambda m: m[1])
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(run_dir, ignore_errors=True)
    walls = [m[2] for m in results]
    checksums = [m[5] for m in results]
    flat = [c for cs in checksums for c in cs]
    if not common.distinct(flat):
        raise RuntimeError("identical checksums across reps")
    agg = sum(m[3] for m in results) / max(walls)
    print(json.dumps({
        "metric": f"{args.protocol}_{METRIC}", "protocol": args.protocol,
        "stage": args.stage, "n_procs": args.procs,
        "aggregate_msps": agg / 1e6,
        "aggregate_vs_baseline": agg / 1e6 / common.BASELINE_MSPS,
        "per_proc_wall_s": walls,
        "wall_ratio": max(walls) / min(walls),
        "per_proc_max_rep_s": [max(m[4]) for m in results],
        "per_proc_rep_s": [m[4] for m in results],
        "rep_checksums": checksums,
        "launches_per_step": [m[6] for m in results],
        "start_s": start_s, "channels": args.channels,
        "centuries": args.centuries, "steps": args.steps, "reps": args.reps,
        "backend": common.backend(dev), "correct": True, "gate": checked,
        **prov}), flush=True)
    return 0


def main(argv=None) -> int:
    return common.run_main(METRIC, body, argv)


if __name__ == "__main__":
    # the package's module, not this __main__, so that the spawned workers
    # find _worker by its import path
    from digiham_tpu_torch.bench import bench_multistream

    sys.exit(bench_multistream.main())
