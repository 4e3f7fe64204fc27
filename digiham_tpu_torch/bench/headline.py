"""The headline: raw-IQ DMR decode throughput on one card (the port of
bench.py's ``main``).

    python3 -m digiham_tpu_torch.bench [--channels 256] [--centuries 16]
        [--steps 128] [--reps 8] [--procs 8] [--seed 0] [--profile]
        [--device cpu]

A ``DmrPipeline(channels, sps=10, n_centuries)`` is fed raw I/Q planes
through ``step_iq_planes`` (kernel K1 and the DMR symbol tail). A rep
draws one base stream on the device from a generator seeded by the rep,
then runs ``steps`` dependent steps, each on the window ``k * 512`` of it
(``L = n_centuries * (100 * sps + 1) + 8`` samples; the demod's read index
is reset every step), and fetches one checksum of every step's outputs
and the final carry. The headline is the sustained wall of ``reps`` reps:
channels x ``n_centuries * 100 * sps`` samples a step over the wall per
step, in Msamples/s, with ``vs_baseline`` = MS/s / 0.048 (real-time
reference channels). The rep's generation is inside that wall, as in
bench.py, and its own device time is printed beside.

Before any timing the pipeline runs over the DMR fixture
(``data/dmr_smoke.npz``, 16 centuries) and every field must equal the JAX
package's. Then, with ``--procs N`` (8 on the card by default, 0 skips),
the multi-process stage runs ``bench_multistream`` with N processes on the
card and reports the best stable aggregate (bench.py's verdict rules and
back-off ladder). Prints one JSON line in bench.py's shape.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..pipeline import DMR
from . import common

METRIC = "dmr_iq_pipeline_throughput"
SPS = DMR.sps
# the multi-process stage (bench.py :150-161): steps a rep, centuries, reps
MS_STEPS, MS_CENTURIES, MS_REPS = 64, 16, 6
MS_TIMEOUT_S = 900


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m digiham_tpu_torch.bench",
        description="raw-IQ DMR decode throughput on one card")
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--centuries", type=int, default=16,
                   help="centuries (100 symbols) a step")
    p.add_argument("--steps", type=int, default=128,
                   help="dependent steps a rep (bench.py's unroll)")
    p.add_argument("--reps", type=int, default=8,
                   help="reps in the sustained window")
    p.add_argument("--procs", type=int, default=None,
                   help="processes of the multi-process stage (8 on the "
                        "card, 0 elsewhere; 0 skips it)")
    common.add_arguments(p)
    return p.parse_args(argv)


def _run_multistream_once(n, steps, args) -> dict:
    """One bench_multistream run; its parsed line, or a dict with an
    ``error`` (the stage stays diagnosable)."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "digiham_tpu_torch.bench.bench_multistream",
           "--procs", str(n), "--steps", str(steps), "--centuries",
           str(MS_CENTURIES), "--reps", str(MS_REPS), "--channels",
           str(args.channels), "--seed", str(args.seed), "--stage", "step_iq"]
    if args.device is not None:
        cmd += ["--device", args.device]
    try:
        r = subprocess.run(cmd, env=env, timeout=MS_TIMEOUT_S,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return {"n_procs": n, "steps": steps,
                "error": f"timeout>{MS_TIMEOUT_S}s"}
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith("{")),
                None)
    if r.returncode != 0 or not line:
        return {"n_procs": n, "steps": steps,
                "error": f"rc={r.returncode}: {r.stderr.strip()[-300:]}"
                         f"{(line or '')[-300:]}"}
    return json.loads(line)


def ms_verdict(ms: dict, single_msps) -> str:
    """bench.py's ``_ms_verdict``: ``"stable"``, or why a multi-process
    run is not: an error, uneven per-process walls (max / min > 3), or an
    aggregate below 0.25 x N x the single-stream headline."""
    if "error" in ms:
        return ms["error"]
    walls = ms.get("per_proc_wall_s") or []
    ratio = (max(walls) / min(walls)) if walls else 1.0
    if ratio > 3.0:
        return f"uneven walls (max/min {ratio:.1f})"
    if single_msps and ms["aggregate_msps"] < 0.25 * ms["n_procs"] * \
            single_msps:
        return (f"aggregate {ms['aggregate_msps']} < 0.25 x "
                f"{ms['n_procs']} x single {single_msps:.0f}")
    return "stable"


def multistream_stage(head: dict, n: int, args) -> None:
    """bench.py's ``_with_multistream``: the configured point (run twice
    before backing off), then fewer processes, then fewer steps a rep; the
    first stable run wins, else the best unstable one with its diagnosis;
    every attempt's verdict is kept. Adds ``multistream`` to ``head``."""
    u = MS_STEPS
    lo_u = max(u // 2, 1)
    ladder = [(n, u), (n, u), (max(n // 2, 1), u), (n, lo_u),
              (max(n // 2, 1), lo_u)]
    seen, attempts = set(), []
    best = best_verdict = None
    for idx, (np_, u_) in enumerate(ladder):
        if (np_, u_) in seen:
            continue
        if idx != 0:  # rung 0 stays unseen so its retry (rung 1) runs
            seen.add((np_, u_))
        ms = _run_multistream_once(np_, u_, args)
        verdict = ms_verdict(ms, head["value"])
        attempts.append({"n_procs": np_, "steps": u_,
                         "aggregate_msps": ms.get("aggregate_msps"),
                         "per_proc_wall_s": ms.get("per_proc_wall_s"),
                         "verdict": verdict})
        if verdict == "stable":
            best, best_verdict = ms, verdict
            break
        if "error" not in ms and (best is None or ms["aggregate_msps"]
                                  > best["aggregate_msps"]):
            best, best_verdict = ms, verdict
    if best is None:
        head["multistream"] = {"error": "no attempt produced a number",
                               "attempts": attempts}
        return
    head["multistream"] = {
        "n_procs": best["n_procs"],
        "aggregate_msps": best["aggregate_msps"],
        "aggregate_vs_baseline": best["aggregate_msps"]
        / common.BASELINE_MSPS,
        "steps": best["steps"],
        "per_proc_wall_s": best["per_proc_wall_s"],
        "correct": best.get("correct"),
        "stable": best_verdict == "stable"}
    if best_verdict != "stable":
        head["multistream"]["collapse_diagnosis"] = best_verdict
    if len(attempts) > 1:
        head["multistream"]["attempts"] = attempts


def body(argv=None) -> int:
    from ..pipeline import DmrPipeline

    args = parse(argv)
    dev = common.open_device(args.device)
    prov = common.provenance(dev)
    checked = common.gate("dmr", args.channels, dev, iq=True)
    pipe = DmrPipeline(channels=args.channels, sps=SPS,
                       n_centuries=args.centuries, device=dev)
    loop = common.Loop(pipe, "step_iq", args.steps)
    for w in range(2):  # warm-up: builds and first launches
        loop.run(args.seed + 900000 + w)
    serial = []
    for r in range(3):  # one rep at a time, each waited for
        t0 = time.perf_counter()
        loop.run(args.seed + 800000 + r)
        serial.append(time.perf_counter() - t0)
    t = common.timed_reps(loop, [args.seed + 1 + r
                                 for r in range(args.reps)])
    if not common.distinct(t["checksums"]):
        raise RuntimeError("identical checksums across reps: the steps "
                           "did not consume their inputs")
    dt = t["wall"] / t["n_steps"]
    samples_per_step = args.centuries * 100 * SPS
    msps = args.channels * samples_per_step / dt / 1e6
    result = {
        "metric": METRIC, "value": msps, "unit": common.UNIT,
        "vs_baseline": msps / common.BASELINE_MSPS,
        # every 144-dibit frame window of the block is field-decoded
        "frames_decoded_per_s":
            args.channels * (args.centuries * 100 // 144) / dt,
        "channels": args.channels, "samples_per_step": samples_per_step,
        "steps": args.steps, "async_calls": args.reps,
        "sustained_wall_seconds": t["wall"], "per_step_seconds": dt,
        "serial_call_seconds": serial, "rep_checksums": t["checksums"],
        "rep_seconds": t["rep_seconds"],
        "generation_ms_per_rep": t["generation_ms"],
        "block_len": loop.L, "n_centuries": args.centuries, "sps": SPS,
        "launches_per_step": t["launches_per_step"],
        "k1_launches_per_step": t["launches_per_step"].get("fm_rrc", 0.0),
        "backend": common.backend(dev), "correct": True, "gate": checked,
        **prov}
    if args.profile:
        short = common.Loop(pipe, "step_iq", min(args.steps, 16))
        result["profile"] = dict(common.profile_window(
            lambda: short.run(args.seed + 700000), short.steps, dev),
            steps=short.steps, note="one rep, its base stream's "
                                    "generation included")
    procs = args.procs if args.procs is not None else (
        8 if dev.type == "cuda" else 0)
    if procs:
        multistream_stage(result, procs, args)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    return common.run_main(METRIC, body, argv)
