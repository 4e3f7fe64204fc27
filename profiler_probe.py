"""How many device kernels torch.profiler records of a short session, as a
process ages and after each suspect event, in a plain session and through
:func:`.common.profiled`.

    python3 profiler_probe.py   # from the repository's root, on the card, ~5 min

A diagnostic of the profiler, not a measuring program: the programs'
sessions (``digiham_tpu_torch.bench.common.profiled``) already refuse a
session that lost a record.

Each probe runs two works ten times: a torch kernel (an in-place multiply
of 1M floats) and kernel K3 (the port's century demod, 256 channels x 10
centuries, launched through ctypes), once in a plain session that stops
right after the work's synchronize and once through ``common.profiled``
(margins before and after, a mark, taken again with the margins doubled
until every launch it saw has its device record).
Probes are taken at the start, after 60 s of load, after each suspect (a
spawned process that uses the card, a subprocess that does, a cProfile
session, NCCL ``init_process_group`` / ``all_reduce`` /
``destroy_process_group``) and after 90 s idle. One JSON line a probe: the
kernels seen of 10 for each work and way, and the sessions
``common.profiled`` took and its last margin.
"""
from __future__ import annotations

import cProfile
import json
import multiprocessing as mp
import socket
import subprocess
import sys
import time

import torch

from digiham_tpu_torch.bench import common

CALLS = 10


def _card_child():
    torch.zeros(4, device="cuda").sum().item()


def works(dev):
    from digiham_tpu_torch.ops import demod_front

    x = torch.randn(1 << 20, device=dev)
    s = torch.randn(256, 10112, device=dev)
    pos = torch.zeros(256, dtype=torch.int32, device=dev)
    ring = torch.zeros(256, 100, device=dev)
    return {"torch kernel": lambda: x.mul_(1.0000001),
            "K3": lambda: demod_front.demod(s, pos, pos, ring, n_centuries=10,
                                             sps=10)}


def _seen(fn, dev, helper: bool) -> dict:
    """Kernels of CALLS calls of ``fn`` a session recorded: a plain
    session that stops right after the work's synchronize, or
    :func:`common.profiled` (and how many sessions it took)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    common.synchronize(dev)
    if helper:
        tries = [0]

        def work():
            tries[0] += 1
            for _ in range(CALLS):
                fn()

        session, _ = common.profiled(work, dev)
        return {"seen": len(session.events), "sessions": tries[0],
                "margin_s": session.margin_s}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        common.synchronize(dev)
    return {"seen": len(common.device_events(prof))}


def probe(stage, fns, dev, t0) -> dict:
    """Kernels seen of :data:`CALLS` for each of ``fns`` (:func:`works`)
    by a plain session and by :func:`common.profiled`; ``age_s`` the
    process's age (from ``t0``)."""
    out = {"stage": stage, "age_s": time.perf_counter() - t0,
           "calls": CALLS}
    for name, fn in fns.items():
        out[name] = {"plain session": _seen(fn, dev, False),
                     "common.profiled": _seen(fn, dev, True)}
    return out


def _load(fns, dev, seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(100):
            for fn in fns.values():
                fn()
        common.synchronize(dev)


def _spawned():
    child = mp.get_context("spawn").Process(target=_card_child)
    child.start()
    child.join()


def _subprocess():
    subprocess.run([sys.executable, "-c", "import torch; "
                    "torch.zeros(1, device='cuda').item()"], check=True)


def _nccl(dev):
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    dist.all_reduce(torch.ones(8, device=dev))
    common.synchronize(dev)
    dist.destroy_process_group()


def main() -> int:
    t0 = time.perf_counter()
    dev = common.open_device(None)
    fns = works(dev)
    stages = (
        ("start", lambda: None),
        ("after 60 s of load", lambda: _load(fns, dev, 60)),
        ("after a spawned process that used the card", _spawned),
        ("after a subprocess that used the card", _subprocess),
        ("after a cProfile session", lambda: cProfile.Profile().runcall(
            lambda: [fns["K3"]() for _ in range(100)])),
        ("after NCCL init, all_reduce and destroy", lambda: _nccl(dev)),
        ("after 90 s idle", lambda: time.sleep(90)))
    for stage, event in stages:
        event()
        print(json.dumps(probe(stage, fns, dev, t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
