"""``python3 -m digiham_tpu_torch.soak [program ...]``: the verification
programs on the card, one JSON line each, then exit 1 if any failed.

    python3 -m digiham_tpu_torch.soak all
    python3 -m digiham_tpu_torch.soak dmr --frames 200
    python3 -m digiham_tpu_torch.soak fuzz_timesharded --cases 10 \\
        --channels 2 --device cpu

Programs: ``dmr`` (:mod:`.dmr_soak`), ``impaired`` (:mod:`.impaired`),
``ser`` (:mod:`.ser_equiv`), ``ber`` (:mod:`.ber_sweep`),
``fuzz_timesharded`` (:mod:`.fuzz_timesharded`); ``all`` runs the five in
that order. Without an option each takes its JAX program's size: the DMR
soak 256 channels x 400 frames, the impaired matrix 256 channels x 24
frames, SER 256 channels x 8 centuries x 4 repetitions a point, BER 256
channels x 40 frames a point, the fuzz 100 cases of 2 channels.
``--channels``, ``--frames`` (dmr, impaired, ber), ``--cases`` (the fuzz)
and ``--seed`` override them. Every line carries the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
gives them; with no card (and no ``--device cpu``) the run raises.
"""
import argparse
import json
import sys
import time

from ..bench import common
from . import ber_sweep, dmr_soak, fuzz_timesharded, impaired, ser_equiv

PROGRAMS = ("dmr", "impaired", "ser", "ber", "fuzz_timesharded")
# keys of a result too long for its line
BULKY = ("outputs", "counts", "miss_list")
MISSES_SHOWN = 20


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m digiham_tpu_torch.soak",
                                description=__doc__.split("\n")[0])
    p.add_argument("programs", nargs="*", default=["all"],
                   choices=PROGRAMS + ("all",))
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--cases", type=int, default=None,
                   help="fuzz_timesharded's cases")
    p.add_argument("--seed", type=int, default=None)
    common.add_arguments(p, reps=False)
    return p.parse_args(argv)


def run_program(name: str, args, dev, log) -> dict:
    kw = {"device": dev, "log": log}
    if args.seed is not None:
        kw["seed0" if name == "fuzz_timesharded" else "seed"] = args.seed
    if args.channels is not None:
        kw["channels"] = args.channels
    if args.frames is not None and name in ("dmr", "impaired", "ber"):
        kw["frames"] = args.frames
    if name == "dmr":
        return dmr_soak.run(**kw)
    if name == "impaired":
        return impaired.run(**kw)
    if name == "ser":
        return ser_equiv.run(**kw)
    if name == "ber":
        return ber_sweep.run(**kw)
    if args.cases is not None:
        kw["cases"] = args.cases
    return fuzz_timesharded.run(**kw)


def line(result: dict) -> dict:
    """A result as its JSON line: the bulky keys dropped, the first misses
    kept."""
    out = {k: v for k, v in result.items() if k not in BULKY}
    if "miss_list" in result:
        out["first_misses"] = result["miss_list"][:MISSES_SHOWN]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    names = PROGRAMS if "all" in args.programs else args.programs
    dev = common.open_device(args.device)
    prov = common.provenance(dev)

    def log(text):
        print(text, file=sys.stderr, flush=True)

    failed = []
    for name in names:
        t0 = time.perf_counter()
        result = run_program(name, args, dev, log)
        result["program_wall_s"] = time.perf_counter() - t0
        print(json.dumps({**line(result), "backend": common.backend(dev),
                          **prov}, default=str), flush=True)
        if not result["ok"]:
            failed.append(name)
    if failed:
        print(f"failed: {', '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
