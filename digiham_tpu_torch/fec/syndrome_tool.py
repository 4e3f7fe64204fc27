"""Syndrome-table inspection tool (port of
``digiham_tpu/fec/syndrome_tool.py``, over the port's ``fec/codes.py`` and
``fec/linear.py``; its output is the JAX tool's, line for line).

The reference ships six offline ``*_syndrome_generator.c`` programs that
enumerate error patterns and print {syndrome, pattern} tables which were
hand-pasted into the decoders (SURVEY.md §4.1). Here the tables are derived
at import time (fec.linear.BlockCode.syndrome_table); this tool provides
the same offline verification surface: dump any code's table, report
coverage, and self-check that every enumerated error pattern corrects.

Usage: python -m digiham_tpu_torch.fec.syndrome_tool [--dump] [code ...]
"""
from __future__ import annotations

import sys

import numpy as np

from .codes import ALL_CODES
from .linear import decode_np


def check_code(code, verbose: bool = False) -> bool:
    """Enumerate every error pattern up to the correction depth and assert
    the decoder corrects it — the reference generators' self-check
    (e.g. hamming_7_4_syndrome_generator.c:8-18)."""
    patterns = [0]
    for i in range(code.n):
        patterns.append(1 << i)
        if code.correct_bits >= 2:
            for k in range(i):
                patterns.append((1 << i) | (1 << k))
                if code.correct_bits >= 3:
                    for l in range(k):
                        patterns.append((1 << i) | (1 << k) | (1 << l))
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1 << code.k, size=8)
    words = code.encode(data)
    ok_all = True
    for pattern in patterns:
        corrected, ok = decode_np(code, words ^ pattern)
        good = bool(np.all(ok)) and bool(np.all(corrected == words))
        ok_all &= good
        if verbose and not good:
            print(f"  {code.name}: pattern {pattern:0{code.n}b} "
                  f"NOT corrected", file=sys.stderr)
    table = code.syndrome_table
    filled = int((table >= 0).sum())
    print(f"{code.name}: n={code.n} k={code.k} r={code.r} "
          f"correct<= {code.correct_bits} bits; syndrome table "
          f"{filled}/{len(table)} filled; "
          f"self-check {'OK' if ok_all else 'FAILED'}")
    return ok_all


def dump_table(code) -> None:
    table = code.syndrome_table
    for s, pattern in enumerate(table):
        if pattern > 0:
            print(f"{{ 0b{s:0{code.r}b}, 0b{int(pattern):0{code.n}b} }},")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dump = "--dump" in argv
    if dump:
        argv.remove("--dump")
    codes = {c.name: c for c in ALL_CODES}
    selected = [codes[a] for a in argv] if argv else list(ALL_CODES)
    ok = True
    for code in selected:
        if dump:
            dump_table(code)
        else:
            ok &= check_code(code)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
