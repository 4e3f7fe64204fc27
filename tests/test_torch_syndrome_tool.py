"""The port's syndrome-table tool (``digiham_tpu_torch/fec/syndrome_tool.py``)
against the JAX package's: the self-check report and ``--dump`` of every
code equal line for line, each code alone too, and the tables it prints
equal ``digiham_tpu/fec/codes.py``'s. Exact (text and integers)."""
import contextlib
import io

import numpy as np
import pytest

from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec import syndrome_tool as j_tool
from digiham_tpu_torch.fec import codes
from digiham_tpu_torch.fec import syndrome_tool as tool

NAMES = [c.name for c in j_codes.ALL_CODES]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [[], ["--dump"]], ids=["check", "dump"])
def test_output_equals_the_jax_tool(argv):
    rc, out, err = _run(tool.main, list(argv))
    j_rc, j_out, j_err = _run(j_tool.main, list(argv))
    assert (rc, out.splitlines(), err) == (j_rc, j_out.splitlines(), j_err)
    assert rc == 0 and out
    if not argv:
        assert len(out.splitlines()) == len(NAMES)
        assert all(line.endswith("self-check OK")
                   for line in out.splitlines())


@pytest.mark.parametrize("name", NAMES)
def test_each_code_alone(name):
    for argv in ([name], ["--dump", name]):
        assert _run(tool.main, list(argv)) == _run(j_tool.main, list(argv))


@pytest.mark.parametrize("name", NAMES)
def test_tables_equal_the_jax_codes(name):
    mine = {c.name: c for c in codes.ALL_CODES}[name]
    theirs = {c.name: c for c in j_codes.ALL_CODES}[name]
    assert (mine.n, mine.k, mine.r, mine.correct_bits) == (
        theirs.n, theirs.k, theirs.r, theirs.correct_bits)
    np.testing.assert_array_equal(np.asarray(mine.syndrome_table),
                                  np.asarray(theirs.syndrome_table))


def test_runs_as_a_module():
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-m",
                        "digiham_tpu_torch.fec.syndrome_tool", "hamming_7_4"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0
    assert r.stdout == _run(j_tool.main, ["hamming_7_4"])[1]
