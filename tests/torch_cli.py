"""Running a pipe tool in-process, for the command-line tests of the port
(tests/test_torch_cli.py) and the build of its fixture: the tool's
``*_main`` with ``sys.argv``, ``sys.stdin`` and ``sys.stdout`` patched, the
JAX package's tools and the port's alike."""
import contextlib
import io
import sys
import time


@contextlib.contextmanager
def patched_io(argv, stdin: bytes):
    """sys.argv, a stdin of these bytes and a stdout whose bytes the
    yielded BytesIO collects."""
    out = io.BytesIO()
    saved = sys.argv, sys.stdin, sys.stdout
    wrappers = (io.TextIOWrapper(io.BytesIO(stdin)),
                io.TextIOWrapper(out, write_through=True))
    sys.argv = list(argv)
    sys.stdin, sys.stdout = wrappers
    try:
        yield out
    finally:
        sys.argv, sys.stdin, sys.stdout = saved
        for w in wrappers:  # a wrapper closes its buffer when collected
            w.detach()


def run_tool(main, args, stdin: bytes, wait_for: int | None = None,
             timeout: float = 10.0) -> bytes:
    """stdout of ``main()`` run on ``stdin`` with ``args``. ``wait_for``:
    keep stdout patched until that many bytes arrived (a tool whose reader
    thread writes after ``main`` returned), or ``timeout`` seconds."""
    with patched_io(["tool", *args], stdin) as out:
        rc = main()
        deadline = time.monotonic() + timeout
        while (wait_for is not None and len(out.getvalue()) < wait_for
               and time.monotonic() < deadline):
            time.sleep(0.01)
    assert rc == 0, rc
    return out.getvalue()
