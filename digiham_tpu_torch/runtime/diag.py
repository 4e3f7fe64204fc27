"""Diagnostic lines of the host machines (digiham's ``std::cerr``
prints, such as NXDN's ``FACCH1 message type: <n>``), on standard error.

:func:`say` writes a line at once, as ``print`` does, unless a
:func:`batch` is open on the thread: then the line is held, and the batch
writes every line it held in one call when it closes, in the order they
came. A busy NXDN site says about a hundred lines a bank step, and one
write each cost more than the rest of a tracker's frame (a write takes
tens of microseconds on a shared host, and varies more than the compute
beside it), so the bank holds a step's lines in one batch.
"""
from __future__ import annotations

import contextlib
import sys
import threading

_local = threading.local()


def say(line: str) -> None:
    """Write ``line`` to standard error, or hold it in the open batch."""
    held = getattr(_local, "held", None)
    if held is None:
        print(line, file=sys.stderr)
    else:
        held.append(line)


@contextlib.contextmanager
def batch():
    """Hold the lines said inside, and write them in one call at the end
    (an inner batch leaves them to the outer one)."""
    if getattr(_local, "held", None) is not None:
        yield
        return
    _local.held = held = []
    try:
        yield
    finally:
        _local.held = None
        if held:
            sys.stderr.write("".join(line + "\n" for line in held))
            sys.stderr.flush()
