"""FEC on the DMR bank path: linear block codes and BPTC(196,96)."""
from . import bptc, codes, interleave, linear  # noqa: F401
