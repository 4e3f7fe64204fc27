"""Static de-interleaver index tables (port of
``digiham_tpu/fec/interleave.py``, the DMR BPTC table only). Indices map
output position -> input position: ``deinterleaved = x[..., table]``."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def bptc_196() -> np.ndarray:
    """DMR BPTC(196,96) de-interleave: out[i] = in[i*181 % 196]
    (src/dmr_decoder/bptc_196_96.c:12-17)."""
    return np.array([(i * 181) % 196 for i in range(196)], dtype=np.int32)
