"""DMR BPTC(196,96) product-code decode (port of ``digiham_tpu/fec/bptc.py``).

De-interleave with ``source = i*181 % 196``, skip the leading R(3) pad bit,
decode 15 columns as Hamming(13,9) then 9 rows as Hamming(15,11), and
extract 96 data bits (row 0 gives bits 11..4, rows 1-8 bits 14..4).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import interleave
from .codes import HAMMING_13_9, HAMMING_15_11
from .linear import decode as _decode


@functools.lru_cache(maxsize=None)
def column_source() -> np.ndarray:
    """[15, 13] indices into the RECEIVED 196 bits: column i, element k is
    de-interleaved bit k*15 + i + 1 (MSB of the 13-bit column word first),
    with the de-interleave folded in so decoding needs one gather."""
    cols = np.array([[k * 15 + i + 1 for k in range(13)] for i in range(15)])
    return interleave.bptc_196()[cols].astype(np.int64)


def decode(bits196: torch.Tensor, columns: torch.Tensor | None = None,
           table_13_9: torch.Tensor | None = None,
           table_15_11: torch.Tensor | None = None):
    """bits196: [..., 196] 0/1 integers -> (data_bits [..., 96] int32,
    ok [...] bool). ``columns`` (:func:`column_source`) and the two
    syndrome tables are built on ``bits196.device`` when omitted."""
    dev = bits196.device
    if columns is None:
        columns = torch.as_tensor(column_source(), device=dev)
    cols_bits = bits196[..., columns].to(torch.int64)  # [..., 15, 13]
    col_words = (cols_bits << torch.arange(12, -1, -1, device=dev)).sum(-1)
    col_corr, col_ok = _decode(HAMMING_13_9, col_words, table_13_9)
    ok = col_ok.all(-1)

    # row i bit (14-k) = column k word bit (12-i)
    shift = (12 - torch.arange(9, device=dev))[:, None]
    col_bits = (col_corr[..., None, :].to(torch.int64) >> shift) & 1
    row_words = (col_bits << torch.arange(14, -1, -1, device=dev)).sum(-1)
    row_corr, row_ok = _decode(HAMMING_15_11, row_words, table_15_11)
    ok = ok & row_ok.all(-1)

    first = (row_corr[..., :1] >> torch.arange(11, 3, -1, device=dev)) & 1
    rest = (row_corr[..., 1:9, None]
            >> torch.arange(14, 3, -1, device=dev)) & 1
    data_bits = torch.cat([first, rest.flatten(-2)], dim=-1)
    return data_bits.to(torch.int32), ok
