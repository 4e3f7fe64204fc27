"""The port carries its own copies of the JAX package's tables (the card's
machine has no JAX). Each copy must be exactly equal to the original."""
import dataclasses

import numpy as np
import pytest
import torch

from digiham_tpu.dsp import rrc as j_rrc
from digiham_tpu.fec import bptc as j_bptc
from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec import interleave as j_interleave
from digiham_tpu.protocols.dmr import components as j_components
from digiham_tpu.protocols.dmr import phases as j_phases
from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.fec import bptc, codes, interleave
from digiham_tpu_torch.pipeline import DmrPipeline, DmrTables
from digiham_tpu_torch.protocols.dmr import constants

torch.set_num_threads(1)

CODES = ["HAMMING_7_4", "HAMMING_13_9", "HAMMING_15_11", "GOLAY_20_8",
         "QR_16_7"]


@pytest.mark.parametrize("design", ["WIDE_RRC", "NARROW_RRC"])
def test_rrc_designs_equal(design):
    ours, ref = getattr(rrc, design), getattr(j_rrc, design)
    assert ours.name == ref.name and ours.gain == ref.gain
    assert ours.taps == ref.taps
    assert ours.scaled_taps.dtype == ref.scaled_taps.dtype
    assert np.array_equal(ours.scaled_taps, ref.scaled_taps)


@pytest.mark.parametrize("name", CODES)
def test_code_definitions_and_syndrome_tables_equal(name):
    ours, ref = getattr(codes, name), getattr(j_codes, name)
    assert (ours.name, ours.n, ours.k, ours.correct_bits) == \
        (ref.name, ref.n, ref.k, ref.correct_bits)
    assert ours.parity_rows == ref.parity_rows
    assert ours.syndrome_table.dtype == ref.syndrome_table.dtype
    assert np.array_equal(ours.syndrome_table, ref.syndrome_table)


def test_bptc_tables_equal():
    assert np.array_equal(interleave.bptc_196(), j_interleave.bptc_196())
    # the port folds the de-interleave into the column gather
    ref = j_interleave.bptc_196()[j_bptc._column_gather()]
    assert np.array_equal(bptc.column_source(), ref)


@pytest.mark.parametrize("name", [
    "BS_DATA_SYNC", "BS_VOICE_SYNC", "MS_DATA_SYNC", "MS_VOICE_SYNC",
    "CACH_SIZE", "FRAME_SIZE", "SYNC_OFFSET", "SYNC_SIZE"])
def test_dmr_constants_equal(name):
    ours, ref = getattr(constants, name), getattr(j_phases, name)
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    assert np.array_equal(ours, ref)


def test_tact_positions_equal():
    assert constants.TACT_POSITIONS.dtype == j_components.TACT_POSITIONS.dtype
    assert np.array_equal(constants.TACT_POSITIONS,
                          j_components.TACT_POSITIONS)


def test_pipeline_buffers_hold_the_tables():
    """DmrPipeline registers every table as a buffer (so .to(device)
    moves them), with the values of the JAX package."""
    from digiham_tpu.pipeline import dmr as j_dmr

    pipe = DmrPipeline(channels=2)
    buffers = dict(pipe.named_buffers())
    assert set(buffers) == {"rrc_taps"} | {
        f.name for f in dataclasses.fields(DmrTables)}
    assert np.array_equal(buffers["rrc_taps"].numpy(),
                          j_rrc.WIDE_RRC.scaled_taps)
    assert np.array_equal(buffers["sync_patterns"].numpy(),
                          j_dmr._SYNC_PATTERNS)
    assert np.array_equal(buffers["sync_types"].numpy(), j_dmr._SYNC_TYPES)
    for name in CODES:
        code = getattr(j_codes, name)
        assert np.array_equal(buffers[f"syndrome_{code.name}"].numpy(),
                              code.syndrome_table)
