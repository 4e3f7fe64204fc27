"""The port carries its own copies of the JAX package's tables (the card's
machine has no JAX). Each copy must be exactly equal to the original."""
import dataclasses

import numpy as np
import pytest
import torch

from digiham_tpu.dsp import rrc as j_rrc
from digiham_tpu.fec import bptc as j_bptc
from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec import crc as j_crc
from digiham_tpu.fec import interleave as j_interleave
from digiham_tpu.fec import lfsr as j_lfsr
from digiham_tpu.fec import viterbi as j_viterbi
from digiham_tpu.protocols.dmr import components as j_components
from digiham_tpu.protocols.dmr import phases as j_phases
from digiham_tpu.protocols.nxdn import phases as j_nxdn_phases
from digiham_tpu.protocols.ysf import phases as j_ysf_phases
from digiham_tpu_torch.dsp import rrc
from digiham_tpu_torch.fec import (bptc, codes, crc, interleave, lfsr,
                                   viterbi)
from digiham_tpu_torch.pipeline import (DmrPipeline, DmrTables, NxdnPipeline,
                                        NxdnTables, YsfPipeline, YsfTables)
from digiham_tpu_torch.protocols.dmr import constants
from digiham_tpu_torch.protocols.nxdn import constants as nxdn_constants
from digiham_tpu_torch.protocols.ysf import constants as ysf_constants

torch.set_num_threads(1)

DMR_CODES = ["HAMMING_7_4", "HAMMING_13_9", "HAMMING_15_11", "GOLAY_20_8",
             "QR_16_7"]
CODES = DMR_CODES + ["GOLAY_24_12", "HAMMING_16_11", "BCH_31_21"]


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

    pipe = DmrPipeline(channels=2, device="cpu")
    buffers = dict(pipe.named_buffers())
    assert set(buffers) == {"rrc_taps"} | {
        f.name for f in dataclasses.fields(DmrTables)}
    assert np.array_equal(buffers["rrc_taps"].numpy(),
                          j_rrc.WIDE_RRC.scaled_taps)
    assert np.array_equal(buffers["sync_patterns"].numpy(),
                          j_dmr._SYNC_PATTERNS)
    assert np.array_equal(buffers["sync_types"].numpy(), j_dmr._SYNC_TYPES)
    for name in DMR_CODES:
        code = getattr(j_codes, name)
        assert np.array_equal(buffers[f"syndrome_{code.name}"].numpy(),
                              code.syndrome_table)


def test_all_codes_lists_every_code():
    assert [c.name for c in codes.ALL_CODES] == sorted(
        (getattr(codes, n).name for n in CODES),
        key=[c.name for c in j_codes.ALL_CODES].index)


@pytest.mark.parametrize("name", ["ysf_fich", "ysf_v2_voice", "ysf_dch_v2",
                                  "nxdn_sacch", "nxdn_facch1",
                                  "dstar_header"])
def test_interleave_tables_equal(name):
    ours, ref = getattr(interleave, name)(), getattr(j_interleave, name)()
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert sorted(set(ours.tolist())) == sorted(ours.tolist())  # a gather


@pytest.mark.parametrize("name", ["depuncture_mask_sacch",
                                  "depuncture_mask_facch1"])
def test_depuncture_tables_equal(name):
    ours, ref = getattr(interleave, name)(), getattr(j_interleave, name)()
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and np.array_equal(o, r)


@pytest.mark.parametrize("name", ["ysf_whitening", "nxdn_scrambler",
                                  "dstar_scrambler"])
def test_keystreams_equal(name):
    ours, ref = getattr(lfsr, name)(), getattr(j_lfsr, name)()
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert np.array_equal(getattr(lfsr, name)(200),
                          getattr(j_lfsr, name)(200))


@pytest.mark.parametrize("name,nbits", [("crc16_ysf", 32), ("crc16_ysf", 80),
                                        ("crc6_nxdn", 26),
                                        ("crc12_nxdn", 80),
                                        ("crc16_dstar", 312)])
def test_crc_tables_and_constants_equal(name, nbits):
    ref = getattr(j_crc, name)(nbits)
    if name == "crc16_dstar":
        # the port's D-Star CRC runs over bytes: its value on no bit set is
        # the constant, and on bit i alone the constant ^ table[i]
        def over(bits):
            return crc.crc16_dstar_bytes(
                np.packbits(bits, bitorder="little").tobytes())
        zero = np.zeros(nbits, np.uint8)
        assert over(zero) == ref.const
        assert [over(np.eye(1, nbits, i, np.uint8)[0]) ^ ref.const
                for i in range(nbits)] == ref.table.tolist()
        return
    ours = getattr(crc, name)(nbits)
    assert (ours.width, ours.const) == (ref.width, ref.const)
    assert np.array_equal(ours.table, ref.table)


@pytest.mark.parametrize("name", ["SYNC_SIZE", "FICH_SIZE", "FRAME_SIZE",
                                  "YSF_SYNC", "TRIBIT_MAJORITY",
                                  "V2_VOICE_MAPPING"])
def test_ysf_constants_equal(name):
    ours, ref = getattr(ysf_constants, name), getattr(j_ysf_phases, name)
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    assert np.array_equal(ours, ref)


def test_v2_voice_mapping_has_no_repeated_index():
    """decode_vd2_voice_batch writes voice bit i to output bit
    V2_VOICE_MAPPING[i] by index assignment: with no repeated index the
    order of the writes cannot matter."""
    mapping = ysf_constants.V2_VOICE_MAPPING
    assert len(set(mapping.tolist())) == len(mapping) == 49
    assert mapping.min() >= 0 and mapping.max() < 56


@pytest.mark.parametrize("name", ["SYNC_SIZE", "FRAME_SIZE", "FRAME_SYNC"])
def test_nxdn_constants_equal(name):
    ours, ref = getattr(nxdn_constants, name), getattr(j_nxdn_phases, name)
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    assert np.array_equal(ours, ref)


def test_transitions_and_branch_tables_equal():
    assert viterbi.TRANSITIONS_16.dtype == j_viterbi.TRANSITIONS_16.dtype
    assert np.array_equal(viterbi.TRANSITIONS_16, j_viterbi.TRANSITIONS_16)
    for o, r in zip(viterbi._branch_tables(16, viterbi.TRANSITIONS_16),
                    j_viterbi._branch_tables(16, j_viterbi.TRANSITIONS_16)):
        assert o.dtype == r.dtype and np.array_equal(o, r)


@pytest.mark.parametrize("kind,tables,design", [
    (YsfPipeline, YsfTables, "WIDE_RRC"),
    (NxdnPipeline, NxdnTables, "NARROW_RRC")])
def test_ysf_nxdn_pipeline_buffers_hold_the_tables(kind, tables, design):
    """The YSF and NXDN pipelines register every table as a buffer, with
    the values of the JAX package."""
    pipe = kind(channels=2, device="cpu")
    buffers = dict(pipe.named_buffers())
    assert set(buffers) == {"rrc_taps"} | {
        f.name for f in dataclasses.fields(tables)}
    assert np.array_equal(buffers["rrc_taps"].numpy(),
                          getattr(j_rrc, design).scaled_taps)
    assert pipe.rrc_design.name == getattr(j_rrc, design).name
    if kind is YsfPipeline:
        assert np.array_equal(buffers["sync"].numpy(), j_ysf_phases.YSF_SYNC)
        assert np.array_equal(buffers["whitening"].numpy(),
                              j_lfsr.ysf_whitening()[:104])
        assert np.array_equal(buffers["syndrome_golay_24_12"].numpy(),
                              j_codes.GOLAY_24_12.syndrome_table)
    else:
        assert np.array_equal(buffers["sync"].numpy(),
                              j_nxdn_phases.FRAME_SYNC)
        assert np.array_equal(buffers["scrambler"].numpy(),
                              j_lfsr.nxdn_scrambler()[:192])
        idx, mask = j_interleave.depuncture_mask_facch1()
        assert np.array_equal(buffers["facch1_depuncture_idx"].numpy(), idx)
        assert np.array_equal(buffers["facch1_depuncture_mask"].numpy(),
                              mask)


@pytest.mark.parametrize("entry", ["DmrPipeline", "YsfPipeline",
                                   "NxdnPipeline", "demod_init",
                                   "RrcState.init", "DmrTables.build",
                                   "convert.from_jax"])
def test_entry_points_with_no_device_need_the_card(entry):
    """device=None means the card: with no CUDA device every entry point
    raises an error that names the missing card instead of running on the
    CPU. (The CPU tests ask for device="cpu" themselves.)"""
    from digiham_tpu_torch import convert
    from digiham_tpu_torch.dsp.demod import demod_init

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    calls = {
        "DmrPipeline": lambda: DmrPipeline(channels=2),
        "YsfPipeline": lambda: YsfPipeline(channels=2),
        "NxdnPipeline": lambda: NxdnPipeline(channels=2),
        "demod_init": lambda: demod_init(2),
        "RrcState.init": lambda: rrc.RrcState.init(2),
        "DmrTables.build": DmrTables.build,
        "convert.from_jax": lambda: convert.from_jax(
            DmrPipeline(channels=2, device="cpu").init_state()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
