"""Batched NXDN pipeline for a bank of channels (port of
``digiham_tpu/pipeline/nxdn.py``).

    FM audio [C, L] -> K2 (narrow RRC + century demod at 20 sps)
    -> dibits [C, S] -> dense sync correlation [C, S-9]
    192-dibit frames -> LICH, SACCH and FACCH1 (descramble, de-interleave,
    de-puncture, blocked-start Viterbi K5, CRC), packed voice bytes.

Reference per-unit logic: src/nxdn_decoder/sacch.cpp, facch1.cpp,
scrambler.cpp, lich.cpp. The field dict keeps the JAX package's keys,
shapes and dtypes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..dsp.rrc import NARROW_RRC
from ..fec import interleave
from ..fec.crc import crc6_nxdn, crc12_nxdn
from ..fec.lfsr import nxdn_scrambler
from ..fec.viterbi import viterbi_decode, viterbi_decode_many
from ..ops.correlate import sync_correlate
from ..protocols.nxdn.constants import (FRAME_SIZE, FRAME_SYNC, SYNC_BOUND,
                                        SYNC_SIZE)
from .bank import (BankPipeline, PipelineState, Protocol, Sync,
                   bits_from_dibits, table)


@dataclasses.dataclass(frozen=True)
class NxdnTables:
    """Every constant table the frame decode reads, as tensors on one
    device. A depuncture table is the pair (gather index, keep mask)."""

    sync: torch.Tensor                  # [10] uint8
    scrambler: torch.Tensor             # [192] int32 keystream
    sacch_deinterleave: torch.Tensor    # [60] int64
    facch1_deinterleave: torch.Tensor   # [144] int64
    sacch_depuncture_idx: torch.Tensor  # [72] int64
    sacch_depuncture_mask: torch.Tensor  # [72] bool
    facch1_depuncture_idx: torch.Tensor  # [192] int64
    facch1_depuncture_mask: torch.Tensor  # [192] bool
    crc6: torch.Tensor                  # [26, 6] int32 bit planes
    crc12: torch.Tensor                 # [80, 12] int32 bit planes

    @classmethod
    def build(cls, device=None) -> "NxdnTables":
        device = resolve_device(device)
        sacch_idx, sacch_mask = interleave.depuncture_mask_sacch()
        facch1_idx, facch1_mask = interleave.depuncture_mask_facch1()
        return cls(
            sync=table(FRAME_SYNC, np.uint8, device),
            scrambler=table(nxdn_scrambler()[:FRAME_SIZE], np.int32, device),
            sacch_deinterleave=table(interleave.nxdn_sacch(), np.int64,
                                     device),
            facch1_deinterleave=table(interleave.nxdn_facch1(), np.int64,
                                      device),
            sacch_depuncture_idx=table(sacch_idx, np.int64, device),
            sacch_depuncture_mask=table(sacch_mask, np.bool_, device),
            facch1_depuncture_idx=table(facch1_idx, np.int64, device),
            facch1_depuncture_mask=table(facch1_mask, np.bool_, device),
            crc6=crc6_nxdn(26).planes(device),
            crc12=crc12_nxdn(80).planes(device),
        )


def nxdn_sync_correlate(dibits: torch.Tensor,
                        sync: torch.Tensor | None = None) -> torch.Tensor:
    """[C, T] dibits -> [C, T-9] int32 distances to the NXDN frame sync."""
    if sync is None:
        sync = torch.as_tensor(FRAME_SYNC, device=dibits.device)
    return sync_correlate(dibits, sync[None, :], 4)[..., 0]


def _descramble(d: torch.Tensor, offset: int,
                scrambler: torch.Tensor) -> torch.Tensor:
    """Flip the high bit of each dibit by the keystream from in-frame
    dibit ``offset`` on."""
    return d ^ (scrambler[offset:offset + d.shape[-1]] << 1)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] bits -> [...] int32, first bit most significant."""
    n = bits.shape[-1]
    weights = 1 << torch.arange(n - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    return (bits * weights).sum(-1, dtype=torch.int32)


def _depunctured(bits: torch.Tensor, idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Inflate punctured bits (a 0 at each punctured place) and pair them
    to the dibits the Viterbi decoder reads (with the 4 leading zeros
    known: ``blocked_steps=4``)."""
    inflated = torch.where(mask, bits[..., idx], 0)
    return (inflated[..., 0::2] << 1) | inflated[..., 1::2]


def _sacch_coded(descrambled: torch.Tensor,
                 tables: NxdnTables) -> torch.Tensor:
    """[..., 30] descrambled SACCH dibits -> [..., 36] coded dibits."""
    dei = bits_from_dibits(descrambled)[..., tables.sacch_deinterleave]
    return _depunctured(dei, tables.sacch_depuncture_idx,
                        tables.sacch_depuncture_mask)


def _sacch_fields(decoded: torch.Tensor, tables: NxdnTables):
    """[..., 36] decoded SACCH bits -> (structure, payload bits, ok)."""
    crc = crc6_nxdn(26).compute(decoded[..., :26], tables.crc6)
    ok = crc == _pack(decoded[..., 26:32])
    structure = ((decoded[..., 0] << 1) | decoded[..., 1]) ^ 0b11
    return structure, decoded[..., 8:26], ok


def decode_sacch_batch(sacch_dibits: torch.Tensor,
                       tables: NxdnTables | None = None):
    """[..., 30] raw SACCH dibits (still scrambled, in-frame offset 8) ->
    (structure_index [...] int32, payload_bits [..., 18] int32, ok)."""
    if tables is None:
        tables = NxdnTables.build(sacch_dibits.device)
    d = _descramble(sacch_dibits.to(torch.int32), 8, tables.scrambler)
    decoded, _ = viterbi_decode(_sacch_coded(d, tables), blocked_steps=4)
    return _sacch_fields(decoded, tables)


def _facch1_coded(descrambled: torch.Tensor,
                  tables: NxdnTables) -> torch.Tensor:
    """[..., 72] descrambled slot dibits -> [..., 96] coded dibits."""
    dei = bits_from_dibits(descrambled)[..., tables.facch1_deinterleave]
    return _depunctured(dei, tables.facch1_depuncture_idx,
                        tables.facch1_depuncture_mask)


def _facch1_fields(decoded: torch.Tensor, tables: NxdnTables):
    """[..., 96] decoded FACCH1 bits -> (message_type, ok)."""
    crc = crc12_nxdn(80).compute(decoded[..., :80], tables.crc12)
    ok = crc == _pack(decoded[..., 80:92])
    return _pack(decoded[..., 2:8]), ok


def decode_facch1_batch(slot_dibits: torch.Tensor, offset: int = 38,
                        tables: NxdnTables | None = None):
    """[..., 72] raw slot dibits at in-frame dibit ``offset`` ->
    (message_type [...] int32, ok)."""
    if tables is None:
        tables = NxdnTables.build(slot_dibits.device)
    d = _descramble(slot_dibits.to(torch.int32), offset, tables.scrambler)
    decoded, _ = viterbi_decode(_facch1_coded(d, tables), blocked_steps=4)
    return _facch1_fields(decoded, tables)


def nxdn_decode_frames(frames: torch.Tensor,
                       tables: NxdnTables | None = None):
    """[..., 192] frame dibits -> field dict: sync distance, LICH byte/ok,
    SACCH unit, per-slot packed voice bytes and FACCH1 message type/ok
    (both slots decoded; the host's steal-flag logic picks which to use).
    Launches K5 once on the card: the SACCH and both FACCH1 slots of every
    frame are two batches of one launch."""
    if tables is None:
        tables = NxdnTables.build(frames.device)
    d = frames.to(torch.int32)
    x = d[..., :SYNC_SIZE] ^ tables.sync.to(torch.int32)
    sync_dist = ((x & 1) + (x >> 1)).sum(-1, dtype=torch.int32)

    # LICH (lich.cpp:5-30): descramble 8 dibits at offset 0, take the high
    # bits, parity over the top 4
    lich_bits = (_descramble(d[..., 10:18], 0, tables.scrambler) >> 1) & 1
    check = lich_bits[..., :4].sum(-1, dtype=torch.int32) & 1
    lich_ok = lich_bits[..., 7] == check
    lich_byte = _pack(lich_bits[..., :7])

    # the two 72-dibit slots follow each other from in-frame dibit 38 on, so
    # one descramble covers both: [..., 2, 72]
    slots = _descramble(d[..., 48:192], 38, tables.scrambler).reshape(
        d.shape[:-1] + (2, 72))
    (sacch, _), (facch, _) = viterbi_decode_many([
        (_sacch_coded(_descramble(d[..., 18:48], 8, tables.scrambler),
                      tables), 4),
        (_facch1_coded(slots, tables), 4)])
    sacch_structure, sacch_bits, sacch_ok = _sacch_fields(sacch, tables)
    facch_mtype, facch_ok = _facch1_fields(facch, tables)  # [..., 2]
    quads = slots.reshape(slots.shape[:-1] + (18, 4))
    voice = ((quads[..., 0] << 6) | (quads[..., 1] << 4)
             | (quads[..., 2] << 2) | quads[..., 3]).to(torch.uint8)

    out = {
        "sync_dist": sync_dist,
        "lich_ok": lich_ok,
        "lich_byte": lich_byte,
        "sacch_structure": sacch_structure,
        "sacch_bits": sacch_bits,
        "sacch_ok": sacch_ok,
    }
    for i in range(2):
        out[f"voice{i}"] = voice[..., i, :]
        out[f"facch_mtype{i}"] = facch_mtype[..., i]
        out[f"facch_ok{i}"] = facch_ok[..., i]
    return out


NxdnPipelineState = PipelineState


class NxdnPipeline(BankPipeline):
    """Device pipeline for NXDN48 channel banks: narrow RRC -> 4FSK at 20
    sps -> dibits + dense sync distances (the same step contract as
    DmrPipeline). One step launches K2 once (K3 with ``use_rrc=False``);
    the frame fields are :func:`nxdn_decode_frames` on frames cut from the
    dibits, as the tracked bank does. ``device=None`` is the card."""

    def __init__(self, channels: int, sps: int | None = None,
                 n_centuries: int = 4, use_rrc: bool = True, device=None):
        super().__init__(NXDN, channels, sps, n_centuries, use_rrc, device)

    def sync_dense(self, dibits: torch.Tensor) -> torch.Tensor:
        return nxdn_sync_correlate(dibits, self.sync)

    def step(self, samples: torch.Tensor, state: NxdnPipelineState):
        """samples [C, L] float32 FM audio. Returns (outputs dict, new
        state)."""
        return self.step_symbols(samples, state)


# the step decodes no frames: the tracked bank cuts and decodes them
NXDN = Protocol(
    name="nxdn", kind="gfsk", sps=20, design=NARROW_RRC, invert=False,
    frame_size=FRAME_SIZE, lookahead=0, sync_offset=0,
    syncs=(Sync("sync_dist_dense", FRAME_SYNC, SYNC_BOUND),),
    decode=nxdn_decode_frames, tables=NxdnTables, pipeline=NxdnPipeline,
    step_decodes=False)
