"""Batched DMR pipeline for a bank of channels (port of
``digiham_tpu/pipeline/dmr.py``).

    I/Q planes [C, L] -> K1 (FM + RRC + century demod)  -> dibits [C, S]
    FM audio [C, L]   -> K2 (RRC + century demod)       -> dibits [C, S]
    -> dense sync correlation [C, S-23, 4]
    -> per 144-dibit frame: CACH/TACT Hamming(7,4), sync classify,
       SlotType Golay(20,8), BPTC(196,96), EMB QR(16,7), voice payload.

The output dict keeps the JAX package's keys, dtypes and shapes. The
filter taps, syndrome tables, BPTC gather indices and sync patterns are
registered buffers of :class:`DmrPipeline`, so ``.to(device)`` moves them
and no step copies a table from the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..dsp.demod import fm_rrc_demod_block
from ..dsp.fm import fm_discriminator
from ..dsp.rrc import WIDE_RRC
from ..fec import bptc
from ..fec.codes import (GOLAY_20_8, HAMMING_7_4, HAMMING_13_9,
                         HAMMING_15_11, QR_16_7)
from ..fec.linear import decode as fec_decode, popcount
from ..ops.correlate import sync_correlate
from .bank import (BankPipeline, PipelineState, Protocol, Sync,
                   bits_from_dibits, table)
from ..protocols.dmr.constants import (BS_DATA_SYNC, BS_VOICE_SYNC,
                                       CACH_SIZE, FRAME_SIZE, MS_DATA_SYNC,
                                       MS_VOICE_SYNC, SYNC_BOUND, SYNC_OFFSET,
                                       SYNC_SIZE, TACT_POSITIONS)

SYNC_PATTERNS = np.stack(
    [BS_DATA_SYNC, BS_VOICE_SYNC, MS_DATA_SYNC, MS_VOICE_SYNC])
# sync type per pattern row: data=1, voice=2 (dmr_phase.cpp:18-33)
SYNC_TYPES = np.array([1, 2, 1, 2], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class DmrTables:
    """Every constant table the frame decode reads, as tensors on one
    device."""

    sync_patterns: torch.Tensor  # [4, 24] uint8
    sync_types: torch.Tensor     # [4] int32
    tact_positions: torch.Tensor  # [7] int64
    bptc_columns: torch.Tensor   # [15, 13] int64
    syndrome_hamming_7_4: torch.Tensor
    syndrome_hamming_13_9: torch.Tensor
    syndrome_hamming_15_11: torch.Tensor
    syndrome_golay_20_8: torch.Tensor
    syndrome_qr_16_7: torch.Tensor

    @classmethod
    def build(cls, device=None) -> "DmrTables":
        device = resolve_device(device)
        return cls(
            sync_patterns=table(SYNC_PATTERNS, np.uint8, device),
            sync_types=table(SYNC_TYPES, np.int32, device),
            tact_positions=table(TACT_POSITIONS, np.int64, device),
            bptc_columns=table(bptc.column_source(), np.int64, device),
            **{f"syndrome_{c.name}": c.table(device)
               for c in (HAMMING_7_4, HAMMING_13_9, HAMMING_15_11,
                         GOLAY_20_8, QR_16_7)},
        )


def dmr_sync_correlate(dibits: torch.Tensor,
                       patterns: torch.Tensor | None = None) -> torch.Tensor:
    """Dense sync correlation: [C, T] dibits -> [C, T-23, 4] int32
    distances to the four sync patterns at every offset."""
    if patterns is None:
        patterns = torch.as_tensor(SYNC_PATTERNS, device=dibits.device)
    return sync_correlate(dibits, patterns, 4)


def _pack_dibits(dibits: torch.Tensor) -> torch.Tensor:
    """[..., 4n] dibits -> [..., n] bytes, MSB first (dmr_phase.cpp:216)."""
    q = dibits.reshape(dibits.shape[:-1] + (dibits.shape[-1] // 4, 4))
    return ((q[..., 0] << 6) | (q[..., 1] << 4) | (q[..., 2] << 2)
            | q[..., 3]).to(torch.uint8)


def _dibit_word(dibits: torch.Tensor) -> torch.Tensor:
    """[..., n] dibits -> int64 word, first dibit most significant."""
    n = dibits.shape[-1]
    shifts = torch.arange(2 * (n - 1), -1, -2, device=dibits.device)
    return (dibits.to(torch.int64) << shifts).sum(-1)


def dmr_decode_frames(frames: torch.Tensor, tables: DmrTables | None = None):
    """Decode a batch of aligned frames: [..., 144] dibits -> field dict
    with leading shape [...] (the JAX package's keys and dtypes):
      tact_ok, tact_slot, tact_busy, tact_lcss   — CACH/TACT
      sync_dist [4], sync_type                   — mid-frame sync classify
      emb_ok, emb_lcss, emb_cc, emb_fragment[4]  — voice superframe EMB
      voice_payload [27] uint8                   — packed voice bytes
      slot_type_ok, color_code, data_type        — SlotType golay
      bptc_data [96], bptc_ok                    — data-frame BPTC bits
    """
    if tables is None:
        tables = DmrTables.build(frames.device)
    d = frames.to(torch.int32)

    # --- CACH / TACT (cach.cpp:11-32, tact.cpp:9-12)
    tact_bits = bits_from_dibits(
        d[..., :CACH_SIZE])[..., tables.tact_positions]
    tact_word = (tact_bits.to(torch.int64)
                 << torch.arange(6, -1, -1, device=d.device)).sum(-1)
    tact_corr, tact_ok = fec_decode(HAMMING_7_4, tact_word,
                                    tables.syndrome_hamming_7_4)
    tact_slot = (tact_corr >> 5) & 1
    tact_busy = (tact_corr >> 6) & 1
    tact_lcss = (tact_corr >> 3) & 3

    # --- sync classification (dmr_phase.cpp:18-33): first match wins
    sync = d[..., SYNC_OFFSET:SYNC_OFFSET + SYNC_SIZE]
    x = (sync[..., None, :] ^ tables.sync_patterns.to(torch.int32)).to(
        torch.int64)
    sync_dist = popcount(x).sum(-1).to(torch.int32)  # [..., 4]
    match = sync_dist <= 3
    first = match.to(torch.int32).argmax(-1)
    sync_type = torch.where(match.any(-1), tables.sync_types[first], -1)

    # --- EMB + embedded fragment (dmr_phase.cpp:117-155)
    emb_word = _dibit_word(torch.cat(
        [d[..., SYNC_OFFSET:SYNC_OFFSET + 4],
         d[..., SYNC_OFFSET + 20:SYNC_OFFSET + 24]], dim=-1))
    emb_corr, emb_ok = fec_decode(QR_16_7, emb_word,
                                  tables.syndrome_qr_16_7)
    emb_cc = (emb_corr >> 12) & 0b1111
    emb_lcss = (emb_corr >> 9) & 0b11
    emb_fragment = _pack_dibits(d[..., SYNC_OFFSET + 4:SYNC_OFFSET + 20])

    # --- voice payload (dmr_phase.cpp:210-227)
    voice_payload = _pack_dibits(torch.cat(
        [d[..., CACH_SIZE:CACH_SIZE + 54],
         d[..., CACH_SIZE + 54 + SYNC_SIZE:]], dim=-1))

    # --- SlotType (dmr_phase.cpp:235-252)
    st_word = _dibit_word(torch.cat(
        [d[..., SYNC_OFFSET - 5:SYNC_OFFSET],
         d[..., SYNC_OFFSET + SYNC_SIZE:SYNC_OFFSET + SYNC_SIZE + 5]],
        dim=-1))
    st_corr, st_ok = fec_decode(GOLAY_20_8, st_word,
                                tables.syndrome_golay_20_8)
    color_code = (st_corr >> 16) & 0b1111
    data_type = (st_corr >> 12) & 0b1111

    # --- BPTC(196,96) (dmr_phase.cpp:253-270)
    bits196 = bits_from_dibits(torch.cat(
        [d[..., CACH_SIZE:CACH_SIZE + 49],
         d[..., CACH_SIZE + 54 + SYNC_SIZE + 5:
           CACH_SIZE + 54 + SYNC_SIZE + 5 + 49]], dim=-1))
    bptc_data, bptc_ok = bptc.decode(
        bits196, tables.bptc_columns, tables.syndrome_hamming_13_9,
        tables.syndrome_hamming_15_11)

    return {
        "tact_ok": tact_ok, "tact_slot": tact_slot,
        "tact_busy": tact_busy, "tact_lcss": tact_lcss,
        "sync_dist": sync_dist, "sync_type": sync_type,
        "emb_ok": emb_ok, "emb_cc": emb_cc, "emb_lcss": emb_lcss,
        "emb_fragment": emb_fragment,
        "voice_payload": voice_payload,
        "slot_type_ok": st_ok, "color_code": color_code,
        "data_type": data_type,
        "bptc_data": bptc_data, "bptc_ok": bptc_ok,
    }


DmrPipelineState = PipelineState


class DmrPipeline(BankPipeline):
    """Device pipeline: raw I/Q (or FM audio) -> decoded DMR frame fields
    for a bank of channels.

    One step consumes ``n_centuries*100`` symbols of samples per channel
    and decodes every 144-aligned frame of the block.
    :meth:`step_iq_planes` runs kernel K1 on the card, :meth:`step` kernel
    K2 (K3 with ``use_rrc=False``). ``device=None`` is the card.
    """

    def __init__(self, channels: int, sps: int | None = None,
                 n_centuries: int = 8, use_rrc: bool = True, device=None):
        super().__init__(DMR, channels, sps, n_centuries, use_rrc, device)

    def step_iq(self, iq: torch.Tensor, last_iq: torch.Tensor,
                state: DmrPipelineState):
        """Complex ingest: [C, L] complex64 -> planes -> :meth:`step_iq_planes`
        (the split is one copy; ingest that has planes should call
        step_iq_planes). last_iq: [C] complex64 carry.
        Returns (outputs, new_iq_carry, new state)."""
        out, (lre, lim), new_state = self.step_iq_planes(
            iq.real.contiguous(), iq.imag.contiguous(),
            last_iq.real.contiguous(), last_iq.imag.contiguous(), state)
        return out, torch.complex(lre, lim), new_state

    def step_iq_planes(self, re: torch.Tensor, im: torch.Tensor,
                       last_re: torch.Tensor, last_im: torch.Tensor,
                       state: DmrPipelineState):
        """Planar raw-IQ ingest: [C, L] float32 I and Q planes, [C] carries.
        FM discriminator, RRC and century demod run as one fused call
        (kernel K1 on the card). L >= max(pos) + n_centuries*(100*sps+1)+1.
        Returns (outputs, (new_last_re, new_last_im), new state)."""
        if not self.use_rrc:
            audio, carry = fm_discriminator(re, im, last_re, last_im)
            out, new_state = self.step(audio * 5000.0, state)
            return out, carry, new_state
        dibits, rrc_state, demod_state, carry = fm_rrc_demod_block(
            re, im, last_re, last_im, state.rrc, state.demod,
            self.n_centuries, self.sps, self.design, fm_scale=5000.0,
            taps=self.rrc_taps)
        return (self._post(dibits), carry,
                DmrPipelineState(rrc_state, demod_state))

    def step(self, samples: torch.Tensor, state: DmrPipelineState):
        """FM audio ingest: samples [C, L] float32 (filtered already when
        ``use_rrc=False``). RRC and century demod run as one fused call
        (kernel K2 on the card; K3 without the filter).
        Returns (outputs dict, new state)."""
        dibits, new_state = self._demod(samples, state)
        return self._post(dibits), new_state

    def sync_dense(self, dibits: torch.Tensor) -> torch.Tensor:
        return dmr_sync_correlate(dibits, self.sync_patterns)

    def _post(self, dibits):
        """Symbol-domain tail shared by every ingest variant: dense sync
        correlation + batched per-frame field decode."""
        fields = dmr_decode_frames(self._frames(dibits, FRAME_SIZE),
                                   self.tables())
        return {"dibits": dibits, "sync_dist_dense": self.sync_dense(dibits),
                **fields}


DMR = Protocol(
    name="dmr", kind="gfsk", sps=10, design=WIDE_RRC, invert=False,
    frame_size=FRAME_SIZE, lookahead=0, sync_offset=SYNC_OFFSET,
    syncs=(Sync("sync_dist_dense", SYNC_PATTERNS, SYNC_BOUND),),
    decode=dmr_decode_frames, tables=DmrTables, pipeline=DmrPipeline,
    step_decodes=True)
