"""Batched YSF pipeline for a bank of channels (port of
``digiham_tpu/pipeline/ysf.py``).

    FM audio [C, L] -> K2 (RRC + century demod) -> dibits [C, S]
    -> dense sync correlation [C, S-19]
    -> per 480-dibit frame: FICH (de-interleave, Viterbi K5, 4 x
       Golay(24,12), CRC-16), V/D2 voice (de-interleave, dewhiten, tribit
       majority, AMBE bit mapping), V/D2 DCH (de-interleave, Viterbi K5,
       CRC-16, dewhiten).

Reference behaviour per stage: src/ysf_decoder/fich.cpp,
ysf_phase.cpp:180-219 (voice), 100-108 + 258-267 (DCH). The output dict
keeps the JAX package's keys, shapes and dtypes, with one exception:
``fich_data`` is int64 holding the unsigned 32-bit word (torch's uint32
has no shifts); ``.numpy().astype(np.uint32)`` gives the JAX value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..dsp.rrc import WIDE_RRC
from ..fec import interleave
from ..fec.codes import GOLAY_24_12
from ..fec.crc import crc16_ysf
from ..fec.lfsr import ysf_whitening
from ..fec.linear import decode as fec_decode
from ..fec.viterbi import viterbi_decode, viterbi_decode_many
from ..ops.correlate import sync_correlate
from ..protocols.ysf.constants import (FICH_SIZE, FRAME_SIZE, SYNC_BOUND,
                                       SYNC_SIZE, TRIBIT_MAJORITY,
                                       V2_VOICE_MAPPING, YSF_SYNC)
from .bank import (BankPipeline, PipelineState, Protocol, Sync,
                   bits_from_dibits, table)


@dataclasses.dataclass(frozen=True)
class YsfTables:
    """Every constant table the frame decode reads, as tensors on one
    device."""

    sync: torch.Tensor                  # [20] uint8
    fich_deinterleave: torch.Tensor     # [100] int64
    voice_deinterleave: torch.Tensor    # [104] int64
    dch_deinterleave: torch.Tensor      # [100] int64
    whitening: torch.Tensor             # [104] int32 keystream
    tribit_majority: torch.Tensor       # [8] int32
    voice_mapping: torch.Tensor         # [49] int64
    syndrome_golay_24_12: torch.Tensor  # [4096] int64
    crc16_fich: torch.Tensor            # [32, 16] int32 bit planes
    crc16_dch: torch.Tensor             # [80, 16] int32 bit planes

    @classmethod
    def build(cls, device=None) -> "YsfTables":
        device = resolve_device(device)
        return cls(
            sync=table(YSF_SYNC, np.uint8, device),
            fich_deinterleave=table(interleave.ysf_fich(), np.int64, device),
            voice_deinterleave=table(interleave.ysf_v2_voice(), np.int64,
                                     device),
            dch_deinterleave=table(interleave.ysf_dch_v2(), np.int64, device),
            whitening=table(ysf_whitening()[:104], np.int32, device),
            tribit_majority=table(TRIBIT_MAJORITY, np.int32, device),
            voice_mapping=table(V2_VOICE_MAPPING, np.int64, device),
            syndrome_golay_24_12=GOLAY_24_12.table(device),
            crc16_fich=crc16_ysf(32).planes(device),
            crc16_dch=crc16_ysf(80).planes(device),
        )


def ysf_sync_correlate(dibits: torch.Tensor,
                       sync: torch.Tensor | None = None) -> torch.Tensor:
    """[C, T] dibits -> [C, T-19] int32 distances to the YSF sync word."""
    if sync is None:
        sync = torch.as_tensor(YSF_SYNC, device=dibits.device)
    return sync_correlate(dibits, sync[None, :], 4)[..., 0]


def _pack(bits: torch.Tensor, width: int) -> torch.Tensor:
    """[..., n*width] bits -> [..., n] int64 words, first bit most
    significant."""
    shifts = torch.arange(width - 1, -1, -1, device=bits.device)
    words = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // width,
                                            width)).to(torch.int64)
    return (words << shifts).sum(-1)


def _fich_coded(fich_dibits: torch.Tensor, tables: YsfTables) -> torch.Tensor:
    """[..., 100] FICH dibits -> the de-interleaved dibits the Viterbi
    decoder reads (the frame's own integer type: K5 takes it as it is)."""
    return fich_dibits[..., tables.fich_deinterleave]


def _fich_fields(bits: torch.Tensor, tables: YsfTables):
    """[..., 100] decoded FICH bits -> (fich_word, ok): 4 x Golay(24,12),
    the word, CRC-16."""
    words = _pack(bits[..., :96], 24)  # [..., 4] golay words
    corrected, ok4 = fec_decode(GOLAY_24_12, words,
                                tables.syndrome_golay_24_12)
    # int64: the word's top bit would be int32's sign
    g = corrected.to(torch.int64)
    fich_data = (((g[..., 0] & 0x00FFF000) << 8)
                 | ((g[..., 1] & 0x00FFF000) >> 4)
                 | ((g[..., 2] & 0x00FF0000) >> 16)) & 0xFFFFFFFF
    checksum = (g[..., 2] & 0x0000F000) | ((g[..., 3] & 0x00FFF000) >> 12)
    # CRC over the big-endian byte order of fich_data
    be_bits = (fich_data[..., None]
               >> torch.arange(31, -1, -1, device=bits.device)) & 1
    crc = crc16_ysf(32).compute(be_bits, tables.crc16_fich)
    return fich_data, ok4.all(-1) & (crc == checksum)


def decode_fich_batch(fich_dibits: torch.Tensor,
                      tables: YsfTables | None = None):
    """[..., 100] FICH dibits -> (fich_word [...] int64 holding the
    unsigned 32-bit word, ok [...] bool). Batched over any leading shape
    (channels x frames)."""
    if tables is None:
        tables = YsfTables.build(fich_dibits.device)
    bits, _metric = viterbi_decode(_fich_coded(fich_dibits, tables))
    return _fich_fields(bits, tables)


def decode_vd2_voice_batch(voice_dibits: torch.Tensor,
                           tables: YsfTables | None = None) -> torch.Tensor:
    """[..., 52] V/D2 voice dibits -> [..., 7] packed AMBE bytes (uint8)."""
    if tables is None:
        tables = YsfTables.build(voice_dibits.device)
    bits104 = bits_from_dibits(voice_dibits.to(torch.int32))
    tri = bits104[..., tables.voice_deinterleave] ^ tables.whitening
    groups = tri[..., :81].reshape(tri.shape[:-1] + (27, 3))
    idx = (groups[..., 0] << 2) | (groups[..., 1] << 1) | groups[..., 2]
    voice27 = tables.tribit_majority[idx.to(torch.int64)]
    voice49 = torch.cat([voice27, tri[..., 81:103]], dim=-1)
    # voice bit i goes to output bit voice_mapping[i] (no index repeats)
    result = torch.zeros(voice49.shape[:-1] + (56,), dtype=torch.int32,
                         device=voice49.device)
    result[..., tables.voice_mapping] = voice49
    return _pack(result, 8).to(torch.uint8)


def _dch_coded(payload: torch.Tensor, tables: YsfTables) -> torch.Tensor:
    """[..., 360] payload dibits -> the [..., 100] de-interleaved DCH
    dibits the Viterbi decoder reads."""
    return payload[..., tables.dch_deinterleave]


def _dch_fields(bits: torch.Tensor, tables: YsfTables):
    """[..., 100] decoded DCH bits -> (dch bytes [..., 10] uint8, ok): CRC
    over the whitened bits, dewhiten."""
    by = _pack(bits[..., :96], 8)
    checksum = (by[..., 10] << 8) | by[..., 11]
    crc = crc16_ysf(80).compute(bits[..., :80], tables.crc16_dch)
    clear = bits ^ tables.whitening[:100]
    return _pack(clear[..., :80], 8).to(torch.uint8), crc == checksum


def decode_vd2_dch_batch(payload: torch.Tensor,
                         tables: YsfTables | None = None):
    """[..., 360] payload dibits -> (dch bytes [..., 10] uint8, ok).
    The V/D2 data channel (ysf_phase.cpp:100-108 + 258-267):
    de-interleave, Viterbi, CRC over the whitened bits, dewhiten."""
    if tables is None:
        tables = YsfTables.build(payload.device)
    bits, _ = viterbi_decode(_dch_coded(payload, tables))  # [..., 100]
    return _dch_fields(bits, tables)


def ysf_decode_frames(frames: torch.Tensor, tables: YsfTables | None = None):
    """[..., 480] frame dibits -> field dict: sync distance, FICH word/ok,
    V/D2 voice bytes for all 5 blocks, V/D2 DCH bytes/ok. FICH and DCH are
    decoded in one launch of K5 on the card."""
    if tables is None:
        tables = YsfTables.build(frames.device)
    d = frames.to(torch.int32)
    x = d[..., :SYNC_SIZE] ^ tables.sync.to(torch.int32)
    sync_dist = ((x & 1) + (x >> 1)).sum(-1, dtype=torch.int32)
    payload = d[..., SYNC_SIZE + FICH_SIZE:FRAME_SIZE]
    # the decoder reads the frames' own dibits (uint8 from the demodulator)
    (fich_bits, _), (dch_bits, _) = viterbi_decode_many([
        (_fich_coded(frames[..., SYNC_SIZE:SYNC_SIZE + FICH_SIZE], tables),
         0),
        (_dch_coded(frames[..., SYNC_SIZE + FICH_SIZE:FRAME_SIZE], tables),
         0)])
    fich_data, fich_ok = _fich_fields(fich_bits, tables)
    blocks = torch.stack(
        [payload[..., 20 + i * 72:20 + i * 72 + 52] for i in range(5)],
        dim=-2)  # [..., 5, 52]
    voice = decode_vd2_voice_batch(blocks, tables)
    dch, dch_ok = _dch_fields(dch_bits, tables)
    return {
        "sync_dist": sync_dist,
        "fich_data": fich_data,
        "fich_ok": fich_ok,
        "vd2_voice": voice,
        "vd2_dch": dch,
        "vd2_dch_ok": dch_ok,
    }


YsfPipelineState = PipelineState


class YsfPipeline(BankPipeline):
    """Device pipeline for YSF channel banks: samples -> dibits -> dense
    sync distances + per-480-frame FICH/voice/DCH fields (the same step
    contract as DmrPipeline). One step launches K2 once (K3 with
    ``use_rrc=False``) and K5 once (FICH and DCH of every frame in one
    launch). ``device=None`` is the card."""

    def __init__(self, channels: int, sps: int | None = None,
                 n_centuries: int = 10, use_rrc: bool = True, device=None):
        super().__init__(YSF, channels, sps, n_centuries, use_rrc, device)

    def sync_dense(self, dibits: torch.Tensor) -> torch.Tensor:
        return ysf_sync_correlate(dibits, self.sync)

    def step(self, samples: torch.Tensor, state: YsfPipelineState):
        """samples [C, L] float32 FM audio. Returns (outputs dict, new
        state)."""
        outputs, new_state = self.step_symbols(samples, state)
        dibits = outputs["dibits"]
        if self.symbols_per_block >= FRAME_SIZE:
            outputs.update(ysf_decode_frames(
                self._frames(dibits, FRAME_SIZE), self.tables()))
        return outputs, new_state


YSF = Protocol(
    name="ysf", kind="gfsk", sps=10, design=WIDE_RRC, invert=False,
    frame_size=FRAME_SIZE, lookahead=0, sync_offset=0,
    syncs=(Sync("sync_dist_dense", YSF_SYNC, SYNC_BOUND),),
    decode=ysf_decode_frames, tables=YsfTables, pipeline=YsfPipeline,
    step_decodes=True)
