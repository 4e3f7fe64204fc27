"""Batched 2FSK pipeline for the bit-stream protocols, D-Star and POCSAG
(port of ``digiham_tpu/pipeline/fsk.py``).

    samples [C, L] -> (optional RRC) -> 2FSK century demod (K3 on the card,
    K2 with an RRC design) -> bits [C, S] + dense sync distances for the
    protocol's patterns

and the batched frame-field decodes the tracked bank runs on the frames it
cuts: :func:`dstar_decode_frames` (96-bit voice frames with a 24-bit
lookahead) and :func:`pocsag_decode_frames` (32-bit codewords). Both are
plain integer tensor code, as in the JAX package, where they run outside
any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import RrcDesign, RrcState
from ..fec.codes import BCH_31_21
from ..fec.lfsr import dstar_scrambler
from ..ops.correlate import sync_correlate
from ..protocols.dstar.phases import (HEADER_SYNC, HEADER_SYNC_BOUND,
                                      TERMINATOR, VOICE_SYNC,
                                      VOICE_SYNC_BOUND)
from ..protocols.pocsag import SYNC_BOUND as POCSAG_SYNC_BOUND
from ..protocols.pocsag import SYNC_PATTERN as POCSAG_SYNC
from ..protocols.pocsag import parse_codewords
from .bank import Protocol, Sync, table


@dataclasses.dataclass(frozen=True)
class FskTables:
    """The constant tables of both frame decodes, as tensors on one
    device."""

    dstar_scrambler: torch.Tensor   # [24] int32 keystream of a data section
    dstar_terminator: torch.Tensor  # [48] int32
    dstar_voice_sync: torch.Tensor  # [24] int32
    pocsag_sync: torch.Tensor       # [32] int32
    syndrome_bch_31_21: torch.Tensor  # [1024] int64

    @classmethod
    def build(cls, device=None) -> "FskTables":
        device = resolve_device(device)
        return cls(
            dstar_scrambler=table(dstar_scrambler()[:24], np.int32, device),
            dstar_terminator=table(TERMINATOR, np.int32, device),
            dstar_voice_sync=table(VOICE_SYNC, np.int32, device),
            pocsag_sync=table(POCSAG_SYNC, np.int32, device),
            syndrome_bch_31_21=BCH_31_21.table(device),
        )


def bit_sync_correlate(bits: torch.Tensor, pattern) -> torch.Tensor:
    """[C, T] bits -> [C, T-len+1] int32 distances to one pattern (a
    numpy array, or a tensor on ``bits.device``)."""
    pattern = torch.as_tensor(pattern, device=bits.device)
    return sync_correlate(bits, pattern[None, :], 2)[..., 0]


@dataclasses.dataclass
class FskPipelineState:
    """The streaming carry: the RRC history (``None`` without an RRC
    stage) and the demod's pos/offset/volume ring."""

    rrc: RrcState | None
    demod: DemodState


class FskPipeline(nn.Module):
    """2FSK front end for a channel bank.

    protocol: ``"dstar"`` (sps 10, header and voice sync correlations) or
    ``"pocsag"`` (sps 40, inverted, preamble correlation); ``sps``
    overrides the protocol's. ``rrc``: an RRC design to filter with (none
    by default: the samples are filtered already). One step launches K3
    once on the card (K2 with an RRC design). The sync patterns, the frame
    decodes' tables and the taps, if any, are registered buffers, so a
    pipeline without an RRC has a device too. ``device=None`` is the
    card.
    """

    def __init__(self, channels: int, protocol: str = "dstar",
                 n_centuries: int = 4, rrc: RrcDesign | None = None,
                 sps: int | None = None, device=None):
        super().__init__()
        if protocol not in PROTOCOLS:
            raise ValueError(protocol)
        device = resolve_device(device)
        self.spec = spec = PROTOCOLS[protocol]
        self.invert = spec.invert
        self.channels = channels
        self.protocol = protocol
        self.sps = spec.sps if sps is None else sps
        self.rrc_design = rrc  # the filter this pipeline applies, or None
        self.use_rrc = rrc is not None
        self.n_centuries = n_centuries
        self.symbols_per_block = n_centuries * 100
        for s in spec.syncs:
            self.register_buffer(_buffer(s), table(s.pattern, np.uint8,
                                                   device))
        if rrc is not None:
            self.register_buffer("rrc_taps", rrc.taps_tensor(device))
        tables = FskTables.build(device)
        for field in dataclasses.fields(FskTables):
            self.register_buffer(field.name, getattr(tables, field.name))

    @property
    def device(self) -> torch.device:
        return self.pocsag_sync.device

    def tables(self) -> FskTables:
        return FskTables(**{f.name: getattr(self, f.name)
                            for f in dataclasses.fields(FskTables)})

    def init_state(self) -> FskPipelineState:
        rrc_state = (RrcState.init(self.channels, self.rrc_design, self.device)
                     if self.use_rrc else None)
        return FskPipelineState(rrc_state,
                                demod_init(self.channels, self.device))

    def step(self, samples: torch.Tensor, state: FskPipelineState):
        """samples [C, L] float32. Returns ({"dibits": bits [C, S] uint8,
        "sync_dist_<name>": [C, S-len+1] int32 per pattern}, new state)."""
        bits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            self.rrc_design, mode="fsk", invert=self.invert,
            taps=self.rrc_taps if self.use_rrc else None)
        outputs = {"dibits": bits}
        for s in self.spec.syncs:
            outputs[s.key] = bit_sync_correlate(bits, getattr(self,
                                                              _buffer(s)))
        return outputs, FskPipelineState(rrc_state, demod_state)

    def step_symbols(self, samples: torch.Tensor, state: FskPipelineState):
        """What TrackedChannelBank steps: the same as :meth:`step` (a 2FSK
        step cuts no frames of its own)."""
        return self.step(samples, state)


def _buffer(sync: Sync) -> str:
    """The buffer of a sync's pattern: ``sync_<name>`` for the output
    ``sync_dist_<name>``."""
    return sync.key.replace("sync_dist_", "sync_")


def _lsb_bytes(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8n] bits -> [..., n] uint8, first bit least significant."""
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
            * weights).sum(
        -1, dtype=torch.int32).to(torch.uint8)


def dstar_decode_frames(frames: torch.Tensor,
                        tables: FskTables | None = None) -> dict:
    """Batched D-Star voice-frame fields for the tracked bank.

    frames: [B, 120] on-air bits — a 96-bit voice frame (72 voice + 24
    slow-data, dstar_phase.cpp:73-90) plus a 24-bit lookahead into the
    next frame for the full-length terminator check
    (dstar_phase.cpp:94-101). Returns per frame: voice bytes [B, 9] uint8
    (LSB-first packed), descrambled slow-data bytes [B, 3] uint8, the
    terminator distances (full 48 and half 24) and the voice-sync distance
    of the data section, int32.
    """
    if tables is None:
        tables = FskTables.build(frames.device)
    b = frames.to(torch.int32) & 1
    data = b[..., 72:96]
    term = tables.dstar_terminator
    return {
        "voice": _lsb_bytes(b[..., :72]),
        "data": _lsb_bytes(data ^ tables.dstar_scrambler),
        "term_full": (b[..., 72:120] ^ term).sum(-1, dtype=torch.int32),
        "term_half": (data ^ term[24:]).sum(-1, dtype=torch.int32),
        "vsync_dist": (data ^ tables.dstar_voice_sync).sum(
            -1, dtype=torch.int32),
    }


def pocsag_decode_frames(frames: torch.Tensor,
                         tables: FskTables | None = None) -> dict:
    """Batched POCSAG codeword fields for the tracked bank.

    frames: [B, 32] bits. Every 32-bit window gets BOTH interpretations
    computed at once — the BCH(31,21)+parity codeword decode
    (codeword.cpp:9-31) and the sync-word distance (pocsag_phase.cpp:38)
    — and the host frame machine picks per its counter state. ``word`` is
    int64 holding the JAX package's unsigned 32-bit word.
    """
    if tables is None:
        tables = FskTables.build(frames.device)
    shifts = torch.arange(31, -1, -1, device=frames.device)
    word = ((frames.to(torch.int64) & 1) << shifts).sum(-1)
    full, ok = parse_codewords(word, tables.syndrome_bch_31_21)
    return {
        "word": full,
        "ok": ok,
        "sync_dist": (frames.to(torch.int32) ^ tables.pocsag_sync).sum(
            -1, dtype=torch.int32),
    }


DSTAR = Protocol(
    name="dstar", kind="fsk", sps=10, design=None, invert=False,
    # 96-bit voice frames, 24 bits of lookahead for the full terminator
    frame_size=96, lookahead=24, sync_offset=0,
    syncs=(Sync("sync_dist_header_sync", HEADER_SYNC, HEADER_SYNC_BOUND),
           Sync("sync_dist_voice_sync", VOICE_SYNC, VOICE_SYNC_BOUND)),
    decode=dstar_decode_frames, tables=FskTables,
    pipeline=functools.partial(FskPipeline, protocol="dstar"),
    step_decodes=False)

# 40 sps = 1200 baud at 48 kS/s; sps= gives 512 or 2400 baud (the
# reference's --samples flag, fsk_demodulator_cli.hpp:16)
POCSAG = Protocol(
    name="pocsag", kind="fsk", sps=40, design=None, invert=True,
    frame_size=32, lookahead=0, sync_offset=0,
    syncs=(Sync("sync_dist_preamble", POCSAG_SYNC, POCSAG_SYNC_BOUND),),
    decode=pocsag_decode_frames, tables=FskTables,
    pipeline=functools.partial(FskPipeline, protocol="pocsag"),
    step_decodes=False)

PROTOCOLS = {p.name: p for p in (DSTAR, POCSAG)}
