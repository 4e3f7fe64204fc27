"""What every protocol is, as data (:class:`Protocol`, one record a
protocol, defined beside its frame decode), and what the three 4FSK bank
pipelines (DMR, YSF, NXDN) share: the streaming state, the constant tables
held as module buffers, and the FM-audio front (RRC + century demod,
kernel K2 or K3 on the card)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..dsp.demod import (DemodState, FskDemodNp, GfskDemodNp, demod_init,
                         rrc_demod_block)
from ..dsp.rrc import RrcDesign, RrcState
from ..ops.correlate import sync_correlate


@dataclasses.dataclass(frozen=True, eq=False)
class Sync:
    """One dense sync-distance output of a protocol's step: its output
    ``key``, its ``pattern`` ([n] symbols, or [k, n]: k patterns, one
    distance each) and its gate ``bound``. A hit is a distance <= bound:
    the host hunt's rule, on which the tracked bank's fast skip gates."""

    key: str
    pattern: np.ndarray
    bound: int

    @property
    def length(self) -> int:
        return self.pattern.shape[-1]


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Protocol:
    """Every fact of one protocol that more than one layer reads: the
    pipelines take their defaults from it, the tracked bank's adapters
    their frame geometry, gate and decode, the flush its host oracle, and
    the serving, sharded, bench and soak paths what they build. It holds
    no tensor: each pipeline builds its tables on its device.

    ``decode`` is the batched frame decode, (frames [N, frame_size +
    lookahead], tables) -> fields; ``pipeline`` builds the bank pipeline,
    (channels, **options); ``step_decodes``: the pipeline's ``step`` (and
    the time-sharded step) decodes the block's aligned frames."""

    name: str
    kind: str                 # "gfsk": 4FSK dibits; "fsk": 2FSK bits
    sps: int                  # samples a symbol, the pipeline's default
    design: RrcDesign | None  # the RRC its pipeline applies (None: none)
    invert: bool              # the 2FSK slicer's sign
    frame_size: int           # symbols a frame the tracked bank cuts
    lookahead: int            # symbols past a frame's end its fields read
    sync_offset: int          # symbols into a frame its sync window begins
    syncs: tuple[Sync, ...]   # the step's dense sync outputs
    decode: Callable
    tables: type              # the decode's tables (``build(device)``)
    pipeline: Callable
    step_decodes: bool

    def __repr__(self) -> str:
        return f"Protocol({self.name!r})"

    @property
    def sync_len(self) -> int:
        """Symbols of the longest sync window."""
        return max(s.length for s in self.syncs)

    @property
    def host_demod(self) -> type:
        """The per-symbol host oracle that demodulates a flush's tail."""
        return FskDemodNp if self.kind == "fsk" else GfskDemodNp

    def correlate(self, symbols: torch.Tensor,
                  pattern: torch.Tensor) -> torch.Tensor:
        """[C, T] symbols -> dense distances to one sync's ``pattern`` (a
        tensor on their device): [C, T-n+1] int32, or [C, T-n+1, k] for
        k patterns."""
        levels = 4 if self.kind == "gfsk" else 2
        if pattern.dim() == 1:
            return sync_correlate(symbols, pattern[None, :], levels)[..., 0]
        return sync_correlate(symbols, pattern, levels)


@dataclasses.dataclass
class PipelineState:
    """The streaming carry of a bank pipeline, the same for all three
    protocols: the RRC history and the demod's pos/offset/volume ring."""

    rrc: RrcState
    demod: DemodState


class BankPipeline(nn.Module):
    """Base of the bank pipelines over ``spec``, the protocol's record:
    its sps unless ``sps`` is given, its RRC design, and its decode's
    tables, whose fields and the RRC taps become registered buffers, so
    ``.to(device)`` moves them and no step copies a table from the host.
    ``device=None`` is the card."""

    def __init__(self, spec: Protocol, channels: int, sps: int | None,
                 n_centuries: int, use_rrc: bool, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.channels = channels
        self.sps = spec.sps if sps is None else sps
        self.n_centuries = n_centuries
        self.use_rrc = use_rrc  # False = input is already RRC-filtered
        self.design = spec.design  # the protocol's RRC, applied or not
        # the filter this pipeline applies, exposed as data so a caller that
        # chains blocks never dispatches on the class name
        self.rrc_design = spec.design if use_rrc else None
        self.symbols_per_block = n_centuries * 100
        self._tables_type = spec.tables
        self.register_buffer("rrc_taps", spec.design.taps_tensor(device))
        tables = spec.tables.build(device)
        for field in dataclasses.fields(spec.tables):
            self.register_buffer(field.name, getattr(tables, field.name))

    @property
    def device(self) -> torch.device:
        return self.rrc_taps.device

    def tables(self):
        return self._tables_type(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self._tables_type)})

    def init_state(self) -> PipelineState:
        return PipelineState(
            rrc=RrcState.init(self.channels, self.design, self.device),
            demod=demod_init(self.channels, self.device),
        )

    def sync_dense(self, dibits: torch.Tensor) -> torch.Tensor:
        """The block's dense sync distances (the protocol's own
        correlation)."""
        raise NotImplementedError

    def step_symbols(self, samples: torch.Tensor, state: PipelineState):
        """The front and the dense sync correlation of one step, without
        the frame fields of the block's aligned frames: (outputs with
        ``dibits`` and ``sync_dist_dense``, new state). This is what
        TrackedChannelBank reads of a step; it cuts and decodes its own
        frames."""
        dibits, new_state = self._demod(samples, state)
        return ({"dibits": dibits, "sync_dist_dense": self.sync_dense(dibits)},
                new_state)

    def _demod(self, samples: torch.Tensor, state: PipelineState):
        """FM audio (or, with ``use_rrc=False``, filtered samples) [C, L]
        -> (dibits [C, symbols_per_block] uint8, new state)."""
        dibits, rrc_state, demod_state = rrc_demod_block(
            samples, state.rrc, state.demod, self.n_centuries, self.sps,
            self.rrc_design, taps=self.rrc_taps if self.use_rrc else None)
        return dibits, PipelineState(rrc_state, demod_state)

    def _frames(self, dibits: torch.Tensor, frame_size: int) -> torch.Tensor:
        """The block's aligned frames: [C, n_frames, frame_size]."""
        n_frames = self.symbols_per_block // frame_size
        return dibits[:, :n_frames * frame_size].reshape(
            self.channels, n_frames, frame_size)


def bits_from_dibits(d: torch.Tensor) -> torch.Tensor:
    """[..., n] dibits -> [..., 2n] bits, high bit first."""
    return torch.stack([(d >> 1) & 1, d & 1], dim=-1).flatten(-2)


def table(array, dtype, device) -> torch.Tensor:
    """A constant numpy table as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(np.asarray(array, dtype=dtype), device=device)
