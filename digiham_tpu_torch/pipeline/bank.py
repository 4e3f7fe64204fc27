"""What the three 4FSK bank pipelines (DMR, YSF, NXDN) share: the
streaming state, the constant tables held as module buffers, and the
FM-audio front (RRC + century demod, kernel K2 or K3 on the card)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..dsp.demod import DemodState, demod_init, rrc_demod_block
from ..dsp.rrc import RrcDesign, RrcState


@dataclasses.dataclass
class PipelineState:
    """The streaming carry of a bank pipeline, the same for all three
    protocols: the RRC history and the demod's pos/offset/volume ring."""

    rrc: RrcState
    demod: DemodState


class BankPipeline(nn.Module):
    """Base of the bank pipelines. ``tables_type`` is a dataclass of
    tensors with a ``build(device)`` classmethod; its fields and the RRC
    taps become registered buffers, so ``.to(device)`` moves them and no
    step copies a table from the host. ``device=None`` is the card."""

    def __init__(self, channels: int, sps: int, n_centuries: int,
                 use_rrc: bool, design: RrcDesign, tables_type, device=None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.sps = sps
        self.n_centuries = n_centuries
        self.use_rrc = use_rrc  # False = input is already RRC-filtered
        self.design = design  # the protocol's RRC, applied or not
        # the filter this pipeline applies, exposed as data so a caller that
        # chains blocks never dispatches on the class name
        self.rrc_design = design if use_rrc else None
        self.symbols_per_block = n_centuries * 100
        self._tables_type = tables_type
        self.register_buffer("rrc_taps", design.taps_tensor(device))
        tables = tables_type.build(device)
        for field in dataclasses.fields(tables_type):
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
