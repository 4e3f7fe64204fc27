"""ChannelBank: the plain many-channel orchestration (port of
``digiham_tpu/runtime/channel_bank.py``).

Glues the three layers end to end:

  SampleBuffer (host numpy)  ->  device pipeline (one step over
  [channels, block])  ->  per-channel host phase machines (protocol
  decoders with metadata writers)

The device does all O(samples) math; the host consumes the demodulated
symbol block per channel — O(symbols) work — through the same Decoder
objects a single-channel tool uses, so outputs and metadata are
bit-identical to the reference path.
"""
from __future__ import annotations

import pickle
from typing import Callable, Sequence

import numpy as np
import torch

from .. import resolve_device
from .checkpoint import load_state, save_state
from .stream import SampleBuffer, rrc_rebase_history


def bank_device(pipeline, device) -> torch.device:
    """The device a bank over ``pipeline`` works on: ``device`` (``None``
    is the card), which must be where the pipeline's tables live."""
    device = resolve_device(device)
    if pipeline.device.type != device.type:
        raise ValueError(f"pipeline is on {pipeline.device}, the bank on "
                         f"{device}")
    return pipeline.device


class ChannelBank:
    """Drives a device pipeline and a bank of host decoders.

    pipeline: object with ``init_state()`` and
        ``step(samples [C, L], state) -> (outputs, state)`` where
        ``outputs["dibits"]`` is [C, S] and ``state.demod.pos`` holds the
        per-channel consumed positions (``DmrPipeline``-compatible).
    decoders: one protocol Decoder per channel (may be None to skip).
    device: ``None`` is the card; the pipeline must live there.
    """

    def __init__(self, pipeline, decoders: Sequence,
                 on_output: Callable[[int, bytes], None] | None = None,
                 device=None):
        self.device = bank_device(pipeline, device)
        self.pipeline = pipeline
        self.decoders = list(decoders)
        self.channels = pipeline.channels
        assert len(self.decoders) == self.channels
        self.state = pipeline.init_state()
        self.buffer = SampleBuffer(self.channels)
        self.on_output = on_output
        sps = pipeline.sps
        self._need = pipeline.n_centuries * (100 * sps + 1) + 2

    def push(self, samples: np.ndarray) -> list:
        """Feed [C, n] samples; returns list of per-block outputs dicts.

        Decoder payload bytes are routed to ``on_output(channel, data)``.
        """
        if self.buffer is None:
            raise RuntimeError("bank was flushed; create a new bank")
        self.buffer.push(samples)
        results = []
        while True:
            pos = self.state.demod.pos.cpu().numpy()
            need = int(pos.max()) + self._need
            if self.buffer.fill < need:
                break
            block = self.buffer.view(need)
            out, self.state = self.pipeline.step(
                torch.from_numpy(block).to(self.device), self.state)
            dibits = out["dibits"].cpu().numpy()
            for c, dec in enumerate(self.decoders):
                if dec is None:
                    continue
                payload = dec.process(dibits[c])
                if payload and self.on_output is not None:
                    self.on_output(c, payload)
            results.append(out)
            new_pos = self.state.demod.pos.cpu().numpy()
            base = int(new_pos.min())
            if base > 0:
                self._rebase(base, block)
                self.buffer.consume(base)
        return results

    def _rebase(self, base: int, block) -> None:
        demod = self.state.demod
        demod.pos = demod.pos - base  # stays int32 on the device
        rrc = rrc_rebase_history(self.pipeline, self.state, block, base,
                                 stream_start=self.buffer.consumed == 0)
        if rrc is not None:
            self.state.rrc = rrc

    def flush(self) -> None:
        """End-of-stream: decode the buffered sample tail exactly as the
        reference would at EOF (see TrackedChannelBank.flush). Terminal."""
        from .tracked_bank import _flush_demod

        symbols = _flush_demod(self.pipeline, self.state.rrc,
                               self.state.demod,
                               self.buffer.data[:, :self.buffer.fill])
        for c, dec in enumerate(self.decoders):
            if dec is None or not len(symbols[c]):
                continue
            payload = dec.process(symbols[c])
            if payload and self.on_output is not None:
                self.on_output(c, payload)
        self.buffer = None  # further push() fails loudly

    # ------------------------------------------------------------------
    def snapshot(self) -> bytes:
        """Serialize the device carries (as numpy) + sample backlog + every
        decoder's phase-machine state for bit-exact resume via ``restore``.
        Meta writers (user callbacks) are NOT serialized (same contract as
        TrackedChannelBank.snapshot)."""
        writers = []
        for dec in self.decoders:
            mc = getattr(dec, "meta_collector", None)
            writers.append(mc.writer if mc is not None else None)
            if mc is not None:
                mc.writer = None
        try:
            dec_blob = pickle.dumps(self.decoders)
        finally:
            for dec, w in zip(self.decoders, writers):
                mc = getattr(dec, "meta_collector", None)
                if mc is not None:
                    mc.writer = w
        return pickle.dumps({
            "pipeline_state": save_state(self.state),
            "decoders": dec_blob,
            "samples": self.buffer.data[:, :self.buffer.fill].copy(),
        })

    def restore(self, blob: bytes) -> None:
        """Inverse of ``snapshot`` on a bank with the same pipeline
        configuration, on this bank's device whichever device wrote the
        blob; writers attached to this bank's decoders carry over."""
        payload = pickle.loads(blob)
        if payload["samples"].shape[0] != self.channels:
            raise ValueError(
                f"checkpoint has {payload['samples'].shape[0]} channels, "
                f"bank has {self.channels}")
        self.state = load_state(payload["pipeline_state"], self.device)
        prev = self.decoders
        self.decoders = pickle.loads(payload["decoders"])
        for new, old in zip(self.decoders, prev):
            new_mc = getattr(new, "meta_collector", None)
            old_mc = getattr(old, "meta_collector", None)
            if new_mc is not None and old_mc is not None:
                new_mc.writer = old_mc.writer
        self.buffer = SampleBuffer(self.channels)
        if payload["samples"].shape[1]:
            self.buffer.push(payload["samples"])
