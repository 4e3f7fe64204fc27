"""Host-side stream driving: sample buffering and block dispatch.

The reference's runtime is a per-process ring buffer + fread loop
(src/lib/cli.cpp:19-38,102-106). The many-channel equivalent (port of
``digiham_tpu/runtime/stream.py``) inverts control: a host
``StreamDriver`` accumulates incoming samples per channel in a
``SampleBuffer``, and whenever every channel has enough lookahead it
dispatches one ``[channels, block]`` device call, then rebases the
per-channel read positions (the demodulator may consume ±1 sample per 100
symbols, so consumed lengths differ across channels).

The device sees whole blocks; all variable-rate bookkeeping lives here, in
O(channels) numpy ops. The sample store is host numpy; each dispatched
block is copied to the device once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..dsp.rrc import RrcState
from .metrics import TRACER


def rrc_rebase_history(pipeline, state, block: np.ndarray, base: int,
                       stream_start: bool = True):
    """Return ``state.rrc`` realigned for a buffer rebase of ``base``.

    A pipeline ``step`` returns the RRC delay line as of the *end* of the
    block it filtered, but the banks consume only ``base < len(block)``
    samples — the next block starts mid-way through the previous one, so
    the correct delay line is the ``ntaps-1`` raw input samples
    immediately *before* the new origin (rrc_filter.cpp:25-31 shifts raw
    inputs). The history is plain input data, so the host rewrites it
    from the pre-consume block view. Returns None when the pipeline runs
    no RRC stage (then the carried value is inert).

    ``stream_start``: True iff ``block[:, 0]`` is the very first stream
    sample (no samples were ever consumed before this block). Only then
    may a short prefix (base < ntaps-1) be zero-padded — mid-stream, the
    missing left context is real prior data this view no longer holds,
    and padding would silently corrupt the filter. Current callers rebase
    by ~n_centuries*1000 >= ntaps-1, so the guard is unreachable; it
    exists to fail loudly if a future caller consumes less.
    """
    rrc_state = getattr(state, "rrc", None)
    if rrc_state is None or not pipeline.use_rrc:
        return None
    nt1 = rrc_state.history.shape[-1]
    hist = np.asarray(block[:, max(0, base - nt1):base], np.float32)
    if hist.shape[1] < nt1:  # stream younger than the delay line: zero-pad
        if not stream_start:
            raise ValueError(
                f"mid-stream rebase of {base} < ntaps-1 = {nt1} samples: "
                "the RRC left context is no longer in this block view")
        pad = np.zeros((hist.shape[0], nt1 - hist.shape[1]), np.float32)
        hist = np.concatenate([pad, hist], axis=1)
    # torch.tensor copies: the block is a view of a buffer that shifts
    return RrcState(torch.tensor(hist, device=rrc_state.history.device))


class SampleBuffer:
    """Grow-on-write, shift-on-consume [channels, cap] sample store.

    Keeps per-channel write fill and a shared base origin. ``positions``
    (device-owned read cursors) are relative to the base; when the minimum
    position grows past ``trim_quantum`` the buffer shifts left and reports
    the rebase amount.
    """

    def __init__(self, channels: int, dtype=np.float32,
                 initial_cap: int = 1 << 16):
        self.channels = channels
        self.dtype = dtype
        self.data = np.zeros((channels, initial_cap), dtype)
        self.fill = 0  # same fill for all channels (lockstep ingest)
        self.consumed = 0  # lifetime samples discarded (stream-start test)

    def push(self, samples: np.ndarray) -> None:
        """samples: [channels, n] appended at the write position."""
        samples = np.asarray(samples, self.dtype)
        if samples.ndim == 1:
            samples = np.broadcast_to(samples, (self.channels, len(samples)))
        n = samples.shape[1]
        if self.fill + n > self.data.shape[1]:
            new_cap = max(self.data.shape[1] * 2, self.fill + n)
            grown = np.zeros((self.channels, new_cap), self.dtype)
            grown[:, :self.fill] = self.data[:, :self.fill]
            self.data = grown
        self.data[:, self.fill:self.fill + n] = samples
        self.fill += n

    def view(self, length: int) -> np.ndarray:
        """First ``length`` buffered samples (zero-padded if short)."""
        if length <= self.data.shape[1]:
            return self.data[:, :length]
        out = np.zeros((self.channels, length), self.dtype)
        out[:, :self.fill] = self.data[:, :self.fill]
        return out

    def consume(self, n: int) -> None:
        """Discard the first n samples (rebase origin by n)."""
        if n <= 0:
            return
        self.data[:, :self.fill - n] = self.data[:, n:self.fill]
        self.fill -= n
        self.consumed += n


class StreamDriver:
    """Drives a century-blocked demodulator over a SampleBuffer.

    demod_fn(block [C, L] tensor, state, n_centuries) -> (symbols, state)
    where state (a ``DemodState``) carries per-channel ``pos`` relative to
    the block origin. Blocks go to ``device`` (``None`` is the card), where
    ``state`` must live.
    """

    def __init__(self, channels: int, sps: int, demod_fn, state,
                 n_centuries: int = 1, device=None):
        self.device = resolve_device(device)
        if state.pos.device.type != self.device.type:
            raise ValueError(f"state is on {state.pos.device}, the "
                             f"StreamDriver on {self.device}")
        self.channels = channels
        self.sps = sps
        self.demod_fn = demod_fn
        self.state = state
        self.n_centuries = n_centuries
        self.buffer = SampleBuffer(channels)

    @property
    def _need(self) -> int:
        # worst case: max(pos) + centuries*(100*sps + 1 slack) + lookahead
        return self.n_centuries * (100 * self.sps + 1) + 1

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        """Feed samples; returns list of [C, n_centuries*100] symbol blocks
        produced (possibly several if a large chunk arrived)."""
        self.buffer.push(samples)
        out = []
        while True:
            pos = self.state.pos.cpu().numpy()
            need = int(pos.max()) + self._need
            if self.buffer.fill < need:
                break
            block = self.buffer.view(need)
            with TRACER.span("stream.step", step=True):
                symbols, self.state = self.demod_fn(
                    torch.from_numpy(block).to(self.device), self.state,
                    self.n_centuries)
                out.append(symbols.cpu().numpy())
                TRACER.stepped(
                    self.channels * self.n_centuries * 100 * self.sps)
            # rebase: drop samples every channel has consumed
            new_pos = self.state.pos.cpu().numpy()
            base = int(new_pos.min())
            if base > 0:
                self.buffer.consume(base)
                self.state = type(self.state)(
                    self.state.pos - base, self.state.offset,
                    self.state.volume_ring)
        return out
