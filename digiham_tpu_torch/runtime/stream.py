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
O(channels) ops. Two stores hold the pending samples:

- ``SampleBuffer``, host numpy, for ``StreamDriver``, ``ChannelBank`` and
  the time-sharded bank (``TimeShardedPipeline.drive`` reads its halos):
  each dispatched block is copied to the device once.
- ``DeviceSampleStore``, the ``TrackedChannelBank``'s, on the bank's
  devices: a push is copied once into pinned staging and uploaded
  asynchronously, a step's block is a view of the store, and the RRC
  rebase and the consume stay on the device.
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
    inputs). The history is plain input data, so it is rewritten from the
    pre-consume block view: a numpy block on the host, then uploaded; a
    tensor block (a view of a ``DeviceSampleStore``) copied on its device.
    Returns None when the pipeline runs no RRC stage (then the carried
    value is inert).

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
    lo = max(0, base - nt1)
    short = nt1 - (base - lo)  # stream younger than the delay line
    if short and not stream_start:
        raise ValueError(
            f"mid-stream rebase of {base} < ntaps-1 = {nt1} samples: "
            "the RRC left context is no longer in this block view")
    if isinstance(block, torch.Tensor):
        # a new tensor: the block is a view of a store that moves on
        hist = block.new_zeros((block.shape[0], nt1))
        hist[:, short:] = block[:, lo:base]
        return RrcState(hist)
    hist = np.asarray(block[:, lo:base], np.float32)
    if short:  # zero-pad
        pad = np.zeros((hist.shape[0], short), np.float32)
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


def _cpu_tensor(src: np.ndarray) -> torch.Tensor:
    """``src`` as a CPU tensor over its memory, for one ``copy_`` on
    torch's threads (a busy NXDN block into pinned staging on the card's
    8-core host: 0.38 ms, against 2.18 for ``np.copyto``); what torch does
    not wrap (read-only, negative strides, a dtype it lacks) as a float32
    copy."""
    if src.flags.writeable and all(s >= 0 for s in src.strides):
        try:
            return torch.from_numpy(src)
        except TypeError:  # a dtype torch lacks
            pass
    return torch.from_numpy(np.array(src, np.float32))


class _StoreRows:
    """One row range of a ``DeviceSampleStore``: its [rows, cap] float32
    store on its device and, on the card, two pinned staging slots, each
    with the event recorded after its upload."""

    __slots__ = ("lo", "hi", "data", "stage", "events", "slot")

    def __init__(self, lo: int, hi: int, device, cap: int):
        self.lo, self.hi = lo, hi
        self.data = torch.empty((hi - lo, cap), dtype=torch.float32,
                                device=device)
        on_card = self.data.device.type == "cuda"
        self.stage = [None, None] if on_card else None
        self.events = ([torch.cuda.Event(), torch.cuda.Event()] if on_card
                       else None)
        self.slot = 0

    def write(self, src: np.ndarray, at: int) -> None:
        """``src`` ([rows, n] or [n] broadcast to every row, any strides
        and dtype, cast to float32) into store columns [at, at + n): on
        the CPU one copy in place; on the card one copy into the next
        staging slot, waiting first for that slot's previous upload, then
        one asynchronous upload on the current stream."""
        T = TRACER
        T.counts.uploads += 1
        dst = self.data[:, at:at + src.shape[-1]]
        if self.stage is None:
            dst.copy_(_cpu_tensor(src))
            return
        i = self.slot
        self.slot ^= 1
        event = self.events[i]
        if not event.query():
            T.counts.upload_waits += 1
            event.synchronize()
        size = dst.numel()
        if self.stage[i] is None or self.stage[i].numel() < size:
            self.stage[i] = torch.empty(size, dtype=torch.float32,
                                        pin_memory=True)
        stage = self.stage[i][:size].view(dst.shape)
        stage.copy_(_cpu_tensor(src))
        dst.copy_(stage, non_blocking=True)
        event.record(torch.cuda.current_stream(dst.device))

    def move(self, head: int, fill: int, cap: int) -> None:
        """Columns [head, head + fill) to the front of a [rows, cap] store:
        this one when the capacity holds and the two spans lie apart (the
        usual short remainder), else a new one; never an overlapping copy
        in place."""
        data = self.data
        if cap != data.shape[1] or fill > head:
            data = data.new_empty((self.hi - self.lo, cap))
        data[:, :fill] = self.data[:, head:head + fill]
        self.data = data


class DeviceSampleStore:
    """The tracked bank's [channels, cap] sample store, on the devices of
    its row ranges (a mesh bank's shards; an unsharded bank's one range).

    ``push`` takes what ``SampleBuffer.push`` takes (cast to float32, a
    1-D push broadcast to every channel) and writes it once into each
    range's store, through pinned staging on the card, in a
    ``bank.upload`` span. The pending samples are the columns [head, head
    + fill): ``view`` hands out views of them on each device, ``consume``
    moves the head, and the remainder moves to the front only when a push
    would pass the capacity (which doubles when the remainder and the push
    do not fit). ``fill`` and ``consumed`` (lifetime samples discarded,
    the stream-start test) read as ``SampleBuffer``'s.
    """

    def __init__(self, channels: int, rows, initial_cap: int = 1 << 16):
        self.channels = channels
        self.fill = 0
        self.consumed = 0
        self._head = 0
        self._cap = initial_cap
        self._rows = [_StoreRows(lo, hi, device, initial_cap)
                      for lo, hi, device in rows]

    def push(self, samples: np.ndarray) -> None:
        """samples: [channels, n] (or [n], every channel) appended at the
        write position."""
        samples = np.asarray(samples)
        if samples.ndim != 1 and samples.shape[0] != self.channels:
            raise ValueError(f"a push of {samples.shape[0]} rows to a "
                             f"store of {self.channels}")
        n = samples.shape[-1]
        if not n:
            return
        if self._head + self.fill + n > self._cap:
            cap = (self._cap if self.fill + n <= self._cap
                   else max(self._cap * 2, self.fill + n))
            for r in self._rows:
                r.move(self._head, self.fill, cap)
            self._head, self._cap = 0, cap
        with TRACER.span("bank.upload"):
            for r in self._rows:
                r.write(samples if samples.ndim == 1
                        else samples[r.lo:r.hi], self._head + self.fill)
        self.fill += n

    def view(self, length: int) -> list:
        """The first ``length <= fill`` pending samples of each row range,
        a view of its store on its device."""
        if length > self.fill:
            raise ValueError(f"{length} samples asked of {self.fill}")
        return [r.data[:, self._head:self._head + length]
                for r in self._rows]

    def consume(self, n: int) -> None:
        """Discard the first n samples (rebase origin by n)."""
        if n <= 0:
            return
        self.fill -= n
        self.consumed += n
        self._head = self._head + n if self.fill else 0

    def tail(self) -> np.ndarray:
        """The pending samples [channels, fill], a new host array: one
        copy from each device."""
        h = self._head
        return np.concatenate([r.data[:, h:h + self.fill].cpu().numpy()
                               for r in self._rows])


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
