"""2FSK / 4FSK (C4FM) century demodulator (port of
``digiham_tpu/dsp/demod.py``).

Reference behaviour (src/fsk_demodulator/fsk_demodulator.cpp:25-111,
src/gfsk_demodulator/gfsk_demodulator.cpp:24-122): integrate the middle
third of each symbol window, slice against thresholds from a 100-symbol
volume min/max ring (AGC), and every 100 symbols slew the read pointer by
±1 sample towards the minimum per-column timing variance. The timing loop
updates once per 100 symbols, so the unit of work is a *century*: one
``[100, sps]`` symbol matrix per channel, reduced along its axes.

``_demod_block_plain`` is the plain PyTorch version: a Python loop over
centuries, batched over channels. Every float sum runs in the fixed
pairwise order of :func:`fold_sum`, which the CUDA kernels
(csrc/demod_front.cu: K1, K2, K3) reproduce, so the kernels and this code
agree bit for bit; against the JAX package's XLA reductions they agree
within f32 reassociation (decisions equal on streams with no knife-edge symbol).

Window contract (the JAX package's, dsp/demod.py:285-287): ``pos >= 0``
and ``L >= max(pos) + n_centuries*(100*sps + 1) + 1``. Reads outside
``[0, L)`` give 0, as in the JAX package's zero-padded Pallas path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device

VARIANCE_SYMBOLS = 100  # fsk_demodulator.hpp:5
VOLUME_RB_SIZE = 100    # fsk_demodulator.hpp:6
CENTURY = 100
FLT_MIN = float(np.float32(1.17549435e-38))  # max starts at FLT_MIN (cpp:104)
VMIN_GUARD = 5000000.0  # fsk_demodulator.cpp:70


@dataclasses.dataclass
class DemodState:
    """Per-channel streaming carry."""

    pos: torch.Tensor          # [C] int32: read position of next symbol
    offset: torch.Tensor       # [C] int32: pending ±1 slew for next century
    volume_ring: torch.Tensor  # [C, 100] float32: last century's volumes


def demod_init(channels: int, device=None) -> DemodState:
    """Stream-start carry; ``device=None`` is the card."""
    device = resolve_device(device)
    return DemodState(
        pos=torch.zeros((channels,), dtype=torch.int32, device=device),
        offset=torch.zeros((channels,), dtype=torch.int32, device=device),
        volume_ring=torch.zeros((channels, VOLUME_RB_SIZE),
                                dtype=torch.float32, device=device),
    )


def _eval_bounds(sps: int) -> tuple[int, int]:
    """lowestEval/highestEval = round(sps/3), round(2*sps/3) (cpp:8-10)."""
    return int(np.round(sps / 3)), int(np.round(sps * 2 / 3))


def fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in a fixed pairwise order: while n > 1, with
    h = ceil(n/2), element i < n-h takes x[i] + x[i+h]. A CUDA block does
    the same folds with one thread per pair."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = (n + 1) // 2
        x = torch.cat([x[..., :n - h] + x[..., h:], x[..., n - h:h]], dim=-1)
    return x[..., 0]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """True float32 division. A Python scalar divisor would make the CUDA
    kernel multiply by its rounded reciprocal instead."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def _sliding_minmax_100(concat: torch.Tensor):
    """[C, 200] -> per-window (min, max) [C, 100]; window i spans
    concat[:, i+1 : i+101]. Exact in any order."""
    windows = concat.unfold(-1, VOLUME_RB_SIZE, 1)[:, 1:VOLUME_RB_SIZE + 1]
    return windows.amin(-1), windows.amax(-1)


def _symbol_matrix(samples, pos, offset, sps):
    """[C, 100, sps] century windows: symbol 0 reads the unshifted view,
    symbols 1..99 the view shifted by the pending slew
    (digiham_tpu/dsp/demod.py:121-134); reads outside [0, L) give 0."""
    dev = samples.device
    L = samples.shape[-1]
    i = torch.arange(CENTURY, dtype=torch.int64, device=dev)
    k = torch.arange(sps, dtype=torch.int64, device=dev)
    shift = torch.where(i[None, :] > 0, offset.to(torch.int64)[:, None], 0)
    idx = (pos.to(torch.int64)[:, None, None] + (i * sps)[None, :, None]
           + k[None, None, :] + shift[:, :, None])
    inside = (idx >= 0) & (idx < L)
    vals = torch.gather(samples, 1, idx.clamp(0, L - 1).flatten(1))
    return torch.where(inside, vals.view(idx.shape), 0.0)


def _century(samples, pos, offset, volume_ring, sps: int, mode: str,
             invert: bool):
    """Demodulate one century for every channel.

    samples: [C, L] float32 (whole block). Returns (symbols [C, 100]
    uint8, new_pos, new_offset, new_volume_ring)."""
    lo, hi = _eval_bounds(sps)
    sym = _symbol_matrix(samples, pos, offset, sps)  # [C, 100, sps]

    volume_avg = _div(fold_sum(sym, -1), sps)                 # [C, 100]
    mid_avg = _div(fold_sum(sym[..., lo:hi], -1), hi - lo)    # [C, 100]

    # AGC: after writing symbol i's volume, the ring holds volumes
    # i-99 .. i; min/max over it gives the slicer thresholds (cpp:102-111)
    vmin_level, wmax = _sliding_minmax_100(
        torch.cat([volume_ring, volume_avg], dim=-1))
    vmax = torch.clamp(wmax, min=FLT_MIN)
    center = _div(vmax + vmin_level, 2.0)
    if mode == "gfsk":
        umid = (vmax - center) * 0.625 + center
        lmid = (vmin_level - center) * 0.625 + center
        # >umid: 1, >center: 0, <lmid: 3, else: 2 (gfsk cpp:93-105)
        symbols = torch.where(
            mid_avg > center,
            torch.where(mid_avg > umid, 1, 0),
            torch.where(mid_avg < lmid, 3, 2),
        )
    else:
        one = 0 if invert else 1
        symbols = torch.where(mid_avg > center, one, 1 - one)

    # timing: column-wise variance of the century's sample matrix
    # (fsk cpp:41-79); the first minimum wins
    col_mean = _div(fold_sum(sym, -2), VARIANCE_SYMBOLS)      # [C, sps]
    d = col_mean[:, None, :] - sym
    variance = _div(fold_sum(d * d, -2), VARIANCE_SYMBOLS)    # [C, sps]
    vmin = variance.amin(-1)
    vmin_pos = (variance == vmin[:, None]).to(torch.int32).argmax(-1)
    guard_ok = (vmin > 0) & (vmin <= VMIN_GUARD)
    step_left = (vmin_pos > 0) & (vmin_pos < sps // 2)
    step_right = (vmin_pos >= sps // 2) & (vmin_pos < sps - 1)
    new_offset = torch.where(
        guard_ok, torch.where(step_left, 1, torch.where(step_right, -1, 0)),
        0).to(torch.int32)

    new_pos = pos + CENTURY * sps + offset
    return symbols.to(torch.uint8), new_pos, new_offset, volume_avg


def _demod_block_plain(samples, state: DemodState, n_centuries: int,
                       sps: int, mode: str = "gfsk", invert: bool = False):
    """[C, L] samples -> (symbols [C, n_centuries*100] uint8, DemodState).
    The new ``pos`` stays relative to this block's origin."""
    pos, offset, ring = state.pos, state.offset, state.volume_ring
    out = []
    for _ in range(n_centuries):
        symbols, pos, offset, ring = _century(samples, pos, offset, ring,
                                              sps, mode, invert)
        out.append(symbols)
    return torch.cat(out, dim=-1), DemodState(pos, offset, ring)


def fm_rrc_demod_block(re, im, last_re, last_im, rrc_state, demod_state,
                       n_centuries: int, sps: int, design,
                       mode: str = "gfsk", invert: bool = False,
                       fm_scale: float = 5000.0,
                       taps: torch.Tensor | None = None):
    """Raw-IQ segment: FM discriminator + RRC + century demod in one fused
    call (ops/demod_front.py: the CUDA kernel on the card, its plain
    version on the CPU).

    re/im: [C, L] float32 I/Q planes; last_re/last_im: [C] carry.
    Returns (symbols, new_rrc_state, new_demod_state, (new_last_re,
    new_last_im)). The new RRC history is the scaled FM audio of the
    block's last ``ntaps-1`` samples, computed in the unfused op order, so
    it equals the two-stage chain's carry bit for bit."""
    from ..ops.demod_front import demod_fm_front
    from .rrc import RrcState

    if taps is None:
        taps = design.taps_tensor(re.device)
    dib, pos, offset, ring, hist = demod_fm_front(
        re, im, last_re, last_im, rrc_state.history, taps,
        demod_state.pos, demod_state.offset, demod_state.volume_ring,
        n_centuries=n_centuries, sps=sps, mode=mode, invert=invert,
        fm_scale=fm_scale)
    return (dib, RrcState(hist), DemodState(pos, offset, ring),
            (re[:, -1].clone(), im[:, -1].clone()))


def rrc_demod_block(samples, rrc_state, demod_state, n_centuries: int,
                    sps: int, design=None, mode: str = "gfsk",
                    invert: bool = False, taps: torch.Tensor | None = None):
    """The RRC -> demod segment on FM audio, in one fused call (kernel K2
    on the card); with ``design=None`` the samples are filtered already
    and only the century demod runs (kernel K3). On the CPU each is its
    plain version (ops/demod_front.py).

    samples: [C, L] float32. Returns (symbols, new_rrc_state,
    new_demod_state); the new RRC history is the raw input tail (the
    state passes through untouched when there is no filter)."""
    from ..ops.demod_front import demod_front
    from .rrc import RrcState

    if design is None:
        dib, demod_state = _demod(samples, demod_state, n_centuries, sps,
                                  mode, invert)
        return dib, rrc_state, demod_state
    if taps is None:
        taps = design.taps_tensor(samples.device)
    dib, pos, offset, ring, hist = demod_front(
        samples, rrc_state.history, taps, demod_state.pos,
        demod_state.offset, demod_state.volume_ring,
        n_centuries=n_centuries, sps=sps, mode=mode, invert=invert)
    return dib, RrcState(hist), DemodState(pos, offset, ring)


def _demod(samples, state, n_centuries, sps, mode, invert):
    from ..ops.demod_front import demod

    dib, pos, offset, ring = demod(
        samples, state.pos, state.offset, state.volume_ring,
        n_centuries=n_centuries, sps=sps, mode=mode, invert=invert)
    return dib, DemodState(pos, offset, ring)


def gfsk_demod_block(samples, state: DemodState, n_centuries: int,
                     sps: int = 10):
    """4FSK demodulate a block of filtered samples (kernel K3 on the
    card). samples: [C, L] float32 with L >= max(state.pos) +
    n_centuries*(100*sps + 1) + 1. Returns (dibits [C, n_centuries*100]
    uint8, new DemodState); the new ``pos`` stays relative to this block's
    origin; whoever chains blocks rebases it."""
    return _demod(samples, state, n_centuries, sps, "gfsk", False)


def fsk_demod_block(samples, state: DemodState, n_centuries: int,
                    sps: int = 40, invert: bool = False):
    """2FSK demodulate a block: bits 0/1 per symbol. See
    :func:`gfsk_demod_block`."""
    return _demod(samples, state, n_centuries, sps, "fsk", invert)


class _DemodNp:
    """Host oracle: symbol-at-a-time numpy loop faithful to the reference
    (fsk_demodulator.cpp:25-111), for tests and the control plane (the
    banks' end-of-stream flush). Copy of ``digiham_tpu/dsp/demod.py``'s.

    precision='f64' mirrors the C double math in the variance loop;
    'f32' mirrors the device kernel.
    """

    def __init__(self, sps: int, invert: bool = False, precision: str = "f64"):
        self.sps = sps
        self.invert = invert
        self.lo, self.hi = _eval_bounds(sps)
        self.var_dtype = np.float64 if precision == "f64" else np.float32
        self.variance_rb = np.zeros(VARIANCE_SYMBOLS * sps, np.float32)
        self.variance_rb_pos = 0
        self.variance_offset = 0
        self.volume_rb = np.zeros(VOLUME_RB_SIZE, np.float32)
        self.volume_rb_pos = 0
        self.pos = 0  # absolute read index into the caller's stream

    def _calibrate(self):
        vmin = np.float32(self.volume_rb.min())
        vmax = np.float32(max(self.volume_rb.max(), FLT_MIN))
        center = (vmax + vmin) / 2
        return vmin, vmax, center

    def _slice(self, average, vmin, vmax, center):
        raise NotImplementedError

    def _on_century(self, var, vmin_pos, applied_offset):
        """Instrumentation hook: called at each century boundary with the
        per-offset timing variance vector and the decision. No-op here;
        a subclass can machine-check misses against the knife-edge
        classes (flat variance-valley ties, slicer-boundary flips)."""

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Consume as many symbols as available; returns symbol array."""
        samples = np.asarray(samples, dtype=np.float32)
        out = []
        while self.pos + self.sps + 1 < len(samples):
            window = samples[self.pos:self.pos + self.sps]
            self.variance_rb[
                self.variance_rb_pos:self.variance_rb_pos + self.sps
            ] = window
            self.pos += self.sps + self.variance_offset
            self.variance_offset = 0

            self.variance_rb_pos += self.sps
            if self.variance_rb_pos >= len(self.variance_rb):
                rb = self.variance_rb.reshape(VARIANCE_SYMBOLS, self.sps)
                totals = rb.sum(axis=0, dtype=np.float32)
                means = totals.astype(self.var_dtype) / VARIANCE_SYMBOLS
                var = (
                    ((means[None, :] - rb.astype(self.var_dtype)) ** 2).sum(0)
                    / VARIANCE_SYMBOLS
                )
                vmin_pos = int(np.argmin(var))  # first min wins
                vmin = var[vmin_pos]
                if vmin <= 0 or vmin > VMIN_GUARD:
                    pass
                elif 0 < vmin_pos < self.sps // 2:
                    self.variance_offset = +1
                elif self.sps // 2 <= vmin_pos < self.sps - 1:
                    self.variance_offset = -1
                self.variance_rb_pos = 0
                self._on_century(var, vmin_pos, self.variance_offset)

            self.volume_rb[self.volume_rb_pos] = window.mean(dtype=np.float32)
            self.volume_rb_pos = (self.volume_rb_pos + 1) % VOLUME_RB_SIZE

            vmin, vmax, center = self._calibrate()
            average = np.float32(
                window[self.lo:self.hi].sum(dtype=np.float32)
                / (self.hi - self.lo)
            )
            out.append(self._slice(average, vmin, vmax, center))
        return np.asarray(out, dtype=np.uint8)


class FskDemodNp(_DemodNp):
    def _slice(self, average, vmin, vmax, center):
        if average > center:
            return 0 if self.invert else 1
        return 1 if self.invert else 0


class GfskDemodNp(_DemodNp):
    def _slice(self, average, vmin, vmax, center):
        umid = (vmax - center) * np.float32(0.625) + center
        lmid = (vmin - center) * np.float32(0.625) + center
        if average > center:
            return 1 if average > umid else 0
        return 3 if average < lmid else 2
