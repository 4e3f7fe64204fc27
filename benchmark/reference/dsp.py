"""The receive front of the plain reference: an RRC (or none) and the
century demodulator (4FSK or 2FSK) over a whole stream, in plain PyTorch.

A frozen copy of the arithmetic of ``digiham_tpu_torch``'s plain versions
(``ops/fir.py::fir_cmajor_plain``, ``dsp/demod.py::_demod_block_plain``),
which follow digiham's rrc_filter.cpp and fsk_demodulator.cpp /
gfsk_demodulator.cpp: the FIR sums tap by tap, every product and sum
rounded on its own; every float sum of the demod runs in the fixed pairwise
order of :func:`fold_sum`; divisions are true divisions. Each elementwise
operation rounds the same on any device, so this code gives the same bits
on the CPU and on the card.

A cell chooses the front: its configuration's ``rrc``, a name of
:data:`FILTERS` (digiham's ``wide`` 81-tap design for 12.5 kHz channels,
its ``narrow`` 161-tap one for 6.25 kHz, or ``none``: the samples go
straight to the centuries), and its protocol's slicer, the reference
subpackage's ``DEMOD``, one of :data:`MODES` (``gfsk`` slices 4FSK
dibits, ``fsk`` 2FSK bits), and ``INVERT`` (the 2FSK bits swapped, as
POCSAG sends them). The taps here are copies: a design the program adds
comes here as literals, never as an import.

The reference filters a channel's whole stream from a zeroed delay line
and demodulates it century after century from position 0; a bank that cuts
the stream into blocks and carries the state must give the same symbols.
``dtype`` is the arithmetic's precision: float32 is the configuration's,
bfloat16 the control's.
"""
from __future__ import annotations

import numpy as np
import torch

CENTURY = 100
VOLUME_RB_SIZE = 100
FLT_MIN = float(np.float32(1.17549435e-38))
VMIN_GUARD = 5000000.0

# mkshape -r 6e-02 2.0e-01 81 -w -l  (rrc_filter.cpp:86-112)
WIDE_GAIN = 8.337797030e+00
WIDE_TAPS = (
    -0.0008938217, -0.0002609230, +0.0005898982, +0.0016095188,
    +0.0026805019, +0.0035892828, +0.0040255371, +0.0036242975,
    +0.0020553299, -0.0008516117, -0.0049736668, -0.0097942071,
    -0.0143781385, -0.0174576799, -0.0176417629, -0.0137316693,
    -0.0050921107, +0.0080011038, +0.0241300735, +0.0407081846,
    +0.0542175970, +0.0607228306, +0.0566126484, +0.0394623171,
    +0.0088613798, -0.0329693214, -0.0809351463, -0.1273151201,
    -0.1625361486, -0.1764143887, -0.1597076656, -0.1057455528,
    -0.0118628528, +0.1196309860, +0.2811569136, +0.4603559944,
    +0.6413467573, +0.8066010425, +0.9391765221, +1.0249723677,
    +1.0546584365, +1.0249723677, +0.9391765221, +0.8066010425,
    +0.6413467573, +0.4603559944, +0.2811569136, +0.1196309860,
    -0.0118628528, -0.1057455528, -0.1597076656, -0.1764143887,
    -0.1625361486, -0.1273151201, -0.0809351463, -0.0329693214,
    +0.0088613798, +0.0394623171, +0.0566126484, +0.0607228306,
    +0.0542175970, +0.0407081846, +0.0241300735, +0.0080011038,
    -0.0050921107, -0.0137316693, -0.0176417629, -0.0174576799,
    -0.0143781385, -0.0097942071, -0.0049736668, -0.0008516117,
    +0.0020553299, +0.0036242975, +0.0040255371, +0.0035892828,
    +0.0026805019, +0.0016095188, +0.0005898982, -0.0002609230,
    -0.0008938217,
)
# mkshape -r 3e-02 2.0e-01 161 -w -x -l  (rrc_filter.cpp:36-84)
NARROW_GAIN = 1.667711971e+01
NARROW_TAPS = (
    -0.0008965127, -0.0006084266, -0.0002629259, +0.0001376901,
    +0.0005891423, +0.0010840181, +0.0016105739, +0.0021516457,
    +0.0026838327, +0.0031771176, +0.0035950725, +0.0038957679,
    +0.0040334554, +0.0039610403, +0.0036332901, +0.0030106572,
    +0.0020635228, +0.0007766025, -0.0008467956, -0.0027810092,
    -0.0049751193, -0.0073512625, -0.0098044779, -0.0122043473,
    -0.0143986008, -0.0162187503, -0.0174876896, -0.0180290597,
    -0.0176780431, -0.0162931143, -0.0137681562, -0.0100442577,
    -0.0051204456, +0.0009374242, +0.0079903670, +0.0158232514,
    +0.0241456376, +0.0325968938, +0.0407558163, +0.0481547523,
    +0.0542979823, +0.0586838603, +0.0608299644, +0.0603002781,
    +0.0567332283, +0.0498692532, +0.0395764841, +0.0258730951,
    +0.0089449258, -0.0108429006, -0.0329414440, -0.0566213193,
    -0.0809844704, -0.1049844817, -0.1274551627, -0.1471467396,
    -0.1627685874, -0.1730370678, -0.1767267207, -0.1727227994,
    -0.1600729711, -0.1380359261, -0.1061246612, -0.0641423317,
    -0.0122087987, +0.0492236806, +0.1193667582, +0.1971049660,
    +0.2810174958, +0.3694123940, +0.4603722307, +0.5518097911,
    +0.6415318736, +0.7273088884, +0.8069476569, +0.8783646253,
    +0.9396566353, +0.9891664557, +1.0255404526, +1.0477760738,
    +1.0552572221, +1.0477760738, +1.0255404526, +0.9891664557,
    +0.9396566353, +0.8783646253, +0.8069476569, +0.7273088884,
    +0.6415318736, +0.5518097911, +0.4603722307, +0.3694123940,
    +0.2810174958, +0.1971049660, +0.1193667582, +0.0492236806,
    -0.0122087987, -0.0641423317, -0.1061246612, -0.1380359261,
    -0.1600729711, -0.1727227994, -0.1767267207, -0.1730370678,
    -0.1627685874, -0.1471467396, -0.1274551627, -0.1049844817,
    -0.0809844704, -0.0566213193, -0.0329414440, -0.0108429006,
    +0.0089449258, +0.0258730951, +0.0395764841, +0.0498692532,
    +0.0567332283, +0.0603002781, +0.0608299644, +0.0586838603,
    +0.0542979823, +0.0481547523, +0.0407558163, +0.0325968938,
    +0.0241456376, +0.0158232514, +0.0079903670, +0.0009374242,
    -0.0051204456, -0.0100442577, -0.0137681562, -0.0162931143,
    -0.0176780431, -0.0180290597, -0.0174876896, -0.0162187503,
    -0.0143986008, -0.0122043473, -0.0098044779, -0.0073512625,
    -0.0049751193, -0.0027810092, -0.0008467956, +0.0007766025,
    +0.0020635228, +0.0030106572, +0.0036332901, +0.0039610403,
    +0.0040334554, +0.0038957679, +0.0035950725, +0.0031771176,
    +0.0026838327, +0.0021516457, +0.0016105739, +0.0010840181,
    +0.0005891423, +0.0001376901, -0.0002629259, -0.0006084266,
    -0.0008965127,
)
# a configuration's ``rrc``: a design's (taps, gain), or None for a front
# without a filter, whose samples go straight to the centuries
FILTERS = {"wide": (WIDE_TAPS, WIDE_GAIN),
           "narrow": (NARROW_TAPS, NARROW_GAIN),
           "none": None}
# a protocol's ``DEMOD``: digiham's 4FSK (gfsk_demodulator) or 2FSK
# (fsk_demodulator) slicer
MODES = ("gfsk", "fsk")


def scaled_taps(name: str) -> np.ndarray:
    """float32 taps of design ``name`` (not ``"none"``) with the gain
    folded in, as the program scales them."""
    taps, gain = FILTERS[name]
    return (np.asarray(taps, np.float64) / gain).astype(np.float32)


def fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x [C, T + ntaps-1] -> y [C, T], ``y[:, t] = sum_j taps[j] *
    x[:, t + j]`` summed tap by tap."""
    ntaps = taps.shape[0]
    T = x.shape[-1] - (ntaps - 1)
    y = taps[0] * x[:, 0:T]
    for j in range(1, ntaps):
        y = y + taps[j] * x[:, j:j + T]
    return y


def fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in a fixed pairwise order: while n > 1, with
    h = ceil(n/2), element i < n-h takes x[i] + x[i+h]."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = (n + 1) // 2
        x = torch.cat([x[..., :n - h] + x[..., h:], x[..., n - h:h]], dim=-1)
    return x[..., 0]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def eval_bounds(sps: int) -> tuple[int, int]:
    """lowestEval/highestEval = round(sps/3), round(2*sps/3) (cpp:8-10)."""
    return int(np.round(sps / 3)), int(np.round(sps * 2 / 3))


def century(samples, pos, offset, volume_ring, sps: int, *,
            mode: str = "gfsk", invert: bool = False):
    """One century of every channel: (symbols [C, 100] uint8, new_pos,
    new_offset, new_volume_ring). ``mode="gfsk"`` slices 4FSK dibits,
    ``"fsk"`` 2FSK bits (1 above the centre, 0 below; ``invert`` swaps
    them); timing, AGC ring and offset are the same in both."""
    dev, dtype = samples.device, samples.dtype
    L = samples.shape[-1]
    lo, hi = eval_bounds(sps)
    i = torch.arange(CENTURY, dtype=torch.int64, device=dev)
    k = torch.arange(sps, dtype=torch.int64, device=dev)
    shift = torch.where(i[None, :] > 0, offset.to(torch.int64)[:, None], 0)
    idx = (pos.to(torch.int64)[:, None, None] + (i * sps)[None, :, None]
           + k[None, None, :] + shift[:, :, None])
    inside = (idx >= 0) & (idx < L)
    vals = torch.gather(samples, 1, idx.clamp(0, L - 1).flatten(1))
    sym = torch.where(inside, vals.view(idx.shape),
                      torch.zeros((), dtype=dtype, device=dev))

    volume_avg = _div(fold_sum(sym, -1), sps)
    mid_avg = _div(fold_sum(sym[..., lo:hi], -1), hi - lo)
    windows = torch.cat([volume_ring, volume_avg], dim=-1).unfold(
        -1, VOLUME_RB_SIZE, 1)[:, 1:VOLUME_RB_SIZE + 1]
    vmin_level, wmax = windows.amin(-1), windows.amax(-1)
    vmax = torch.clamp(wmax, min=FLT_MIN)
    center = _div(vmax + vmin_level, 2.0)
    if mode == "gfsk":
        umid = (vmax - center) * 0.625 + center
        lmid = (vmin_level - center) * 0.625 + center
        symbols = torch.where(mid_avg > center,
                              torch.where(mid_avg > umid, 1, 0),
                              torch.where(mid_avg < lmid, 3, 2))
    else:
        one = 0 if invert else 1
        symbols = torch.where(mid_avg > center, one, 1 - one)

    col_mean = _div(fold_sum(sym, -2), CENTURY)
    d = col_mean[:, None, :] - sym
    variance = _div(fold_sum(d * d, -2), CENTURY)
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


class _Century:
    """:func:`century` again and again on one stream, the carry kept in
    place. On the card its launches are captured once in a CUDA graph and
    replayed: the same kernels on the same buffers, so the same bits, at a
    small share of the launch cost of a Python loop of some sixty
    operations a century."""

    def __init__(self, samples, pos, offset, ring, sps: int, mode: str,
                 invert: bool):
        self.args = (samples, pos, offset, ring, sps)
        # constants of the capture, as the program's are of its kernel
        self.kwargs = {"mode": mode, "invert": invert}
        self.pos, self.offset, self.ring = pos, offset, ring
        self.graph = None
        if samples.device.type == "cuda":
            side = torch.cuda.Stream(samples.device)
            side.wait_stream(torch.cuda.current_stream(samples.device))
            with torch.cuda.stream(side):
                century(*self.args, **self.kwargs)  # warm up outside
            torch.cuda.current_stream(samples.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = century(*self.args, **self.kwargs)

    def __call__(self) -> torch.Tensor:
        """One century: its symbols [C, 100]; the carry moves on."""
        if self.graph is None:
            sym, pos, offset, ring = century(*self.args, **self.kwargs)
        else:
            self.graph.replay()
            sym, pos, offset, ring = self.out
            sym = sym.clone()
        self.pos.copy_(pos)
        self.offset.copy_(offset)
        self.ring.copy_(ring)
        return sym


def demodulate(audio: torch.Tensor, sps: int, filter_name: str,
               dtype=torch.float32, *, mode: str = "gfsk",
               invert: bool = False):
    """A whole stream of FM audio [C, N] float32 -> (dibits [C, S] uint8,
    symbol_end [C, S] int64, century_start [C, S / 100] int64), every
    channel from its first sample: the RRC ``filter_name`` from a zeroed
    delay line (``"none"``: the audio itself), then centuries sliced by
    ``mode`` and ``invert`` (:func:`century`) while the last one's reads
    stay inside the stream; "dibits" are bits with ``mode="fsk"``.
    ``symbol_end[c, s]`` is one past the last input sample that symbol
    ``s`` of channel ``c`` reads: the sample after which a causal receiver
    could know it. ``century_start[c, k]`` is the sample at which century
    ``k`` of channel ``c`` starts (its demod position)."""
    dev = audio.device
    C, N = audio.shape
    if FILTERS[filter_name] is None:
        y = audio.to(dtype)
    else:
        taps = torch.as_tensor(scaled_taps(filter_name),
                               device=dev).to(dtype)
        x = torch.cat([torch.zeros((C, taps.shape[0] - 1), dtype=dtype,
                                   device=dev), audio.to(dtype)], dim=-1)
        y = fir(x, taps)
        del x
    pos = torch.zeros((C,), dtype=torch.int32, device=dev)
    offset = torch.zeros((C,), dtype=torch.int32, device=dev)
    ring = torch.zeros((C, VOLUME_RB_SIZE), dtype=dtype, device=dev)
    # century c reads inside [pos_c - 1, pos_c + 100 sps]: while pos_c
    # <= c (100 sps + 1) that is inside the stream for the first n, and
    # past them the reference goes on while the next century's reads are
    # inside, so it goes at least as far as a bank that steps blocks
    per_century = CENTURY * sps + 1
    n = max(0, (N - 2) // per_century)
    step = _Century(y, pos, offset, ring, sps, mode, invert)
    symbols, starts, offsets = [], [], []
    while len(symbols) < n or int(step.pos.max()) + CENTURY * sps + 2 <= N:
        starts.append(step.pos.clone())
        offsets.append(step.offset.clone())
        symbols.append(step())
    if not symbols:
        return (np.zeros((C, 0), np.uint8), np.zeros((C, 0), np.int64),
                np.zeros((C, 0), np.int64))
    dibits = torch.cat(symbols, dim=-1).cpu().numpy()
    # symbol j of a century reads pos + j*sps (+ the century's offset
    # after j = 0) .. + sps - 1
    start = torch.stack(starts, -1).to(torch.int64)          # [C, n]
    off = torch.stack(offsets, -1).to(torch.int64)
    j = torch.arange(CENTURY, device=dev, dtype=torch.int64)
    ends = (start[..., None] + j * sps + sps
            + torch.where(j > 0, off[..., None], 0)).flatten(1)
    return dibits, ends.cpu().numpy(), start.cpu().numpy()
