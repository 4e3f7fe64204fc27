"""Machine classification of decode misses against the knife-edge
classes (the port's copy of tools/soak_classify.py, on the port's own
oracle, ``dsp/demod.py``'s ``_DemodNp`` at f32).

Two sum orders of the same float32 demodulator (the card's kernels, the
JAX package's XLA reductions, the host oracle) can decide a symbol
differently only where a decision sits on a knife edge. This module
re-demodulates the channel's exact sample stream through an INSTRUMENTED
f32 host oracle and checks whether the miss's symbol window holds such a
condition:

- ``slicer-boundary``: some symbol's mid-third average sits within
  SLICER_TOL of an AGC slicer threshold (center/umid/lmid), relative to
  the AGC span: a reassociation-sized nudge flips the dibit;
- ``flat-valley-tie``: a century boundary feeding the window has a
  timing-variance valley whose two smallest entries are within VALLEY_TOL
  relative: the argmin (first minimum wins) is order-sensitive;
- ``timing-settle``: the miss is in the first frames before the first
  accepted timing update, the documented acquisition loss.

Anything else is ``UNCLASSIFIED``: a real fault, not noise.
"""
import re

import numpy as np

from ..dsp.demod import FskDemodNp, GfskDemodNp

# f32 sum-order perturbations are O(1e-6) relative, so a decision within
# 1e-3 of its threshold is knife-edge with a wide margin, while a wrong
# symbol (a whole level, ~0.25 of the span) never qualifies.
SLICER_TOL = 1e-3  # fraction of the AGC span (vmax - vmin)
VALLEY_TOL = 1e-3  # relative flatness of the variance valley


class _InstrumentedGfsk(GfskDemodNp):
    def __init__(self, sps: int):
        # f32 mirrors the device kernel's precision class
        super().__init__(sps, precision="f32")
        self.margins = []    # per symbol: distance to nearest threshold
        self.centuries = []  # (symbol_index, valley_flatness, offset)

    def _slice(self, average, vmin, vmax, center):
        span = max(float(vmax) - float(vmin), 1e-30)
        umid = (vmax - center) * np.float32(0.625) + center
        lmid = (vmin - center) * np.float32(0.625) + center
        m = min(abs(float(average) - float(t))
                for t in (center, umid, lmid))
        self.margins.append(m / span)
        return super()._slice(average, vmin, vmax, center)

    def _on_century(self, var, vmin_pos, applied_offset):
        v = np.sort(np.asarray(var, np.float64))
        flat = float((v[1] - v[0]) / max(v[0], 1e-30))
        self.centuries.append((len(self.margins), flat,
                               int(applied_offset)))


class _InstrumentedFsk(FskDemodNp):
    def __init__(self, sps: int, invert: bool = False):
        super().__init__(sps, invert=invert, precision="f32")
        self.margins = []
        self.centuries = []

    def _slice(self, average, vmin, vmax, center):
        span = max(float(vmax) - float(vmin), 1e-30)
        self.margins.append(abs(float(average) - float(center)) / span)
        return super()._slice(average, vmin, vmax, center)

    _on_century = _InstrumentedGfsk._on_century


def oracle_trace(samples: np.ndarray, sps: int = 10, mode: str = "gfsk",
                 invert: bool = False):
    """Demodulate the full stream through the instrumented oracle.

    Returns (dibits, margins, centuries): the oracle's symbol stream,
    per-symbol threshold margins, and the century decision log
    [(symbol_index, valley_flatness, applied_offset)].
    """
    d = (_InstrumentedGfsk(sps) if mode == "gfsk"
         else _InstrumentedFsk(sps, invert=invert))
    dibits = d.process(np.asarray(samples, np.float32))
    return dibits, d.margins, d.centuries


def _verdict(margins, centuries, sym_lo, sym_hi):
    """Knife-edge verdict for the symbol span [sym_lo, sym_hi)."""
    window = margins[sym_lo:sym_hi]
    min_margin = min(window) if window else float("inf")
    # timing decided at century boundaries feeding the window: include
    # the boundary just before sym_lo (its slew shifts these symbols)
    feeding = [flat for (at, flat, _off) in centuries
               if sym_lo - 100 <= at <= sym_hi]
    min_flat = min(feeding) if feeding else float("inf")
    first_update = centuries[0][0] if centuries else 0
    if min_margin < SLICER_TOL:
        verdict = "slicer-boundary"
    elif min_flat < VALLEY_TOL:
        verdict = "flat-valley-tie"
    elif sym_lo <= first_update:
        verdict = "timing-settle"
    else:
        verdict = "UNCLASSIFIED"
    return {"verdict": verdict,
            "min_slicer_margin": round(min_margin, 8),
            "min_valley_flatness": (round(min_flat, 8)
                                    if feeding else None),
            "symbols": [sym_lo, sym_hi]}


def classify_window(samples: np.ndarray, sym_lo: int, sym_hi: int,
                    sps: int = 10, mode: str = "gfsk",
                    invert: bool = False) -> dict:
    """Classify a divergence whose symbols span [sym_lo, sym_hi).

    samples: the channel's FULL filtered sample stream (the exact floats
    the device demodulated). Returns a dict with ``verdict`` plus the
    evidence (minimum slicer margin in the window, flattest feeding
    valley).
    """
    _dib, margins, centuries = oracle_trace(samples, sps, mode, invert)
    return _verdict(margins, centuries, sym_lo, sym_hi)


def classify_root(device_dibits: np.ndarray, oracle_dibits: np.ndarray,
                  margins, centuries, sym_lo: int, sym_hi: int) -> dict | None:
    """Root-cause a cascade miss at [sym_lo, sym_hi): a knife-edge TIMING
    flip upstream slews the device's sampling phase, so symbols diverge
    for a transient with healthy oracle margins until the tracker
    re-converges; the miss's own window then classifies UNCLASSIFIED
    though the cause is the documented envelope.

    The check uses the device's RECORDED symbol stream: find the
    contiguous divergence EPISODE (against the oracle, gaps < one century)
    holding the frame's divergent symbols, and classify the episode's
    FIRST symbol: the trajectories are identical before it, so it is the
    root decision. Isolated upstream flips outside the episode are not
    blamed: slicer decisions do not feed back into the AGC or timing
    state. Returns the root verdict dict (with ``root_symbol``), or None
    if the streams agree everywhere before ``sym_hi``.
    """
    n = min(len(device_dibits), len(oracle_dibits), sym_hi)
    diff = np.nonzero(np.asarray(device_dibits[:n], np.uint8)
                      != np.asarray(oracle_dibits[:n], np.uint8))[0]
    if len(diff) == 0:
        return None
    # episode = maximal run of diffs ending at the last diff before
    # sym_hi with inter-diff gaps < 100 symbols (one timing century)
    root = int(diff[-1])
    for d in diff[::-1][1:]:
        if root - int(d) >= 100:
            break
        root = int(d)
    out = _verdict(margins, centuries, root, root + 1)
    out["root_symbol"] = root
    return out


def noise_errors(oracle_dibits: np.ndarray, tx_dibits: np.ndarray,
                 sym_lo: int, sym_hi: int) -> int:
    """Count oracle-vs-TX symbol errors in [sym_lo, sym_hi): the host
    oracle ITSELF misdecodes the noisy stream, a channel-noise error that
    every backend reproduces. Checked FIRST: such a miss is not a
    divergence at all."""
    o = np.asarray(oracle_dibits[sym_lo:sym_hi], np.uint8)
    t = np.asarray(tx_dibits[sym_lo:sym_hi], np.uint8)
    n = min(len(o), len(t))
    return int(np.count_nonzero(o[:n] != t[:n]))


def classify_miss(device_dibits, oracle, tx_dibits, sym_lo: int,
                  sym_hi: int) -> dict:
    """One missed frame's verdict, in the order of tools/tpu_soak.py: a
    noise error first (the oracle itself misdecodes the window against
    the TX symbols), then the knife-edge classes of the window, then the
    cascade class through :func:`classify_root` on the device's recorded
    symbols. ``oracle``: :func:`oracle_trace`'s (dibits, margins,
    centuries) of the channel's filtered stream."""
    orc, margins, cents = oracle
    ne = noise_errors(orc, tx_dibits, sym_lo, sym_hi)
    if ne:
        return {"verdict": f"noise-error({ne}sym)",
                "symbols": [sym_lo, sym_hi]}
    r = _verdict(margins, cents, sym_lo, sym_hi)
    if r["verdict"] != "UNCLASSIFIED":
        return r
    root = classify_root(device_dibits, orc, margins, cents, sym_lo, sym_hi)
    if root is not None and root["verdict"] != "UNCLASSIFIED":
        return dict(root, verdict=(f"cascade({root['verdict']}"
                                   f"@{root['root_symbol']})"),
                    symbols=[sym_lo, sym_hi])
    # keep the root evidence either way
    n = min(len(device_dibits), len(orc), sym_hi)
    nd = int(np.count_nonzero(np.asarray(device_dibits[:n], np.uint8)
                              != np.asarray(orc[:n], np.uint8)))
    r["root"] = root or f"no-divergence ({nd} diffs<{sym_hi})"
    return r


def classify_output(emitted: bytes, want: bytes, expect: int, window,
                    device_dibits, oracle, tx_dibits) -> list:
    """Every miss of one channel's slot-arbitrated voice output, in the
    order of tools/tpu_soak.py: [(first TX frame, verdict dict)]. Chunk k
    of ``emitted`` maps to the TX frame pair (2k, 2k+1), the friendlier
    verdict of the two counts; a shortfall is blamed on the head frames.
    ``window(f)``: TX frame f's symbols as the receiver sees them;
    ``oracle()``: :func:`oracle_trace` of the channel's filtered stream
    (called only when the channel missed a frame); ``tx_dibits``: the TX
    symbols in the receiver's index."""
    d = diff_frames(emitted, want, expect)
    if not d["corrupted"] and not d["shortfall"]:
        return []
    trace = oracle()
    windows = [(2 * k, 2 * k + 1) for k in d["corrupted"]]
    windows += [(f, f) for f in range(d["shortfall"])]
    out = []
    for pair in windows:
        results = [classify_miss(device_dibits, trace, tx_dibits, *window(f))
                   for f in dict.fromkeys(pair)]
        best = min(results,
                   key=lambda r: r["verdict"].startswith("UNCLASS"))
        out.append((pair[0], best))
    return out


def classify_shortfall(device_dibits, oracle, tx_dibits, window, expect: int,
                       good: int) -> list:
    """Explain a channel's missing voice frames in the symbol domain (for
    streams whose output chunks cannot be matched to TX frames by content,
    as when the tracker emits frames after the call ends): every TX frame
    pair (2k, 2k+1), k < ``expect``, whose recorded symbols differ from
    the TX symbols anywhere in either frame's window is classified with
    :func:`classify_miss` (the friendlier verdict of the pair's differing
    frames). Returns [(first TX frame, verdict dict)]; if fewer pairs
    carry a verdict than ``expect - good`` frames are missing, one
    ``UNCLASSIFIED`` entry names the frames that no symbol error
    explains. ``oracle()`` is called only when a pair differs."""
    dev = np.asarray(device_dibits, np.uint8)
    tx = np.asarray(tx_dibits, np.uint8)
    trace = None
    out = []
    for k in range(expect):
        bad = []
        for f in (2 * k, 2 * k + 1):
            lo, hi = window(f)
            n = min(hi, len(dev), len(tx)) - lo
            if n < hi - lo or np.any(dev[lo:lo + n] != tx[lo:lo + n]):
                bad.append(f)
        if not bad:
            continue
        if trace is None:
            trace = oracle()
        results = [classify_miss(dev, trace, tx, *window(f)) for f in bad]
        out.append((2 * k, min(results, key=lambda r:
                               r["verdict"].startswith("UNCLASS"))))
    explained = sum(v["verdict"] != "UNCLASSIFIED" for _, v in out)
    if good + explained < expect:
        out.append((None, {"verdict": "UNCLASSIFIED",
                           "unexplained_frames": expect - good - explained}))
    return out


def verdict_class(verdict: str) -> str:
    """A verdict without its counts and root position, for tallies:
    ``noise-error(3sym)`` -> ``noise-error``, ``cascade(flat-valley-tie@
    5000)`` -> ``cascade(flat-valley-tie)``."""
    return re.sub(r"\(\d+sym\)|@\d+", "", verdict)


def rrc_np(x: np.ndarray, design) -> np.ndarray:
    """Device-free replica of the pipeline's streaming RRC on one channel
    (zero initial history, the bank's start state): y[t] = sum_j taps[j] *
    x_full[t + j]. The knife-edge tolerances are ~1e-3 of the span, far
    above float32 sum-order differences."""
    taps = np.asarray(design.scaled_taps, np.float64)
    xf = np.concatenate([np.zeros(len(taps) - 1), np.asarray(x, np.float64)])
    return np.convolve(xf, taps[::-1], mode="valid").astype(np.float32)


def diff_frames(emitted: bytes, want: bytes, expect: int) -> dict:
    """Align a channel's emitted payload stream against ``expect``
    repetitions of ``want``: returns corrupted chunk indexes and the
    shortfall (frames never emitted)."""
    n = len(want)
    chunks = [emitted[i:i + n] for i in range(0, len(emitted), n)]
    corrupted = [k for k, c in enumerate(chunks) if c != want]
    return {"corrupted": corrupted,
            "shortfall": max(0, expect - len(chunks)),
            "emitted": len(chunks)}
