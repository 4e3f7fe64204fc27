"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
synthesized FSK I/Q and the knife-edge screen for random streams."""
import os
import sys

import numpy as np

FS, DEVIATION = 48000.0, 1944.0
FOUR_LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
TWO_LEVELS = np.array([-1.0, 1.0])


def fsk_iq(rng, channels: int, n: int, sps: int, levels, noise=0.02,
           drift=0.0):
    """[C, n] float32 (re, im) planes: rect FSK at ``sps * (1 + drift)``
    samples per symbol (a TX clock offset the timing loop must track),
    continuous phase, complex Gaussian noise of ``noise`` per component on
    unit-amplitude I/Q."""
    sym = rng.integers(0, len(levels), (channels, n // sps + 2))
    at = (np.arange(n) / (sps * (1.0 + drift))).astype(np.int64)
    freq = np.asarray(levels)[sym][:, at] * DEVIATION
    iq = np.exp(1j * 2 * np.pi * np.cumsum(freq, axis=1) / FS)
    iq += rng.normal(0, noise, (channels, n)) + 1j * rng.normal(
        0, noise, (channels, n))
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


def knife_edge_free(re, im, n_sym: int, sps: int, design, mode="gfsk",
                    invert=False, fm_scale=5000.0) -> bool:
    """True iff no decision of the continuous stream (re, im) [N], from
    stream start (last sample 1+0j, zero RRC history), sits within f32
    reassociation distance of a slicer threshold or a timing-variance
    tie: tools/soak_classify.py's oracle and the tolerances of
    tests/test_multistream.py::_knife_edge_free."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import classify_window, rrc_np

    iq = re.astype(np.complex128) + 1j * im
    prev = np.concatenate([[1.0 + 0j], iq[:-1]])
    audio = np.angle(iq * np.conj(prev)) / np.pi * fm_scale
    r = classify_window(rrc_np(audio, design), 0, n_sym, sps=sps, mode=mode,
                        invert=invert)
    return (r["min_slicer_margin"] > 1e-5
            and (r["min_valley_flatness"] or 1.0) > 1e-4)
