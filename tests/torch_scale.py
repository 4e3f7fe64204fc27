"""Helpers of the port's scale-out tests (tests/test_torch_{parallel,
streaming_shards,tracked_bank_timesharded,distributed}.py): random-symbol
FM audio of each protocol's smoke stream (Gaussian pulses for the 2FSK
ones), its noise seed screened per channel until every decision the tests
compare sits clear of a slicer threshold and of a timing-variance tie, and
the JAX and port meshes of one shape."""
import os
import sys

import numpy as np

from digiham_tpu_torch import smoke
from torch_parity import audio_knife_edge_free

# protocol -> (smoke stream, demod mode, inverted)
STREAMS = {"dmr": (smoke.DMR, "gfsk", False),
           "ysf": (smoke.YSF, "gfsk", False),
           "nxdn": (smoke.NXDN, "gfsk", False),
           "dstar": (smoke.DSTAR, "fsk", False),
           "pocsag": (smoke.POCSAG, "fsk", True)}


def design_of(protocol: str):
    """The RRC a protocol's pipelines filter with (None: 2FSK)."""
    from digiham_tpu_torch.dsp.rrc import NARROW_RRC, WIDE_RRC

    return {"dmr": WIDE_RRC, "ysf": WIDE_RRC, "nxdn": NARROW_RRC}.get(
        protocol)


def screened_audio(protocol: str, channels: int, n: int, seed: int,
                   windows, filtered: bool = True) -> np.ndarray:
    """[channels, n] float32 FM audio of random symbols; each channel's
    noise seed is the first from ``seed + 1000 * c`` whose every window
    ``(start, samples, symbols)`` is knife-edge free, the demod starting
    fresh at ``start`` on the audio filtered from stream start (raw audio
    for a 2FSK protocol or ``filtered=False``)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    stream, mode, invert = STREAMS[protocol]
    design = design_of(protocol) if filtered else None
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(channels):
        tx = rng.integers(0, len(stream.levels), (1, n // stream.sps + 2))
        noise = seed + 1000 * c
        while True:
            x = smoke.audio(stream, tx, np.asarray([noise]), n)[0]
            y = x if design is None else rrc_np(x, design)
            if all(audio_knife_edge_free(y[start:start + length], symbols,
                                         stream.sps, mode, invert)
                   for start, length, symbols in windows):
                break
            noise += 1
        rows.append(x)
    return np.stack(rows)


def gaussian(levels: np.ndarray, sps: int, bt: float = 0.5) -> np.ndarray:
    """Per-symbol levels -> samples at ``sps`` shaped by a Gaussian pulse
    of bandwidth-time ``bt`` (what smoke.Stream.bt does to the 2FSK smoke
    streams: a rect 2FSK pulse has no column of least variance)."""
    x = np.repeat(np.asarray(levels, np.float64), sps)
    sigma = sps * np.sqrt(np.log(2.0)) / (2 * np.pi * bt)
    t = np.arange(-int(np.ceil(3 * sigma)), int(np.ceil(3 * sigma)) + 1)
    pulse = np.exp(-0.5 * (t / sigma) ** 2)
    return np.convolve(x, pulse / pulse.sum(), mode="same")


def screened_noise(base: np.ndarray, channels: int, sigma: float,
                   seed: int, protocol: str, n_sym: int | None = None,
                   filtered: bool = True) -> np.ndarray:
    """[channels, n] float32: ``base`` [n] (or [channels, n]) plus
    Gaussian noise of ``sigma``, each channel's noise seed the first from
    ``seed + 1000 * c`` whose stream is knife-edge free over its first
    ``n_sym`` symbols (all but the last two by default) for the
    protocol's demod, from stream start."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    stream, mode, invert = STREAMS[protocol]
    design = design_of(protocol) if filtered else None
    base = np.broadcast_to(base, (channels, np.shape(base)[-1]))
    n = base.shape[1]
    n_sym = n // stream.sps - 2 if n_sym is None else n_sym
    rows = []
    for c in range(channels):
        noise = seed + 1000 * c
        while True:
            x = (base[c] + np.random.default_rng(noise).normal(
                0, sigma, n)).astype(np.float32)
            y = x if design is None else rrc_np(x, design)
            if audio_knife_edge_free(y, n_sym, stream.sps, mode, invert):
                break
            noise += 1
        rows.append(x)
    return np.stack(rows)


def bulk_windows(n_time_splits, segment: int, symbols: int, total: int):
    """The windows a bulk step demodulates from a fresh state: every time
    shard of every split of ``total`` samples."""
    out = []
    for n_t in n_time_splits:
        seg = total // n_t
        assert seg >= segment, (seg, segment)
        out += [(t * seg, seg, symbols) for t in range(n_t)]
    return out


def jax_mesh(shape):
    """The JAX package's mesh of this (channel, time) shape on the
    8-device virtual CPU platform (tests/conftest.py)."""
    from digiham_tpu.parallel import make_mesh

    return make_mesh(n_channel_shards=shape[0], n_time_shards=shape[1])


def port_mesh(shape):
    """The port's mesh of this shape over CPU slots."""
    from digiham_tpu_torch.parallel import make_mesh

    return make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
