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


def fsk_audio(rng, channels: int, n: int, sps: int, levels, amp=800.0,
              noise=40.0, drift=0.0):
    """[C, n] float32 FM audio (what the RRC consumes): rect FSK levels
    times ``amp`` at ``sps * (1 + drift)`` samples per symbol plus
    Gaussian noise."""
    sym = rng.integers(0, len(levels), (channels, n // sps + 2))
    at = (np.arange(n) / (sps * (1.0 + drift))).astype(np.int64)
    x = np.asarray(levels)[sym][:, at] * amp + rng.normal(
        0, noise, (channels, n))
    return x.astype(np.float32)


def audio_knife_edge_free(filtered, n_sym: int, sps: int, mode="gfsk",
                          invert=False) -> bool:
    """The knife-edge screen of :func:`knife_edge_free` for one channel's
    filtered samples [N] (float64, from stream start)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import classify_window

    r = classify_window(filtered, 0, n_sym, sps=sps, mode=mode,
                        invert=invert)
    return (r["min_slicer_margin"] > 1e-5
            and (r["min_valley_flatness"] or 1.0) > 1e-4)


def knife_edge_free(re, im, n_sym: int, sps: int, design, mode="gfsk",
                    invert=False, fm_scale=5000.0) -> bool:
    """True iff no decision of the continuous stream (re, im) [N], from
    stream start (last sample 1+0j, zero RRC history), sits within f32
    reassociation distance of a slicer threshold or a timing-variance
    tie: tools/soak_classify.py's oracle and the tolerances of
    tests/test_multistream.py::_knife_edge_free."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    iq = re.astype(np.complex128) + 1j * im
    prev = np.concatenate([[1.0 + 0j], iq[:-1]])
    audio = np.angle(iq * np.conj(prev)) / np.pi * fm_scale
    return audio_knife_edge_free(rrc_np(audio, design), n_sym, sps, mode,
                                 invert)


# --- the FM-audio smoke streams (YSF, NXDN) -------------------------------

VARIANTS = 8
# both RRC designs centre (ntaps-1)/2 samples back: 4 symbols at their sps
RRC_DELAY_SYMBOLS = 4
DOTS = np.tile(np.array([1, 3], np.uint8), 256)  # full-deviation dotting


def tx_stream(stream, slots) -> np.ndarray:
    """One variant's TX dibits. ``slots``: per step, the frames that fill
    the block's frame grid (``stream.frame_size``-aligned in each block's
    dibits); dotting fills the rest of each block and the tail. The
    stream leads the RX grid by the RRC delay."""
    per_block = stream.symbols_per_block // stream.frame_size
    filler = stream.symbols_per_block - per_block * stream.frame_size
    parts = []
    for frames in slots:
        assert len(frames) == per_block
        assert all(len(f) == stream.frame_size for f in frames)
        parts += [np.asarray(f, np.uint8) for f in frames] + [DOTS[:filler]]
    content = np.concatenate(parts)[RRC_DELAY_SYMBOLS:]
    n_sym = -(-stream.stream_len // stream.sps) + 1
    tail = np.tile(DOTS, -(-(n_sym - len(content)) // len(DOTS)))
    return np.concatenate([content, tail])[:n_sym]


def jax_audio_chain(pipe, state_cls, stream, samples, post=None, state=None,
                    first_step=0, steps=None):
    """A JAX pipeline's ``step(impl="xla")`` over chained blocks of the
    full audio ``samples`` [C, stream_len], rebased as smoke.rebase_audio
    does (``state_cls(rrc, demod)``). ``post(dibits)`` adds fields cut
    from the block's dibits. Returns (per-step output dicts as numpy,
    final state)."""
    import jax.numpy as jnp

    from digiham_tpu.dsp.demod import DemodState
    from digiham_tpu.dsp.rrc import RrcState
    from digiham_tpu_torch import smoke

    steps = smoke.STEPS if steps is None else steps
    if state is None:
        state = pipe.init_state()
    outs = []
    for s in range(first_step, first_step + steps):
        o = s * stream.advance
        if s:
            rrc = None  # a 2FSK state without an RRC keeps None
            if state.rrc is not None:
                halo = state.rrc.history.shape[-1]
                rrc = RrcState(jnp.asarray(samples[:, o - halo:o]))
            state = state_cls(
                rrc, DemodState(state.demod.pos - stream.advance,
                                state.demod.offset, state.demod.volume_ring))
        out, state = pipe.step(
            jnp.asarray(samples[:, o:o + stream.block_len]), state,
            impl="xla")
        if post is not None:
            out = {**out, **post(out["dibits"])}
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return outs, state


def port_audio_chain(pipe, stream, samples, post=None, state=None,
                     first_step=0, steps=None):
    """The same chain through a port pipeline on ``pipe.device`` (CPU
    tensors: the plain versions)."""
    import torch

    from digiham_tpu_torch import smoke

    steps = smoke.STEPS if steps is None else steps
    x = torch.from_numpy(samples).to(pipe.device)
    if state is None:
        state = pipe.init_state()
    outs = []
    for s in range(first_step, first_step + steps):
        o = s * stream.advance
        if s:
            state = smoke.rebase_audio(stream, state, x, o)
        out, state = pipe.step(x[:, o:o + stream.block_len], state)
        if post is not None:
            out = {**out, **post(out["dibits"])}
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return outs, state


def assert_fields_equal(port_out: dict, jax_out: dict, where=""):
    """Keys, dtypes, shapes and values equal. ``fich_data`` is the one
    documented dtype exception: int64 holding JAX's uint32 word."""
    assert sorted(port_out) == sorted(jax_out), where
    for k, want in jax_out.items():
        got = port_out[k]
        if k == "fich_data":
            assert got.dtype == np.int64 and want.dtype == np.uint32
            got = got.astype(np.uint32)
        assert got.dtype == want.dtype, (where, k)
        assert got.shape == want.shape, (where, k)
        assert np.array_equal(got, want), (where, k)


def build_audio_fixture(stream, design, tx_variant, jax_chain,
                        noise_seeds=None, first_seed=7000, mode="gfsk",
                        invert=False) -> dict:
    """TX dibits, noise seeds and the JAX pipeline's fields for an audio
    smoke stream. Without seeds, draws per-variant seeds until the
    filtered stream is knife-edge free (``design`` None: no filter)."""
    from digiham_tpu_torch import smoke

    tx = np.stack([tx_variant(v) for v in range(VARIANTS)])
    if noise_seeds is None:
        noise_seeds = []
        for v in range(VARIANTS):
            seed = first_seed + 100 * v
            while not audio_stream_knife_edge_free(
                    stream, design, smoke.audio(stream, tx[v:v + 1],
                                                [seed])[0], mode, invert):
                seed += 1
            noise_seeds.append(seed)
    noise_seeds = np.asarray(noise_seeds, np.int64)
    outs = jax_chain(smoke.audio(stream, tx, noise_seeds))
    fx = {"tx_dibits": tx, "noise_seeds": noise_seeds}
    for k in stream.fields:
        fx[f"expected_{k}"] = np.stack([o[k] for o in outs], axis=1)
    return fx


def audio_stream_knife_edge_free(stream, design, samples, mode="gfsk",
                                 invert=False) -> bool:
    """The knife-edge screen over every symbol the chained steps decode,
    for one channel's full audio [stream_len] (``design`` None: no
    filter)."""
    from digiham_tpu_torch import smoke

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    filtered = samples if design is None else rrc_np(samples, design)
    return audio_knife_edge_free(
        filtered, smoke.STEPS * stream.symbols_per_block, stream.sps, mode,
        invert)
