"""The DMR smoke stream: a committed fixture of DMR bursts and the JAX
package's decode of them, and the recipe that turns it into I/Q.

``data/dmr_smoke.npz`` holds, for each of a few stream variants, the TX
dibits (built with the test suite's DMR burst synthesizer: a dotting
preamble, VOICE_LC headers, voice bursts with sync or EMB, terminators),
the seed of its noise floor, and the JAX package's CPU outputs for the
stream run through ``DmrPipeline.step_iq_planes`` in ``STEPS`` chained
blocks (``tests/test_torch_pipeline_dmr.py`` rebuilds and checks it).

Blocks are chained the way a stream driver chains them: block ``s``
starts ``s * ADVANCE`` samples into the stream; ``ADVANCE`` is below the
fewest samples a step consumes, so the demod's read position stays
inside the next block. The RRC history and I/Q carry of the next block
are recomputed from the samples before its origin (the fused path's
counterpart of digiham_tpu/runtime/stream.py::rrc_rebase_history).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "dmr_smoke.npz"

SPS = 10
N_CENTURIES = 16
STEPS = 3
# fewest samples one step consumes: every century may slew back by one
ADVANCE = N_CENTURIES * 100 * SPS - N_CENTURIES
# covers the read position (< STEPS * N_CENTURIES after rebasing) plus
# n_centuries * (100 * sps + 1) + 1
BLOCK_LEN = 16128
STREAM_LEN = (STEPS - 1) * ADVANCE + BLOCK_LEN
FS, DEVIATION = 48000.0, 1944.0
LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0  # indexed by dibit value
NOISE_SIGMA = 0.02  # per I/Q component, on unit-amplitude I/Q
FM_SCALE = 5000.0
# the output fields the fixture pins down
FIELDS = ("dibits", "voice_payload", "sync_type", "slot_type_ok",
          "data_type", "bptc_data", "bptc_ok")


def modulate(tx_dibits: np.ndarray, noise_seeds) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """[V, N] dibits -> (re, im) [V, STREAM_LEN] float32 I/Q planes:
    rect 4FSK at ``SPS`` samples per symbol, ``LEVELS * DEVIATION`` Hz,
    continuous phase, plus complex Gaussian noise seeded per row."""
    freq = np.repeat(LEVELS[np.asarray(tx_dibits)], SPS,
                     axis=-1)[:, :STREAM_LEN] * DEVIATION
    iq = np.exp(1j * 2 * np.pi * np.cumsum(freq, axis=-1) / FS)
    for v, seed in enumerate(noise_seeds):
        noise = np.random.default_rng(int(seed)).normal(
            0.0, NOISE_SIGMA, (2, STREAM_LEN))
        iq[v] += noise[0] + 1j * noise[1]
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


def load() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def rebase(state, re, im, origin: int):
    """Port state and I/Q carry for the block starting at sample
    ``origin`` of the full planes ``re``/``im`` [C, STREAM_LEN], given the
    state returned by the block that started ``ADVANCE`` samples
    earlier."""
    from .dsp.demod import DemodState
    from .dsp.fm import fm_discriminator
    from .dsp.rrc import RrcState
    from .pipeline.dmr import DmrPipelineState

    halo = state.rrc.history.shape[-1]
    audio, _ = fm_discriminator(re[:, origin - halo:origin],
                                im[:, origin - halo:origin],
                                re[:, origin - halo - 1],
                                im[:, origin - halo - 1])
    demod = DemodState(state.demod.pos - ADVANCE, state.demod.offset,
                       state.demod.volume_ring)
    return (DmrPipelineState(RrcState(audio * FM_SCALE), demod),
            (re[:, origin - 1].clone(), im[:, origin - 1].clone()))
