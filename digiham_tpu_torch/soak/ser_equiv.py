"""Symbol error rates of the three demod routes on the same noisy symbols
(the port of tools/tpu_ser_equiv.py, which held the Pallas kernel to the
XLA path on the TPU; here the card's kernels are held to each other and to
the TX truth).

Per SNR and repetition, ``channels`` random 4FSK symbol rows (seeded by
``(seed, snr x 10, rep)``) are modulated to unit I/Q (rect pulses, 1,944
Hz deviation, sps 10) with complex Gaussian noise at that SNR (signal
power over noise power per sample). Three routes demodulate the same
samples, every one from the stream-start state:

- **K2**: the FM audio (``fm_discriminator`` x 5,000) through
  ``rrc_demod_block`` (RRC and century demod fused);
- **K3**: the same audio filtered by ``rrc_filter_block`` (K4), then
  ``gfsk_demod_block``;
- **K1**: the I/Q planes through ``fm_rrc_demod_block`` (FM, RRC and demod
  fused).

K1, K2 and K4 keep the plain version's rounding order, so the three routes
must give the same symbols: the cross-path mismatch (K1 against K2, K3
against K2) must be exactly 0. Each route's SER is taken against the TX
symbols at the RRC's delay (4 symbols), after the AGC's first century.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device, smoke
from ..dsp.demod import (demod_init, fm_rrc_demod_block, gfsk_demod_block,
                         rrc_demod_block)
from ..dsp.fm import fm_discriminator
from ..dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block
from .dmr_soak import RX_DELAY
from .synth import DMR_DEVIATION, FOUR_LEVELS, FS

SNRS = (6.0, 10.0, 14.0, 20.0)
SPS = 10
CENTURIES = 8
FM_SCALE = 5000.0


def noisy_iq(rng, channels: int, snr_db: float):
    """(TX symbols [C, CENTURIES * 100 + 4], re, im [C, n] float32)."""
    tx = rng.integers(0, 4, (channels, CENTURIES * 100 + 4))
    freq = np.repeat(FOUR_LEVELS[tx], SPS, axis=1) * DMR_DEVIATION
    iq = np.exp(1j * 2 * np.pi * np.cumsum(freq, axis=1) / FS)
    sigma = np.sqrt(1.0 / (10 ** (snr_db / 10)) / 2)
    iq = iq + (rng.normal(0, sigma, iq.shape)
               + 1j * rng.normal(0, sigma, iq.shape))
    return tx, iq.real.astype(np.float32), iq.imag.astype(np.float32)


def routes(re: torch.Tensor, im: torch.Tensor) -> dict:
    """The three routes' symbols [C, CENTURIES * 100], as numpy."""
    C, dev = re.shape[0], re.device
    ones, zeros = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    audio, _ = fm_discriminator(re, im, ones, zeros)
    audio = audio * FM_SCALE
    k2, _, _ = rrc_demod_block(audio, RrcState.init(C, device=dev),
                               demod_init(C, dev), CENTURIES, SPS, WIDE_RRC)
    filtered, _ = rrc_filter_block(audio, RrcState.init(C, device=dev))
    k3, _ = gfsk_demod_block(filtered, demod_init(C, dev), CENTURIES, SPS)
    k1, _, _, _ = fm_rrc_demod_block(re, im, ones, zeros,
                                     RrcState.init(C, device=dev),
                                     demod_init(C, dev), CENTURIES, SPS,
                                     WIDE_RRC)
    return {k: v.cpu().numpy() for k, v in
            (("K2", k2), ("K3", k3), ("K1", k1))}


def symbol_errors(rx: np.ndarray, tx: np.ndarray) -> tuple[int, int]:
    """(errors, symbols) of ``rx`` [C, S] against the TX symbols at the
    RRC's delay, from the second century on."""
    truth = np.concatenate([np.zeros((tx.shape[0], RX_DELAY), tx.dtype), tx],
                           axis=1)[:, 100:rx.shape[1]]
    got = rx[:, 100:]
    return int((got != truth).sum()), int(got.size)


def run(channels: int = 256, reps: int = 4, seed: int = 99, device=None,
        log=print) -> dict:
    """Every SNR of :data:`SNRS`, ``reps`` repetitions each.
    ``device=None`` is the card."""
    dev = resolve_device(device)
    points = []
    smoke.reset_launch_counts()
    t0 = time.perf_counter()
    for snr in SNRS:
        err = dict.fromkeys(("K2", "K3", "K1"), 0)
        n = cross = 0
        for rep in range(reps):
            rng = np.random.default_rng((seed, int(snr * 10), rep))
            tx, re, im = noisy_iq(rng, channels, snr)
            got = routes(torch.from_numpy(re).to(dev),
                         torch.from_numpy(im).to(dev))
            for k, rx in got.items():
                e, n_k = symbol_errors(rx, tx)
                err[k] += e
            n += n_k
            cross += int((got["K1"] != got["K2"]).sum()
                         + (got["K3"] != got["K2"]).sum())
        point = {"snr_db": snr, **{f"ser_{k}": err[k] / n for k in err},
                 "symbols": n, "cross_path_mismatch": cross}
        points.append(point)
        log(f"  ser_equiv {point}")
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in smoke.launch_counts().items() if v}
    return {"program": "ser_equiv",
            "ok": all(p["cross_path_mismatch"] == 0 for p in points),
            "channels": channels, "centuries": CENTURIES, "reps": reps,
            "seed": seed, "points": points, "launches": launches,
            "wall_s": wall}
