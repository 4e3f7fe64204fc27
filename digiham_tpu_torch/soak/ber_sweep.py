"""DMR symbol error rate and voice-frame success against SNR (the port of
tools/ber_sweep.py), over the full chain at bank width.

Per SNR point every channel carries the JAX tool's stream: 60 zero
dibits, then ``frames`` voice frames with sync, slots alternating, payload
``tile([1, 3, 0, 2], 27)``; rect 4FSK levels at sps 10 with Gaussian noise
of the SNR's sigma (against the mean symbol power), times 1,000; channel
``c`` draws its noise from ``default_rng(seed + c)`` (channel 0 is the
JAX tool's stream). The bank of channels runs ``rrc_filter_block`` (K4)
and one ``gfsk_demod_block`` over the whole stream (K3), and the symbols go
through the bank's frame decode (``TrackedChannelBank.push_dibits``). The
SER of a channel is taken at its best alignment against the TX symbols
(offsets 0-11, as the JAX tool searches); a frame counts when its 27
payload bytes come out bit-exact at a 27-byte boundary of the channel's
output. The slot arbitration forwards one of the two slots, so the ceiling
is ``frames / 2`` a channel.

The run passes when the highest SNR decodes every channel to at least
``frames / 2 - 1`` (the clean ceiling less the first frame's acquisition)
with a SER at most the lowest SNR's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device, smoke
from ..dsp.demod import demod_init, gfsk_demod_block
from ..dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block
from ..pipeline import DMR, DmrPipeline
from ..protocols.dmr.phases import pack_dibits
from ..runtime.tracked_bank import TrackedChannelBank
from .synth import DMR_PAYLOAD, FOUR_LEVELS, voice_frame

SNRS = (30, 20, 15, 12, 10, 8, 6, 4)
SPS = DMR.sps
LEAD = 60


def tx_dibits(frames: int) -> np.ndarray:
    parts = [voice_frame(s % 2, DMR_PAYLOAD, sync=True)
             for s in range(frames)]
    return np.concatenate([np.zeros(LEAD, np.uint8)] + parts)


def noisy_audio(tx: np.ndarray, snr_db: float, channels: int,
                seed: int) -> np.ndarray:
    """[channels, n] float32: the JAX tool's noisy stream, one noise seed
    a channel."""
    sig = np.repeat(FOUR_LEVELS[tx], SPS).astype(np.float32)
    p_sig = np.mean(FOUR_LEVELS[tx] ** 2)
    sigma = np.sqrt(p_sig / (10 ** (snr_db / 10)))
    return np.stack([
        (sig + np.random.default_rng(seed + c).normal(0, sigma, len(sig))
         ).astype(np.float32) * 1000 for c in range(channels)])


def best_ser(rx: np.ndarray, tx: np.ndarray) -> tuple[int, int]:
    """(errors, symbols) of one channel at its best offset in 0-11."""
    best = None
    for off in range(12):
        n = min(len(rx) - off, len(tx))
        e = int(np.count_nonzero(rx[off:off + n] != tx[:n]))
        if best is None or e / n < best[0] / best[1]:
            best = (e, n)
    return best


def run_point(snr_db: float, channels: int, frames: int, seed: int, dev):
    tx = tx_dibits(frames)
    x = torch.from_numpy(noisy_audio(tx, snr_db, channels, seed)).to(dev)
    filt, _ = rrc_filter_block(x, RrcState.init(channels, WIDE_RRC, dev))
    n_cent = (x.shape[1] // SPS - 2) // 100
    rx, _ = gfsk_demod_block(filt, demod_init(channels, dev), n_cent, SPS)
    rx = rx.cpu().numpy()
    outputs = [b""] * channels

    def on_output(c, data):
        outputs[c] += bytes(data)

    bank = TrackedChannelBank(
        DmrPipeline(channels=channels, sps=SPS, n_centuries=n_cent,
                    device=dev), on_output=on_output, device=dev)
    bank.push_dibits(rx)
    want = pack_dibits(DMR_PAYLOAD)
    ok = np.array([sum(o[i:i + 27] == want for i in range(0, len(o), 27))
                   for o in outputs])
    errs = [best_ser(rx[c], tx) for c in range(channels)]
    return (sum(e for e, _ in errs) / sum(n for _, n in errs), ok)


def run(channels: int = 256, frames: int = 40, seed: int = 0, device=None,
        log=print) -> dict:
    """Every SNR of :data:`SNRS`. ``device=None`` is the card."""
    dev = resolve_device(device)
    smoke.reset_launch_counts()
    points = []
    t0 = time.perf_counter()
    for snr in SNRS:
        ser, ok = run_point(snr, channels, frames, seed, dev)
        point = {"snr_db": snr, "ser": ser, "frames_ok": int(ok.sum()),
                 "frames_ceiling": channels * (frames // 2),
                 "frames_min": int(ok.min()),
                 "frames_median": float(np.median(ok))}
        points.append(point)
        log(f"  ber_sweep {point}")
    wall = time.perf_counter() - t0
    top, bottom = points[0], points[-1]
    return {"program": "ber_sweep",
            "ok": (top["frames_min"] >= frames // 2 - 1
                   and top["ser"] <= bottom["ser"]),
            "channels": channels, "frames": frames, "seed": seed,
            "points": points,
            "launches": {k: v for k, v in smoke.launch_counts().items()
                         if v},
            "wall_s": wall}
