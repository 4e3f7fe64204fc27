"""The DMR soak (the port of tools/tpu_soak.py): a 256-channel
``TrackedChannelBank(DmrPipeline(256, sps=10, n_centuries=16))`` on the
card decodes a long noisy voice stream, and every frame that does not come
out bit-exact is classified by machine (:mod:`.classify`).

The TX call alternates voice frames between the two TDMA slots; the bank's
slot arbitration forwards one, so the expected count is ``frames / 2``
bit-exact frames a channel. The audio is rect 4FSK at amplitude 1,000 with
Gaussian noise of sigma 60, pushed in blocks of 8,192 samples; the noise
of block ``b`` on channel ``c`` is seeded by ``(seed, b, c)``, so any
channel's exact stream can be rebuilt after the run. The bank's symbol
trajectory is recorded by wrapping its ``_consume_dibits`` (the bank is
not changed).

A miss is classified, in the order of tools/tpu_soak.py, as a noise error
(the f32 host oracle misdecodes the window against the TX symbols), a
knife-edge class of the window, or a cascade from a knife-edge root
(:func:`.classify.classify_miss`). Unlike tools/tpu_soak.py the windows
here are taken where the receiver sees each frame: the RRC delays the
symbols by ``(ntaps - 1) / 2 / sps`` = 4 (the JAX tool compares the oracle
with the TX symbols 4 symbols off, so its noise-error class takes every
window). The run passes when at least 99% of the frames are bit-exact and
no miss is ``UNCLASSIFIED``.
"""
from __future__ import annotations

import time

import numpy as np

from .. import smoke
from ..dsp.rrc import WIDE_RRC
from ..pipeline import DMR, DmrPipeline
from ..protocols.dmr.phases import pack_dibits
from ..runtime.tracked_bank import TrackedChannelBank
from . import classify
from .synth import DMR_PAYLOAD, FOUR_LEVELS, voice_frame

SPS = DMR.sps
LEAD = 30  # zero dibits before the first frame
FRAME = DMR.frame_size
AMPLITUDE = 1000.0
NOISE_SIGMA = 60.0
BLOCK = 8192  # samples a push
CENTURIES = 16  # a bank step: the main path's DmrPipeline
PASS_SHARE = 0.99
# the RRC's group delay in symbols: where the receiver sees a TX symbol
RX_DELAY = (WIDE_RRC.ntaps - 1) // 2 // SPS


def tx_dibits(n_frames: int) -> np.ndarray:
    """The TX symbols: LEAD zero dibits, then ``n_frames`` voice frames
    with sync, slots alternating, payload :data:`.synth.DMR_PAYLOAD`."""
    frames = [voice_frame(s % 2, DMR_PAYLOAD, sync=True)
              for s in range(n_frames)]
    return np.concatenate([np.zeros(LEAD, np.uint8)] + frames)


def base_audio(dibits: np.ndarray) -> np.ndarray:
    """Noise-free audio [n] float64: each dibit's level times AMPLITUDE,
    SPS samples a symbol."""
    return np.repeat(FOUR_LEVELS[dibits], SPS) * AMPLITUDE


def chan_noise(seed: int, block: int, channel: int, n: int) -> np.ndarray:
    """The noise of one (block, channel), seeded by ``(seed, block,
    channel)`` as tools/tpu_soak.py seeds it."""
    return np.random.default_rng((seed, block, channel)).normal(
        0, NOISE_SIGMA, n)


def noisy_block(base: np.ndarray, b: int, channels, seed: int) -> np.ndarray:
    """Push ``b`` of the stream: [len(channels), <= BLOCK] float32."""
    seg = base[b * BLOCK:(b + 1) * BLOCK]
    return np.stack([seg + chan_noise(seed, b, c, seg.shape[0])
                     for c in channels]).astype(np.float32)


def channel_stream(base: np.ndarray, channel: int, seed: int) -> np.ndarray:
    """One channel's exact pushed stream [n] float32, rebuilt."""
    n_blocks = -(-base.shape[0] // BLOCK)
    return np.concatenate([noisy_block(base, b, [channel], seed)[0]
                           for b in range(n_blocks)])


class Trajectory:
    """Records a bank's symbols: wraps its ``_consume_dibits`` (device
    steps and the flush's oracle tail alike), one list of chunks a
    channel."""

    def __init__(self, bank):
        self.chunks = [[] for _ in range(bank.channels)]
        consume = bank._consume_dibits

        def consume_and_record(dibits, block_hits=None):
            for c, row in enumerate(dibits):
                self.chunks[c].append(np.asarray(row, np.uint8).copy())
            return consume(dibits, block_hits)

        bank._consume_dibits = consume_and_record

    def channel(self, c: int) -> np.ndarray:
        return (np.concatenate(self.chunks[c]) if self.chunks[c]
                else np.zeros(0, np.uint8))


def frame_window(f: int) -> tuple[int, int]:
    """TX frame ``f``'s symbols as the receiver sees them."""
    lo = LEAD + f * FRAME + RX_DELAY
    return lo, lo + FRAME


def run(channels: int = 256, frames: int = 400, seed: int = 7,
        device=None, log=print) -> dict:
    """The soak. ``device=None`` is the card. Returns the result line's
    dict (``ok``, counts, miss classes, walls) plus ``outputs``: every
    channel's bytes."""
    dibits = tx_dibits(frames)
    base = base_audio(dibits)
    L = base.shape[0]
    pipe = DmrPipeline(channels=channels, sps=SPS, n_centuries=CENTURIES,
                       device=device)
    outputs = [b""] * channels

    def on_output(c, data):
        outputs[c] += bytes(data)

    bank = TrackedChannelBank(pipe, on_output=on_output, device=device)
    traj = Trajectory(bank)
    n_blocks = -(-L // BLOCK)
    gen_s = push_s = 0.0
    smoke.reset_launch_counts()
    for b in range(n_blocks):
        t0 = time.perf_counter()
        block = noisy_block(base, b, range(channels), seed)
        t1 = time.perf_counter()
        bank.push(block)
        push_s += time.perf_counter() - t1
        gen_s += t1 - t0
    steps = bank.steps
    t0 = time.perf_counter()
    bank.flush()
    flush_s = time.perf_counter() - t0
    launches = {k: v for k, v in smoke.launch_counts().items() if v}
    want = pack_dibits(DMR_PAYLOAD)
    expect = frames // 2  # slot arbitration forwards one of the two slots
    good = [outputs[c].count(want) for c in range(channels)]
    total = expect * channels
    t0 = time.perf_counter()
    misses = []
    tx_rx = np.concatenate([np.zeros(RX_DELAY, np.uint8), dibits])
    for c in range(channels):
        def oracle(c=c):
            return classify.oracle_trace(classify.rrc_np(
                channel_stream(base, c, seed), WIDE_RRC), sps=SPS)

        for f, v in classify.classify_output(
                outputs[c], want, expect, frame_window, traj.channel(c),
                oracle, tx_rx):
            misses.append({"channel": c, "frame": f, **v})
            log(f"  miss ch{c} frame~{f}: {v}")
    classify_s = time.perf_counter() - t0
    kinds = [classify.verdict_class(m["verdict"]) for m in misses]
    unclassified = sum(k == "UNCLASSIFIED" for k in kinds)
    exact = sum(good)
    ok = exact >= PASS_SHARE * total and unclassified == 0
    return {"program": "dmr_soak", "ok": ok, "channels": channels,
            "frames": frames, "centuries": CENTURIES, "seed": seed,
            "blocks": n_blocks, "steps": steps,
            "samples_per_channel": L, "air_s": L / 48000.0,
            "frames_bit_exact": exact, "frames_expected": total,
            "share_bit_exact": exact / total,
            "misses": len(misses), "unclassified": unclassified,
            "miss_classes": {k: kinds.count(k) for k in sorted(set(kinds))},
            "wall_s": gen_s + push_s + flush_s, "generate_s": gen_s,
            "push_s": push_s, "flush_s": flush_s,
            "wall_ms_per_step": push_s / max(steps, 1) * 1e3,
            "classify_s": classify_s, "launches": launches,
            "miss_list": misses,
            "outputs": outputs}
