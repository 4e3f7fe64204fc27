"""The impaired-RF matrix (the port of tests/test_impaired_rf.py's
matrix, :101-136, held to the TX truth instead of the reference binary).

A DMR call (:func:`.synth.dmr_call`, rect 4FSK at 1,944 Hz deviation, sps
10, slots alternating) is modulated to unit I/Q, and each case impairs it
(:mod:`.impairments`: carrier offset, 2-ray multipath, clipping, clock
skew, AWGN, and an urban combination) over a bank of channels, one seed a
channel (channel ``c`` takes ``seed + c``; channel 0 at the default seed
is the JAX test's stream). Two paths decode every case:

- **A** (kernel K1): the I/Q planes through ``DmrPipeline.step_iq_planes``
  in chained steps (each step's read index rebased as the bank does, the
  RRC history rebuilt from the planes), the symbols through the bank's
  frame decode (``TrackedChannelBank.push_dibits``); the planes are
  padded with their last sample (silence) so the last step covers the
  call;
- **B** (kernels K2, and K4 in the flush): the planes through the port's
  ``fm_discriminator`` (x 5,000) on the device, then a
  ``TrackedChannelBank`` pushed in chunks and flushed: the JAX test's
  ``_ours`` chain.

The bank forwards one of the two alternating slots, so a clean channel
gives ``frames / 2`` bit-exact frames. The JAX test's bar (:123-124) is
``frames / 2 - 2`` on its one stream. Over a bank of noise seeds and at
24 frames the JAX chain itself falls below it (clock -150 ppm decodes 7-8
of 12 on every seed: the reference's slew rule corrects a late sampling
point only once the variance valley has moved a whole column; AWGN at 12
dB leaves some seeds at 3 of 6 at 12 frames), so a channel below the bar
its missing frames explained by machine: every TX frame whose recorded
symbols differ from the TX symbols is classified (:func:`.classify.
classify_shortfall`, on that channel's exact audio and the bank's recorded
symbols), and the classified frames must cover the shortfall. A case
passes when every channel of both paths is at or above the bar or has its
shortfall so explained; one ``UNCLASSIFIED`` verdict fails it.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from .. import resolve_device, smoke
from ..dsp.fm import fm_discriminator
from ..dsp.rrc import WIDE_RRC, RrcState
from ..pipeline import DmrPipeline
from ..protocols.dmr.phases import pack_dibits
from ..runtime.tracked_bank import TrackedChannelBank
from . import classify
from .dmr_soak import RX_DELAY, Trajectory
from .impairments import impair_bank
from .synth import DMR_PAYLOAD, DMR_SPS, dmr_call, modulate

FM_SCALE = 5000.0
# the matrix of tests/test_impaired_rf.py (:104-114), after its clean
# baseline (:127-136)
CASES = (
    ("clean", {}),
    ("cfo+300hz", dict(cfo_hz=300.0)),
    ("cfo-500hz", dict(cfo_hz=-500.0)),
    ("multipath_2smp_-9db", dict(mp_delay=2, mp_gain=0.35)),
    ("clip_1.0rms", dict(clip_level=1.0)),
    ("clock+100ppm", dict(ppm=100.0)),
    ("clock-150ppm", dict(ppm=-150.0)),
    ("awgn_12db", dict(snr_db=12.0)),
    ("urban_combo", dict(cfo_hz=200.0, mp_delay=2, mp_gain=0.25,
                         ppm=60.0, snr_db=14.0)),
)
FRAMES = 24
SEED = 11  # tests/test_impaired_rf.py's
CENTURIES_A = 16  # path A: the raw-IQ main path's DmrPipeline
CENTURIES_B = 2   # path B: the bank of tests/test_impaired_rf.py's _ours
CHUNK = 4096      # its pushes
LEAD = 80  # dotting dibits before the first frame (synth.dmr_call)
FRAME = 144


def frame_window(f: int) -> tuple[int, int]:
    """TX frame ``f``'s symbols as the receiver sees them."""
    lo = LEAD + f * FRAME + RX_DELAY
    return lo, lo + FRAME


def case_planes(name: str, channels: int, frames: int = FRAMES,
                seed: int = SEED):
    """One case's impaired I/Q planes (re, im) [channels, n] float32."""
    kw = dict(CASES)[name]
    iq = modulate(dmr_call(frames))
    return impair_bank(iq, seed + np.arange(channels), **kw)


def _collect(channels):
    outputs = [b""] * channels

    def on_output(c, data):
        outputs[c] += bytes(data)

    return outputs, on_output


def path_a(re: torch.Tensor, im: torch.Tensor):
    """Raw I/Q planes [C, n] on the device through chained
    ``step_iq_planes`` steps, the symbols through the bank's frame
    decode. Returns (every channel's bytes, steps, the recorded symbol
    trajectory)."""
    C, n = re.shape
    dev = re.device
    pipe = DmrPipeline(channels=C, sps=DMR_SPS, n_centuries=CENTURIES_A,
                       device=dev)
    outputs, on_output = _collect(C)
    decoder = TrackedChannelBank(pipe, on_output=on_output, device=dev)
    traj = Trajectory(decoder)
    need = CENTURIES_A * (100 * DMR_SPS + 1) + 2
    # silence after the call: the last step reads past its end
    pad = need + 64
    re = torch.cat([re, re[:, -1:].expand(C, pad)], dim=1)
    im = torch.cat([im, im[:, -1:].expand(C, pad)], dim=1)
    state = pipe.init_state()
    carry = (torch.ones(C, device=dev), torch.zeros(C, device=dev))
    halo = state.rrc.history.shape[-1]
    origin = steps = 0
    while origin < n:
        length = int(state.demod.pos.max()) + need
        if origin + length > re.shape[1]:
            raise RuntimeError(f"step at {origin} reads {length} samples "
                               f"past the padded stream {re.shape[1]}")
        out, carry, state = pipe.step_iq_planes(
            re[:, origin:origin + length], im[:, origin:origin + length],
            *carry, state)
        decoder.push_dibits(out["dibits"].cpu().numpy())
        steps += 1
        base = int(state.demod.pos.min())
        origin += base
        state.demod.pos = state.demod.pos - base
        # the RRC history: the scaled FM audio of the halo before origin
        hist, _ = fm_discriminator(
            re[:, origin - halo:origin], im[:, origin - halo:origin],
            re[:, origin - halo - 1], im[:, origin - halo - 1])
        state.rrc = RrcState(hist * FM_SCALE)
        carry = (re[:, origin - 1].clone(), im[:, origin - 1].clone())
    return outputs, steps, traj


def fm_audio(re: torch.Tensor, im: torch.Tensor) -> np.ndarray:
    """The FM audio of whole planes, from the stream-start carry 1+0j,
    times FM_SCALE, as numpy."""
    C = re.shape[0]
    audio, _ = fm_discriminator(re, im, torch.ones(C, device=re.device),
                                torch.zeros(C, device=re.device))
    return (audio * FM_SCALE).cpu().numpy()


def path_b(audio: np.ndarray, device):
    """FM audio [C, n] through a ``TrackedChannelBank`` pushed in
    CHUNK-sample pushes, then flushed. Returns (every channel's bytes,
    steps, the recorded symbol trajectory)."""
    C = audio.shape[0]
    pipe = DmrPipeline(channels=C, sps=DMR_SPS, n_centuries=CENTURIES_B,
                       device=device)
    outputs, on_output = _collect(C)
    bank = TrackedChannelBank(pipe, on_output=on_output, device=device)
    traj = Trajectory(bank)
    steps0 = bank._meter.calls  # the meter is shared by banks of a width
    for lo in range(0, audio.shape[1], CHUNK):
        bank.push(audio[:, lo:lo + CHUNK])
    steps = bank._meter.calls - steps0
    bank.flush()
    return outputs, steps, traj


def below_bar(counts, outputs, traj, audio, bar: int, frames: int,
              oracles: dict) -> tuple[int, list]:
    """The channels under ``bar``: (how many, their misses as [(channel,
    first TX frame, verdict)]). ``oracles`` caches oracle traces by the
    channel's audio (channels of a case without noise share one)."""
    want = pack_dibits(DMR_PAYLOAD)
    tx_rx = np.concatenate([np.zeros(RX_DELAY, np.uint8), dmr_call(frames)])
    low = [c for c in range(len(counts)) if counts[c] < bar]
    misses = []
    for c in low:
        row = audio[c]

        def oracle(row=row):
            key = hashlib.sha1(row.tobytes()).hexdigest()
            if key not in oracles:
                oracles[key] = classify.oracle_trace(
                    classify.rrc_np(row, WIDE_RRC), sps=DMR_SPS)
            return oracles[key]

        for f, v in classify.classify_shortfall(
                traj.channel(c), oracle, tx_rx, frame_window, frames // 2,
                outputs[c].count(want)):
            misses.append((c, f, v))
    return len(low), misses


def run(channels: int = 256, frames: int = FRAMES, cases=None,
        seed: int = SEED, device=None, log=print) -> dict:
    """Every case of ``cases`` (names of :data:`CASES`; None: all) on both
    paths. ``device=None`` is the card. Returns the result line's dict:
    per case and path the frames decoded a channel (min, median), launches
    and wall, and ``ok``."""
    dev = resolve_device(device)
    names = [c for c, _ in CASES] if cases is None else list(cases)
    want = pack_dibits(DMR_PAYLOAD)
    bar = frames // 2 - 2
    rows, counts = {}, {}
    for name in names:
        re_np, im_np = case_planes(name, channels, frames, seed)
        re = torch.from_numpy(re_np).to(dev)
        im = torch.from_numpy(im_np).to(dev)
        audio = fm_audio(re, im)
        oracles = {}
        row = {}
        for path in ("A", "B"):
            smoke.reset_launch_counts()
            t0 = time.perf_counter()
            if path == "A":
                outputs, steps, traj = path_a(re, im)
            else:
                outputs, steps, traj = path_b(audio, dev)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in smoke.launch_counts().items() if v}
            got = np.array([o.count(want) for o in outputs])
            counts[name, path] = got
            t0 = time.perf_counter()
            n_low, misses = below_bar(got, outputs, traj, audio, bar, frames,
                                      oracles)
            kinds = [classify.verdict_class(v["verdict"])
                     for _, _, v in misses]
            row[path] = {"min": int(got.min()),
                         "median": float(np.median(got)),
                         "channels_below_bar": n_low,
                         "miss_classes": {k: kinds.count(k)
                                          for k in sorted(set(kinds))},
                         "unclassified": [(c, f, v) for c, f, v in misses
                                          if v["verdict"] == "UNCLASSIFIED"],
                         "steps": steps, "launches": launches,
                         "wall_s": wall,
                         "classify_s": time.perf_counter() - t0}
        row["ok"] = not (row["A"]["unclassified"] or row["B"]["unclassified"])
        rows[name] = row
        log(f"  impaired {name}: A min {row['A']['min']} median "
            f"{row['A']['median']}, B min {row['B']['min']} median "
            f"{row['B']['median']} (bar {bar}; below it A "
            f"{row['A']['channels_below_bar']}, B "
            f"{row['B']['channels_below_bar']} channels, their misses A "
            f"{row['A']['miss_classes']}, B {row['B']['miss_classes']})")
    return {"program": "impaired", "ok": all(r["ok"] for r in rows.values()),
            "channels": channels, "frames": frames, "bar": bar,
            "seed": seed, "samples_per_channel": re_np.shape[1],
            "cases": rows, "counts": counts}
