"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card; ~10-13 minutes
    python3 chip_smoke.py --profile  # also: kernels and device time per step

Phases, one line each (any failure raises and exits non-zero, with no
result line):
  1. the device: a CUDA card must be present; prints its name and power
     limit as nvidia-smi reports them, and its highest SM clock;
  2. builds every CUDA source of this checkout (csrc/demod_front.cu: K1,
     K2, K3; csrc/fir.cu: K4; csrc/viterbi.cu: K5; csrc/recurrence.cu:
     K6, the audio path's recurrences; csrc/recurrence_serial.cu: K6's
     earlier one-warp design, on no path, timed beside it in phase 5) with
     nvcc, all started together (the sources include csrc/fir_span.cuh, the
     FIR that K1, K2 and K4 share), and prints each -Xptxas -v report;
     the native host library (native/src/digiham_native.cpp, the control
     plane's Viterbi and plumbing) with g++ beside them, before any path or
     worker runs, printing its path and compile seconds;
     then the blocks of K1, K2 and K3 that the CUDA runtime keeps resident
     on one SM at each
     shape (every channel of the 256-channel DMR bank must be resident at
     once, and of K3's 2FSK shapes up to sps 94) and K4's (two or more);
  3. each kernel against its plain PyTorch version on the card, on seeded
     inputs made on the device, at the shapes the main paths give it:
     integers (dibits, pos, offset, bits, metrics) exact, floats (volume
     ring, RRC history) within 1e-3; K1 and K2 also at the long blocks of
     tools/bench_protocols.py (DMR 32 centuries, YSF 40, NXDN 16 at sps 20
     with 161 taps) and K2 on DMR rows whose storage starts one float off
     a 16-byte boundary (as a channel shard's or a worker's rows may);
     K3 also at the 2FSK shapes (D-Star 4 and 32 centuries
     at sps 10; POCSAG 4 and 8 at sps 40, 4 at sps 20 and 94, inverted;
     2 at sps 128, the widest symbol it takes); K4 (the standalone FIR)
     exact, at the
     bank shapes, a 129-tap design and the edge shapes (T = 0, 1, 4, 5, 6,
     79, 80, 81 and one tile -1, +0, +1; 1, 3 and 129 channels; 1, 2, 9 and
     10 taps) and the three banks' flush tails (the NXDN one with 161
     taps), on sample pointers that are not 16-byte aligned (82 taps
     through fir_cmajor, an odd row stride, a view that starts one float
     in), K4 -> K3 equal to K2 on the same block, and K4 within 1e-3 of the
     row's peak of one conv1d call; K5 exact on int64, int32, uint8 and
     strided inputs, batches of 1 to 4,096, T of 1 and of MAX_STEPS, and
     through its fused entry (several batches, one launch), the YSF and
     NXDN banks' padded decode rounds included; K5's 4-state instance
     exact at the D-Star header's shape (1 and 256 x 330; int64, int32,
     uint8, strided), blocked (2 steps), T 1-3, 36 and its longest, and
     fused over 4-state segments of different T; K6 exact, state included:
     the digital-voice IIR at 256 ch x 32,000 samples (4 s of 8 kHz voice
     on a bank), at one digitalvoice_filter chunk (1 ch x 32,768), at the
     bank voice's 256 ch x 783, at T 0, 1, 9, 10, 11 and one, two and
     three tiles -1, +0, +1, at 1, 7, 31, 33, 255, 256 and 257 channels and
     where the channels a block takes step (the SM count times 1, 2 and
     16, -1/+0/+1), on int32 PCM past the int16 range
     and on rows of a wider array, and the DC blocker at 256 ch x 48,000,
     1 ch x 32,768, the same edges and widths and a strided view; K3 at the
     demodulator tools' shape (1 channel x 1 century at sps 10, 20 and 40
     inverted) and K4 at rrc_filter's chunk (1 ch x 16,384, 81 and 161
     taps); and the serving and scale-out paths' shapes: K2 over a
     MultiStreamBank worker's 64 rows at the DMR and YSF bank blocks, K3
     over a worker's 64 D-Star rows, K4 at a worker's DMR and YSF flush
     tails, K5 at a YSF worker's padded decode round (2 x 256 x 100); for
     each time-sharded path K3 over a ring round (256 rows, a segment with
     its halos, pos drift_budget in) and, with an RRC, K4 over the four
     slots' segments with their halos (512 rows). Then the native host
     Viterbi (the decode fec/viterbi.py::viterbi_decode_np sends a 1-D
     sequence to) against the numpy decode on this host, bits and metric
     equal: at each caller's shape (YSF header DCH 180 and FICH 100, NXDN
     36 and 96 blocked, D-Star 330 at 4 states), at T 0 and on 400 random
     sequences; each shape's time per call, native and numpy;
  4. the main paths, through the entry points a user calls. Over 3
     chained steps of the committed fixtures (8 stream variants tiled over
     256 channels): raw-IQ DMR (step_iq_planes, K1), FM audio through
     DmrPipeline.step (K2), YsfPipeline.step (K2 + K5), NxdnPipeline.step
     + nxdn_decode_frames (K2 + K5), YsfPipeline(use_rrc=False).step on
     input pre-filtered by K4 (K3 + K5; K5 decodes all of a step's batches
     in one launch) and FskPipeline.step for D-Star (32 centuries, sps 10)
     and POCSAG (8 centuries, sps 40, inverted; K3 alone); the decoded
     fields (bits and sync distances on the 2FSK paths) must equal the JAX
     package's on every channel. One step of YsfPipeline(256 channels, 40
     centuries) over the YSF fixture's stream continued to 40,320 samples
     (K2 + K5): its dibits, pos, offset and ring must equal four chained
     10-century steps of the same stream, and the fields of its first two
     frames the JAX package's. Then the five streaming banks at full width
     (their lines print first): a TrackedChannelBank over DmrPipeline(256
     channels, 16 centuries), YsfPipeline(256, 10) with YsfAdapter,
     NxdnPipeline(256, 4 at sps 20) with NxdnAdapter, and FskPipeline(256,
     "dstar" / "pocsag", 4 centuries) with DstarAdapter / PocsagAdapter,
     each fed its bank fixture's FM audio (8 variants tiled) in uneven
     chunks, then flush() (4FSK: K2 per step, K5 per YSF/NXDN decode round
     that found frames, K4 on the tail; 2FSK: K3 per step and nothing
     else; POCSAG with its fixture's widened function bits); every
     channel's voice bytes and metadata events must equal the JAX bank's; a
     snapshot taken mid-stream (D-Star: while a header decode is pending)
     and restored into a fresh bank gives the same remainder, and a plain
     ChannelBank with make_decoder() per channel gives the same bytes; the
     calls of the native host Viterbi per bank are counted (the YSF and
     D-Star banks must make some; the MultiStreamBank workers below run it
     too). Then the soak programs of digiham_tpu_torch/soak at 256
     channels, each through its module's run, their seconds printed: the
     DMR soak (a TrackedChannelBank over DmrPipeline(256, 16 centuries) on
     200 voice frames of noisy audio a channel, at least 99% of the
     active-slot frames bit-exact and every miss classified by machine;
     K2 once a step, K4 once in the flush), the impaired-RF matrix (9
     cases at 24 frames through step_iq_planes, K1 once a step, and through
     the FM discriminator and a bank, K2 once a step and K4 in the flush;
     every channel at the bar of frames / 2 - 2 or its shortfall
     classified), ser_equiv (K1, K2 and K4 -> K3 on the same noisy symbols
     at 6, 10, 14 and 20 dB: 0 cross-path mismatches) and
     fuzz_timesharded (two random streams of each protocol through
     TimeShardedTrackedBank on a (2, 2) mesh of the card, its halo budget
     raised to 64 samples, and through the unsharded bank: bytes and
     events identical; K2, K3, K4, K5); each
     sets the launch counts to 0 before its work and reads them after,
     and the phase must launch K1-K5. Then the entry module: entry()'s
     step on the card (K2 once) equal to the same step on the CPU, and
     dryrun_multichip(4) over the card named four times.
     Then the voice post-filter at bank width: the dmr_bank path's voice
     bytes of every channel through an MbeSynthesizer of its own on a
     loopback codec stand-in (smoke.CodecStandIn), the PCM as one [256, T]
     block through digitalvoice_filter on the card (K6 once), equal to the
     plain version and within 8 LSB of the JAX function's (the stand-in's
     PCM is full scale). Then the command line: the five example chains of
     examples/*.sh (DMR, YSF, NXDN48 with mbe_synthesizer and
     digitalvoice_filter for DMR and NXDN, D-Star, POCSAG) as shell pipes
     of the port's tools, one process a stage, --backend cuda (K4 once a
     chunk, K3 once a century, K6 once a chunk, counted in each process)
     and --backend numpy (no launch); every stage's output equals the JAX
     tools' in the fixture (data/cli_smoke.npz): filtered audio within the
     JAX tools' own envelope, symbols, decoder bytes, metadata and PCM
     exactly, the post-filter within 8 LSB (the numpy one equal to the
     oracle). Then serving and scale-out, at 256 channels from the bank
     fixtures: MultiStreamBank(n_procs=4) on the card for DMR, YSF and
     D-Star (every channel's bytes equal the JAX bank's, and its events,
     which each worker writes to files through smoke.record_worker, a
     module-level worker_init; the workers' launches K2 once a step and K4
     once a flush each, K5 for YSF, K3 alone for D-Star; a supervised run
     whose worker 1 is SIGKILLed before the middle push gives the same
     bytes; every bank of the three, the timing banks of 1 and 2 workers
     included, starts in one go, and the supervised ones run together); TimeShardedTrackedBank on a (2, 2) mesh naming the card four
     times for all five protocols (36 / 24 / 8 / 16 / 8 centuries a time
     shard, a whole step at least on each fixture; bytes and events equal
     the JAX bank's; K4 once a step for the four slots, K3 once a time
     shard, K5 for YSF's fields and the YSF/NXDN decode rounds, K4 in the
     flush); TrackedChannelBank(mesh=(4, 1) of the card) over DMR (equal
     to the fixture; K2 once a step a shard); the bulk steps
     sharded_gfsk_step (DMR, YSF, NXDN) and sharded_fsk_step (D-Star,
     POCSAG) on the (2, 2) mesh, equal to the port's own single-device
     computation per time shard (K4, K3 and K5 once each); and
     torch.distributed: init_distributed with NCCL at world size 1 (TCP
     store on localhost), global_channel_mesh, make_global_array and one
     sharded_pipeline_step equal to the in-process mesh's. After each of
     the in-process scale-out paths, the first two calls of every
     signature (shapes, strides, alignment) it gave K2-K5 are replayed on
     copies of their own inputs against the plain versions (the
     time-sharded flush tails and the mesh shards' decode rounds among
     them). Every launch count is set to 0 just before a path and read
     just after (a worker's after its prewarm). Last, the three
     examples/torch_*.py on the card, started together as processes of
     their own (channel bank over the YSF fixture, 8 channels; the IQ demo
     with the codec stand-in, through K6; the serving bank, 8 channels over
     2 workers): exit 0 and each one's result line (the bank's and the
     serving bank's bytes equal the JAX bank's on every channel);
  5. times (CUDA events, after warm-up) of each kernel, its plain version,
     for K4 the one library call that computes the same function (conv1d,
     TF32 off; timed here, used nowhere in the port), and each whole step,
     beside each kernel's bound: the larger of its bytes (inputs read
     once, outputs written once) over 3.35 TB/s and its operations over 67
     TFLOP/s (the H100's float32 rate outside the tensor cores, taken for
     the integer work of K5 too); each bank's wall time per step (against
     its air time) and per flush; K6's time (CUDA events, and device time
     from the profiler, both taken right after phase 3; a profile that
     misses one of its kernels fails the run) at each of its phase 3
     shapes above the edges, beside the earlier one-warp design's in the
     same call (turns: serial, split, split, serial), its plain version's
     (the per-sample launch loop, timed on 320 samples and scaled) and its
     bound, the larger of its bytes over 3.35 TB/s and its serial chain (T
     x 3 dependent float32 operations for the IIR, 2 for the DC blocker, 4
     cycles each at the highest SM clock), and the share of the bound
     reached; each tool's start in a fresh process, cold (its first in the
     run) and warm; each example chain's
     wall time against its air time, on the card and with --backend numpy;
     ysf_bank, dstar_bank and nxdn_bank wall ms per step with the native
     host Viterbi and with the numpy one (its callers' name patched), in
     turns numpy, native, native, numpy (with --profile, each one's
     cProfile host split too); the device time of K5's 4-state instance at
     each of its rows (profiler);
  6. the measuring programs (digiham_tpu_torch/bench), each once as a
     process of its own at a short length, the four started together:
     the headline (2 reps x 8 steps, no multi-process stage),
     bench_protocols (1 rep x 8 steps a protocol), bench_multistream (2
     processes, 2 reps x 8 steps) and bench_latency (the streamdriver
     row at block 16,384 and the tracked row at 16 centuries, 256
     channels): each must exit 0 with every line
     correct (its fixture gate passed), this card's name and power limit
     in its provenance, distinct rep checksums (the latency rows: every
     frame matched) and the launches per step its path makes; prints each
     one's wall and numbers.
     With --profile also, per bank: kernels,
     device busy time, idle share, waits on the stream and copies per
     step, and the cProfile split of its host time; and what one
     MultiStreamBank worker adds to a DMR step (its cProfile split, with
     torch's threads as they are and at 1, beside the bank in this
     process, and the parent's pickling of a push); then the same device
     numbers for the serving and scale-out paths: each time-sharded bank,
     the mesh bank, each bulk sharded step, the distributed step (taken
     while its process group lives), and each MultiStreamBank path at 4
     workers (each worker under torch.profiler, smoke.device_profile_worker:
     the card's busy time over the parent's wall); last the time-sharded
     NXDN bank's wall ms per step with the KernelRecorder of phase 4 off
     and on, in turns off, on, on, off, then off and on after
     torch.cuda.empty_cache(), with what the recorder kept and what the
     caching allocator got from the driver in each turn, and each one's
     cProfile top functions. Every profiler session is a
     bench.common.Session: open a margin before a mark (one of the port's
     kernels) and after its work, taken again with the margins doubled (at
     most PROFILE_TRIES times, then the run fails) until every launch it
     saw has its device record (runtime calls matched by correlation id,
     the port's kernels counted against their launch counters; Kineto
     drops, as out of range, device records whose timestamps drift against
     the host clock, the more the older the process); one that records no
     device kernel of its work fails.
Then the kernels line and, last, the device line.
"""
import argparse
import dataclasses
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

CHANNELS = 256
PLAIN_BANK_CHANNELS = 64  # the plain ChannelBank beside the tracked bank
FLOAT_ATOL = 1e-3  # float outputs: f32 rounding-order envelope
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FOUR_LEVELS = [1 / 3, 1.0, -1 / 3, -1.0]
TWO_LEVELS = [-1.0, 1.0]
LIBRARY_RTOL = 1e-3  # K4 against conv1d, relative to the row's peak
PALLAS = "digiham_tpu/ops/demod_pallas.py"
LONG_CENTURIES = 40  # the YSF block of tools/bench_protocols.py
# K3 on the 2FSK paths: label -> (centuries, sps, inverted); the banks'
# and the audio blocks' shapes, POCSAG's other baud rates, and the widest
# symbol the kernel takes (sps 128 is the one shape that keeps a single
# block per SM: it is not a path's)
K3_2FSK = {
    "dstar_bank 256 ch x 4 centuries, sps 10": (4, 10, False),
    "dstar_audio 256 ch x 32 centuries, sps 10": (32, 10, False),
    "pocsag_bank 256 ch x 4 centuries, sps 40 inverted": (4, 40, True),
    "pocsag_audio 256 ch x 8 centuries, sps 40 inverted": (8, 40, True),
    "pocsag 2400 baud 256 ch x 4 centuries, sps 20 inverted": (4, 20, True),
    "pocsag 512 baud 256 ch x 4 centuries, sps 94 inverted": (4, 94, True),
    "256 ch x 2 centuries, sps 128 inverted (the widest)": (2, 128, True),
}
# K3 at the demodulator tools' shape, StreamDriver(1, sps, n_centuries=1):
# label -> (sps, mode, inverted)
K3_CLI = {
    "gfsk_demodulator 1 ch x 1 century, sps 10": (10, "gfsk", False),
    "gfsk_demodulator -s 20 1 ch x 1 century, sps 20": (20, "gfsk", False),
    "fsk_demodulator -s 10 1 ch x 1 century, sps 10": (10, "fsk", False),
    "fsk_demodulator -i -s 40 1 ch x 1 century, sps 40 inverted":
        (40, "fsk", True),
}
# K6 on its path: the post-filter of 4 s of 8 kHz voice on a bank, one of
# digitalvoice_filter's 65,536-byte chunks, the dmr_bank fixture's voice at
# bank width; the DC blocker (on no path) at a bank's 1 s of 48 kHz and at
# one channel
K6_IIR = {"256 ch x 32000 samples (4 s of 8 kHz voice on a bank)":
          (256, 32000),
          "digitalvoice_filter chunk 1 ch x 32768 samples": (1, 32768),
          "bank voice post-filter 256 ch x 783 samples": (256, 783)}
K6_DC = {"dc_block 256 ch x 48000 samples": (256, 48000),
         "dc_block 1 ch x 32768 samples": (1, 32768)}
KERNEL_OF_COUNTER = {"fm_rrc": "K1 cuda demod_fm_front",
                     "rrc": "K2 cuda demod_front", "none": "K3 cuda demod",
                     "fir": "K4 cuda rrc_filter_block_kernel",
                     "viterbi": "K5 cuda viterbi16",
                     "iir": "K6 cuda digitalvoice_iir"}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters, warmup=2):
    """Mean device time of fn over iters runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, operations):
    """(least time in ms the card could take, what sets it)."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = operations / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def demod_operations(channels, length, ntaps, n_centuries, sps, fm):
    """Float operations of the demod family on these shapes: per input
    sample the FIR's ntaps multiply-adds and, on the raw-IQ front, the
    discriminator (complex product 6, atan2f about 30, divide and scale);
    per consumed sample the century sums (volume, mid third, column mean,
    variance: about 6); per symbol the AGC window and slicer (about 10)."""
    per_sample = 2 * ntaps + (40 if fm else 0)
    symbols = channels * n_centuries * 100
    return channels * length * per_sample + symbols * sps * 6 + symbols * 10


def viterbi_operations(batch, steps, num_states=16):
    """Integer operations of the decode: per step and state two 2-bit
    distances, two adds, a compare, a select and a mask update (about 14),
    and about 5 per traceback step."""
    return batch * steps * (num_states * 14 + 5)


def generator(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def fsk_bank(dev, channels, length, sps, levels, seed):
    """Rect FSK I/Q planes on the card: random symbols, continuous phase,
    complex noise with a per-channel floor drawn from the seed."""
    g = generator(dev, seed)
    lv = torch.tensor(levels, dtype=torch.float64, device=dev)
    sym = torch.randint(0, len(levels), (channels, length // sps + 2),
                        generator=g, device=dev)
    freq = lv[sym].repeat_interleave(sps, dim=1)[:, :length] * 1944.0
    phase = 2 * np.pi * torch.cumsum(freq, dim=1) / 48000.0
    sigma = 0.01 + 0.04 * torch.rand((channels, 1), generator=g,
                                     dtype=torch.float64, device=dev)
    noise = torch.randn((2, channels, length), generator=g,
                        dtype=torch.float64, device=dev) * sigma
    return ((torch.cos(phase) + noise[0]).float().contiguous(),
            (torch.sin(phase) + noise[1]).float().contiguous())


def audio_bank(dev, channels, length, sps, levels, seed):
    """Rect FSK FM audio on the card: random symbols at +-800 full scale
    plus noise with a per-channel floor drawn from the seed."""
    g = generator(dev, seed)
    lv = torch.tensor(levels, dtype=torch.float32, device=dev)
    sym = torch.randint(0, len(levels), (channels, length // sps + 2),
                        generator=g, device=dev)
    sigma = 20 + 60 * torch.rand((channels, 1), generator=g, device=dev)
    x = lv[sym].repeat_interleave(sps, dim=1)[:, :length] * 800.0
    return (x + sigma * torch.randn((channels, length), generator=g,
                                    device=dev)).contiguous()


def demod_state(dev, channels, seed, halo=None):
    """Random carries: (hist,) pos, offset, ring."""
    g = generator(dev, seed)
    state = [torch.randint(0, 16, (channels,), generator=g, device=dev,
                           dtype=torch.int32),
             torch.randint(-1, 2, (channels,), generator=g, device=dev,
                           dtype=torch.int32),
             300 * torch.randn((channels, 100), generator=g, device=dev)]
    if halo is not None:
        state.insert(0, 300 * torch.randn((channels, halo), generator=g,
                                          device=dev))
    return state


def k1_args(dev, channels, length, sps, levels, seed):
    from digiham_tpu_torch.dsp.rrc import WIDE_RRC

    re, im = fsk_bank(dev, channels, length, sps, levels, seed)
    hist, pos, off, ring = demod_state(dev, channels, seed + 1,
                                       WIDE_RRC.ntaps - 1)
    return [re, im, re[:, 0].clone(), im[:, 0].clone(), hist,
            WIDE_RRC.taps_tensor(dev), pos, off, ring]


def k2_args(dev, channels, length, sps, design, levels, seed):
    hist, pos, off, ring = demod_state(dev, channels, seed + 1,
                                       design.ntaps - 1)
    return [audio_bank(dev, channels, length, sps, levels, seed), hist,
            design.taps_tensor(dev), pos, off, ring]


def k3_args(dev, channels, length, sps, levels, seed):
    return [audio_bank(dev, channels, length, sps, levels, seed),
            *demod_state(dev, channels, seed + 1)]


def compare_demod(name, kernel, plain, args, **kw):
    """A demod-family kernel against its plain version on the same inputs:
    dibits, pos and offset exact, floats within FLOAT_ATOL. Returns the
    largest float difference."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    for what, g, w in zip(("dibits", "pos", "offset"), got[:3], want[:3]):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{name} {what} differ from the plain version {kw}: "
              f"{int((g != w).sum())} of {g.numel()}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[3:], want[3:]))
    check(err <= FLOAT_ATOL, f"{name} ring/history differ by {err} {kw}")
    return err


def conv_encode_on(bits, num_states=16):
    """The 16- or 4-state encoder on the bits' device: [B, T] -> dibits."""
    from digiham_tpu_torch.fec.viterbi import TRANSITIONS_16

    table = torch.as_tensor(TRANSITIONS_16[:num_states], device=bits.device)
    shift = num_states.bit_length() - 2
    state = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    out = torch.empty_like(bits)
    for t in range(bits.shape[1]):
        b = bits[:, t]
        out[:, t] = table[state, b]
        state = ((b << shift) | (state >> 1)) & (num_states - 1)
    return out


def k5_cases(dev, batch, steps, blocked, seed, num_states=16):
    """Noisy encoded sequences, pure noise (ties) and all-equal
    observations."""
    g = generator(dev, seed)
    bits = torch.randint(0, 2, (batch, steps), generator=g, device=dev)
    bits[:, :blocked] = 0
    noisy = conv_encode_on(bits, num_states)
    flips = torch.rand((batch, steps), generator=g, device=dev) < 0.12
    noisy = torch.where(flips, noisy ^ torch.randint(
        1, 4, (batch, steps), generator=g, device=dev), noisy)
    return {"noisy": noisy,
            "noise": torch.randint(0, 4, (batch, steps), generator=g,
                                   device=dev),
            "zeros": torch.zeros((batch, steps), dtype=torch.int64,
                                 device=dev),
            "threes": torch.full((batch, steps), 3, device=dev)}


def same_k5(got, want, what):
    """K5's (bits, metric) equal the plain version's, dtype and shape
    included."""
    torch.cuda.synchronize()
    for g, w, part in zip(got, want, ("bits", "metrics")):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"K5 {part} differ from the plain version at {what}")


def compare_k5(dev, rounds=()):
    """K5 against its plain version, exactly: the three shapes of the
    paths at batches of 1 to 4,096 as int64, and as int32, uint8 and rows of
    a wider array; T of 1 and of MAX_STEPS; and the fused entry, also at
    ``rounds`` (label -> segments of (batch, T, blocked)). Returns
    (single-entry comparisons, fused segments compared)."""
    from digiham_tpu_torch.fec.viterbi import (viterbi_decode_many,
                                               viterbi_decode_plain)
    from digiham_tpu_torch.ops import viterbi
    from digiham_tpu_torch.ops.viterbi import viterbi16

    same = same_k5
    n = 0
    for steps, blocked in ((100, 0), (36, 4), (96, 4), (1, 0), (1, 4)):
        for batch in (1, 2, 3, 129, 512, 4096):
            cases = k5_cases(dev, batch, steps, blocked, 1000 + steps + batch)
            if steps == 1 or batch in (2, 3, 4096):  # fewer plain runs
                cases = {k: cases[k] for k in ("noisy", "noise")}
            for what, obs in cases.items():
                at = f"T={steps} blocked={blocked} batch={batch} ({what})"
                want = viterbi_decode_plain(obs, 16, blocked)
                before = viterbi.LAUNCHES
                same(viterbi16(obs, blocked), want, at)
                check(viterbi.LAUNCHES == before + 1, f"K5 launch count {at}")
                n += 1
                if batch in (3, 512):  # the other inputs the kernel reads
                    wide = torch.cat([obs ^ 1, obs, obs ^ 2], dim=1)
                    for kind, x in (
                            ("int32", obs.to(torch.int32)),
                            ("uint8", obs.to(torch.uint8)),
                            ("strided", wide.to(torch.uint8)[
                                :, steps:2 * steps])):
                        same(viterbi16(x, blocked), want, f"{at} {kind}")
                        n += 1
    # the longest sequence a block's shared memory holds (one plain run)
    obs = k5_cases(dev, 3, viterbi.MAX_STEPS, 0, 5)["noisy"].to(torch.uint8)
    same(viterbi16(obs), viterbi_decode_plain(obs, 16, 0),
         f"T=MAX_STEPS={viterbi.MAX_STEPS}")
    n += 1
    fused = 0
    for segments in (((512, 100, 0), (512, 100, 0)),       # a YSF step
                     ((512, 36, 4), (1024, 96, 4)),        # an NXDN decode
                     ((1, 1, 0), (3, 36, 4), (5, 100, 0), (129, 96, 4)),
                     # the banks' decode rounds: 256 ch x (frames of a
                     # block + 2), padded
                     ((1024, 100, 0), (1024, 100, 0)),     # ysf_bank
                     ((1024, 36, 4), (2048, 96, 4)),       # nxdn_bank
                     *rounds.values()):
        for what in ("noisy", "noise", "zeros", "threes"):
            ins = [(k5_cases(dev, b, t, bl, 7 + b + t)[what].to(
                        torch.uint8 if i % 2 else torch.int32), bl)
                   for i, (b, t, bl) in enumerate(segments)]
            before = viterbi.LAUNCHES
            got = viterbi_decode_many(ins)
            check(viterbi.LAUNCHES == before + 1,
                  f"K5 fused launch count at {segments}")
            for (obs, bl), g in zip(ins, got):
                same(g, viterbi_decode_plain(obs, 16, bl),
                     f"the fused entry, {segments} ({what})")
                fused += 1
    return n, fused


# K5's 4-state instance: the D-Star header code (330 dibits), 1 and 256
# headers at once, the blocked start of 2 steps, short and long sequences
K5_4_SINGLE = ((330, 0, (1, 256)), (330, 2, (1, 256)), (36, 2, (1, 3, 256)),
               (1, 0, (1, 3)), (1, 2, (1, 3)), (2, 2, (3,)), (3, 2, (3,)))
K5_4_FUSED = (((1, 330, 0), (256, 330, 2), (5, 36, 0), (129, 1, 2)),
              ((256, 330, 0), (256, 330, 0)))


def compare_k5_4(dev):
    """K5's 4-state instance against its plain version, exactly: the
    D-Star header's shape (1 and 256 sequences of 330 steps, as int64,
    int32, uint8 and rows of a wider array), the blocked start (2 steps),
    T of 1-3, 36 and max_steps(4), and viterbi_decode_many over 4-state
    segments of different T and start in one launch. Returns (single-entry
    comparisons, fused segments compared, launches of the instance)."""
    from digiham_tpu_torch.fec.viterbi import (viterbi_decode_many,
                                               viterbi_decode_plain)
    from digiham_tpu_torch.ops import viterbi
    from digiham_tpu_torch.ops.viterbi import viterbi16

    first = viterbi.LAUNCHES_BY_STATES[4]
    n = fused = 0
    for steps, blocked, batches in K5_4_SINGLE:
        for batch in batches:
            cases = k5_cases(dev, batch, steps, blocked, 2000 + steps + batch,
                             num_states=4)
            for what, obs in cases.items():
                at = (f"4 states T={steps} blocked={blocked} batch={batch} "
                      f"({what})")
                want = viterbi_decode_plain(obs, 4, blocked)
                before = viterbi.LAUNCHES
                same_k5(viterbi16(obs, blocked, num_states=4), want, at)
                check(viterbi.LAUNCHES == before + 1, f"K5 launch count {at}")
                n += 1
                if steps == 330:  # the other inputs the kernel reads
                    wide = torch.cat([obs ^ 1, obs, obs ^ 2], dim=1)
                    for kind, x in (("int32", obs.to(torch.int32)),
                                    ("uint8", obs.to(torch.uint8)),
                                    ("strided", wide.to(torch.uint8)[
                                        :, steps:2 * steps])):
                        same_k5(viterbi16(x, blocked, num_states=4), want,
                                f"{at} {kind}")
                        n += 1
    longest = viterbi.max_steps(4)
    obs = k5_cases(dev, 3, longest, 2, 6, num_states=4)["noisy"].to(
        torch.uint8)
    same_k5(viterbi16(obs, 2, num_states=4), viterbi_decode_plain(obs, 4, 2),
            f"4 states T=max_steps(4)={longest}")
    n += 1
    for segments in K5_4_FUSED:
        for what in ("noisy", "noise", "zeros", "threes"):
            ins = [(k5_cases(dev, b, t, bl, 9 + b + t, num_states=4)[what].to(
                        torch.uint8 if i % 2 else torch.int64), bl)
                   for i, (b, t, bl) in enumerate(segments)]
            before = viterbi.LAUNCHES
            got = viterbi_decode_many(ins, num_states=4)
            check(viterbi.LAUNCHES == before + 1,
                  f"K5 fused launch count at 4 states, {segments}")
            for (obs, bl), g in zip(ins, got):
                same_k5(g, viterbi_decode_plain(obs, 4, bl),
                        f"the fused entry at 4 states, {segments} ({what})")
                fused += 1
    return n, fused, viterbi.LAUNCHES_BY_STATES[4] - first


# the host Viterbi's callers: label -> (states, T, blocked_steps)
NATIVE_SHAPES = {"YSF header DCH": (16, 180, 0),
                 "YSF FICH / V/D2 DCH": (16, 100, 0),
                 "NXDN SACCH": (16, 36, 4), "NXDN FACCH1": (16, 96, 4),
                 "D-Star header": (4, 330, 0)}
NATIVE_RANDOM = 400  # further sequences of random code, length and start


def compare_native():
    """The native host Viterbi (what fec.viterbi.viterbi_decode_np runs on
    one sequence) against the numpy decode on this host: bits and metric
    equal at each caller's shape (noisy, noise and constant sequences), at
    T = 0 (no bits, metric 0) and on NATIVE_RANDOM random sequences.
    Returns (sequences compared, label -> (native ms, numpy ms) per call
    at the callers' shapes, host clock)."""
    from digiham_tpu_torch import native
    from digiham_tpu_torch.fec.viterbi import conv_encode

    rng = np.random.default_rng(17)

    def sequences(states, T, blocked):
        sent = rng.integers(0, 2, T)
        sent[:blocked] = 0
        coded = conv_encode(sent, states)
        noisy = np.where(rng.random(T) < 0.1,
                         coded ^ rng.integers(1, 4, T), coded)
        return [noisy, rng.integers(0, 4, T), np.full(T, 3)]

    def same(obs, states, blocked, what):
        got = native.viterbi(obs, states, blocked)
        want = native.viterbi_plain(obs, states, blocked)
        check(np.array_equal(got[0], want[0]) and got[1] == want[1],
              f"native Viterbi differs from numpy at {what}")

    n, times = 0, {}
    for label, (states, T, blocked) in NATIVE_SHAPES.items():
        seqs = sequences(states, T, blocked)
        for obs in seqs:
            same(obs, states, blocked, label)
            n += 1
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            native.viterbi(seqs[0], states, blocked)
        native_ms = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(20):
            native.viterbi_plain(seqs[0], states, blocked)
        times[label] = (native_ms, (time.perf_counter() - t0) * 1e3 / 20)
    for states in (4, 16):
        bits, metric = native.viterbi(np.zeros(0, np.uint8), states, 0)
        check(bits.shape == (0,) and metric == 0,
              f"native Viterbi at T = 0: {bits.shape}, {metric}")
        n += 1
    for i in range(NATIVE_RANDOM):
        states = (4, 16)[i % 2]
        blocked = (0, states.bit_length() - 1)[(i // 2) % 2]
        T = int(rng.integers(1, 400))
        obs = sequences(states, T, blocked)[i % 3]
        same(obs, states, blocked, f"random sequence {i} ({states} states, "
                                   f"T {T}, blocked {blocked})")
        n += 1
    return n, times


def k4_args(dev, channels, length, design, seed):
    """Random (samples, history, taps) for the standalone FIR."""
    g = generator(dev, seed)
    return [800 * torch.randn((channels, length), generator=g, device=dev),
            800 * torch.randn((channels, design.ntaps - 1), generator=g,
                              device=dev),
            design.taps_tensor(dev)]


def random_design(ntaps):
    """An asymmetric design of ``ntaps`` random taps, from a seed."""
    from digiham_tpu_torch.dsp.rrc import RrcDesign

    return RrcDesign(f"custom{ntaps}", 2.0, tuple(
        float(t) for t in np.random.default_rng(ntaps).normal(0, 0.3, ntaps)))


def conv1d_library(samples, history, taps):
    """The one PyTorch call that computes K4's function, as a closure over
    the row [history | samples] built here, outside what is timed: a cuDNN
    convolution (TF32 off). A yardstick only; the port never calls it."""
    x = torch.cat([history, samples], dim=-1)[:, None, :]
    w = taps[None, None, :]
    return lambda: torch.nn.functional.conv1d(x, w)[:, 0, :]


def compare_k4(dev, shapes, k2_dmr):
    """K4 against its plain version, exactly, at ``shapes`` (label ->
    (channels, length, design)) and the edge shapes; through fir_cmajor on
    a strided view; K4 -> K3 against K2 on ``k2_dmr`` (args, kwargs); and
    against conv1d. Returns (largest difference from the plain version,
    largest difference from conv1d relative to the row's peak, the number
    of shapes compared)."""
    from digiham_tpu_torch.dsp.rrc import NARROW_RRC, WIDE_RRC
    from digiham_tpu_torch.ops import demod_front, fir

    cases = [(c, t, d) for c, t, d in shapes.values()]
    cases += [(c, t, d) for c in (1, 3, 129)
              for t in (0, 1, 4, 5, 6, 79, 80, 81, fir.TILE - 1, fir.TILE,
                        fir.TILE + 1)
              for d in (WIDE_RRC, NARROW_RRC)]
    cases += [(5, t, random_design(k)) for k in (1, 2, 9, 10)
              for t in (1, 7, fir.TILE + 9)]
    err, lib_err = 0.0, 0.0
    for i, (channels, length, design) in enumerate(cases):
        args = k4_args(dev, channels, length, design, 400 + i)
        before = fir.LAUNCHES
        got = fir.rrc_filter_block_kernel(*args)
        want = fir.rrc_filter_block_plain(*args)
        torch.cuda.synchronize()
        check(fir.LAUNCHES == before + (1 if length else 0),
              f"K4 launch count at T={length}")
        what = f"{channels} ch x {length} x {design.ntaps} taps"
        for part, g, w in zip(("output", "history"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"K4 {part} shape at {what}")
            if g.numel():
                err = max(err, float((g - w).abs().max()))
            check(torch.equal(g, w),
                  f"K4 {part} differs from the plain version at {what}")
        check(got[1].data_ptr() != args[0].data_ptr()
              and got[1].is_contiguous(), "K4 history is a view")
        if i < len(shapes):  # long rows: their peak is the signal's
            lib = conv1d_library(*args)()
            peak = got[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            rel = float(((got[0] - lib).abs() / peak).max())
            check(rel <= LIBRARY_RTOL,
                  f"K4 differs from conv1d by {rel} of the peak at {what}")
            lib_err = max(lib_err, rel)
    # fir_cmajor on one [C, T + ntaps-1] array that is a strided view
    samples, history, taps = k4_args(dev, 7, 3000, WIDE_RRC, 499)
    wide = torch.cat([history, samples, samples], dim=-1)
    x = wide[:, :history.shape[1] + samples.shape[1]]
    check(not x.is_contiguous()
          and torch.equal(fir.fir_cmajor(x, taps),
                          fir.fir_cmajor_plain(x, taps)),
          "K4 fir_cmajor on a strided view differs from the plain version")
    # sample pointers off a 16-byte boundary: 82 taps (the samples start 81
    # floats into the row), an odd row stride (the alignment changes from
    # channel to channel), a view that starts one and three floats in
    for ntaps, width, start in ((82, 3001, 0), (82, 3001, 1), (81, 2999, 3),
                                (10, fir.TILE + 3, 2), (161, 4097, 1)):
        taps = random_design(ntaps).taps_tensor(dev)
        wide = 800 * torch.randn((7, width + 12), device=dev,
                                 generator=generator(dev, ntaps + width))
        x = wide[:, start:start + width]
        check(x[:, ntaps - 1:].data_ptr() % 16 != 0 and wide.stride(0) % 2
              and torch.equal(fir.fir_cmajor(x, taps),
                              fir.fir_cmajor_plain(x, taps)),
              f"K4 on a misaligned row ({ntaps} taps, width {width}, start "
              f"{start}) differs from the plain version")
    # what K4 filters is what K2 consumes: K4 -> K3 == K2, bit for bit
    (audio, hist, taps, pos, off, ring), kw = k2_dmr
    filtered, new_hist = fir.rrc_filter_block_kernel(audio, hist, taps)
    via_k3 = demod_front.demod(filtered, pos, off, ring, **kw)
    fused = demod_front.demod_front(audio, hist, taps, pos, off, ring, **kw)
    torch.cuda.synchronize()
    for part, g, w in zip(("dibits", "pos", "offset", "ring", "history"),
                          (*via_k3, new_hist), fused):
        check(torch.equal(g, w), f"K4 -> K3 {part} differ from K2's")
    return err, lib_err, len(cases)


def check_fields(path, outs, fx, stream, variant):
    """Every fixture field of every step equals the JAX package's on
    every channel. Returns the count of dibits that differ (reported, not
    a failure: fields are what a user reads)."""
    diffs = 0
    for s, out in enumerate(outs):
        check(out["dibits"].shape == (CHANNELS, stream.symbols_per_block),
              f"{path} dibits shape")
        for k in stream.fields:
            want = fx[f"expected_{k}"][variant, s]
            got = out[k]
            if k == "fich_data":  # int64 holding the unsigned 32-bit word
                got = got.astype(np.uint32)
            if k == "dibits":
                diffs += int((got != want).sum())
                continue
            bad = (got != want).reshape(CHANNELS, -1).any(1).sum() \
                if got.shape == want.shape else CHANNELS
            check(got.dtype == want.dtype and bad == 0,
                  f"{path} step {s} {k} differs from the JAX package's on "
                  f"{int(bad)} channels")
    return diffs


def run_iq_path(dev, smoke):
    """The raw-IQ path: DMR through step_iq_planes (K1)."""
    from digiham_tpu_torch.pipeline import DmrPipeline

    stream = smoke.DMR
    fx = smoke.load(stream)
    variant = np.arange(CHANNELS) % fx["tx_dibits"].shape[0]
    re_np, im_np = smoke.modulate(stream, fx["tx_dibits"], fx["noise_seeds"])
    re = torch.from_numpy(re_np[variant]).to(dev)
    im = torch.from_numpy(im_np[variant]).to(dev)
    pipe = DmrPipeline(channels=CHANNELS, sps=stream.sps,
                       n_centuries=stream.n_centuries)
    check(pipe.device.type == "cuda", "DmrPipeline() is not on the card")
    state = pipe.init_state()
    carry = (torch.ones(CHANNELS, device=dev),
             torch.zeros(CHANNELS, device=dev))
    outs = []
    smoke.reset_launch_counts()
    for s in range(smoke.STEPS):
        o = s * stream.advance
        if s:
            state, carry = smoke.rebase_iq(stream, state, re, im, o)
        out, carry, state = pipe.step_iq_planes(
            re[:, o:o + stream.block_len], im[:, o:o + stream.block_len],
            *carry, state)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    counts = smoke.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["fm_rrc"] = smoke.STEPS
    check(counts == want, f"raw-IQ DMR launches {counts}, want {want}")
    check(outs[0]["sync_dist_dense"].shape
          == (CHANNELS, stream.symbols_per_block - 23, 4),
          "sync_dist_dense shape")
    diffs = check_fields("raw-IQ DMR", outs, fx, stream, variant)
    ok_frames = int(sum(o["bptc_ok"].sum() for o in outs))
    blk = (re[:, :stream.block_len].contiguous(),
           im[:, :stream.block_len].contiguous())
    state0 = pipe.init_state()

    def step():
        pipe.step_iq_planes(*blk, *carry, state0)

    return counts, diffs, f"BPTC-ok frames {ok_frames}", step


def run_audio_path(dev, smoke, name, stream, kind, per_step, prefiltered=False,
                   post=None):
    """An FM-audio path over its fixture: ``kind(...).step`` in chained
    blocks (then ``post`` on the block's dibits). ``per_step``: the
    launches one step must make, by counter. Returns (launch counts,
    differing dibits, a decode summary, a closure that runs one step)."""
    from digiham_tpu_torch.dsp.rrc import RrcState, rrc_filter_block

    fx = smoke.load(stream)
    variant = np.arange(CHANNELS) % fx["tx_dibits"].shape[0]
    audio = smoke.audio(stream, fx["tx_dibits"], fx["noise_seeds"])
    x = torch.from_numpy(audio[variant]).to(dev)
    pipe = kind(channels=CHANNELS, sps=stream.sps,
                n_centuries=stream.n_centuries, use_rrc=not prefiltered)
    check(pipe.device.type == "cuda", f"{name}: pipeline is not on the card")
    smoke.reset_launch_counts()
    if prefiltered:
        # the whole stream through the standalone RRC (K4) from stream
        # start: what a caller that filters first hands the pipeline
        check(x.shape == (CHANNELS, stream.stream_len),
              f"{name}: K4 filters {tuple(x.shape)}, it was compared and "
              f"timed at {(CHANNELS, stream.stream_len)}")
        x, _ = rrc_filter_block(
            x, RrcState.init(CHANNELS, pipe.design), taps=pipe.rrc_taps)
    state = pipe.init_state()
    outs = []
    for s in range(smoke.STEPS):
        o = s * stream.advance
        if s:
            state = smoke.rebase_audio(stream, state, x, o)
        out, state = pipe.step(x[:, o:o + stream.block_len], state)
        if post is not None:
            out.update(post(pipe, out["dibits"]))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    counts = smoke.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update({k: v * smoke.STEPS for k, v in per_step.items()})
    if prefiltered:
        want["fir"] = 1
    check(counts == want, f"{name} launches {counts}, want {want}")
    diffs = check_fields(name, outs, fx, stream, variant)
    if stream.name == "dmr":
        summary = "BPTC-ok frames %d" % sum(o["bptc_ok"].sum() for o in outs)
    elif stream.name == "ysf":
        summary = "FICH-ok and DCH-ok frames %d" % sum(
            (o["fich_ok"] & o["vd2_dch_ok"]).sum() for o in outs)
    elif stream.name in ("dstar", "pocsag"):
        summary = "exact syncs found " + ", ".join(
            "%s %d" % (k[len("sync_dist_"):], sum((o[k] == 0).sum()
                                                  for o in outs))
            for k in stream.fields if k.startswith("sync_dist_"))
    else:
        summary = "LICH-ok and SACCH-ok frames %d, FACCH1-ok slots %d" % (
            sum((o["lich_ok"] & o["sacch_ok"]).sum() for o in outs),
            sum(o["facch_ok0"].sum() + o["facch_ok1"].sum() for o in outs))
    blk = x[:, :stream.block_len].contiguous()
    state0 = pipe.init_state()

    def step():
        out, _ = pipe.step(blk, state0)
        if post is not None:
            post(pipe, out["dibits"])

    return counts, diffs, summary, step


def run_long_ysf_path(dev, smoke):
    """One full-width step of YsfPipeline at LONG_CENTURIES centuries (K2 +
    K5) over the YSF fixture's stream, continued with the same frames
    under other noise. Its dibits and carries must equal chained steps at
    the fixture's 10 centuries over the same samples, and the fields of
    the frames both grids share (the first block's) the JAX package's.
    Returns (launch counts, dibits differing from JAX's over the fixture's
    span, a summary, a closure that runs the step)."""
    from digiham_tpu_torch.pipeline import YsfPipeline

    short = smoke.YSF
    long = dataclasses.replace(short, n_centuries=LONG_CENTURIES)
    fx = smoke.load(short)
    variant = np.arange(CHANNELS) % fx["tx_dibits"].shape[0]
    base = smoke.audio(short, fx["tx_dibits"], fx["noise_seeds"])
    more = smoke.audio(short, np.tile(fx["tx_dibits"], (1, 2)),
                       fx["noise_seeds"] + 1, long.block_len)
    audio = np.concatenate([base, more[:, base.shape[1]:]], axis=1)
    x = torch.from_numpy(audio[variant]).to(dev)
    pipe = YsfPipeline(channels=CHANNELS, sps=long.sps,
                       n_centuries=long.n_centuries)
    check(pipe.device.type == "cuda", "YSF long: pipeline is not on the card")
    smoke.reset_launch_counts()
    out, state = pipe.step(x, pipe.init_state())
    torch.cuda.synchronize()
    counts = smoke.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(rrc=1, viterbi=1)
    check(counts == want, f"YSF long launches {counts}, want {want}")
    check(out["dibits"].shape == (CHANNELS, long.symbols_per_block),
          "YSF long dibits shape")

    # the same samples in chained steps of the fixture's 10 centuries
    ratio = long.n_centuries // short.n_centuries
    ref = YsfPipeline(channels=CHANNELS, sps=short.sps,
                      n_centuries=short.n_centuries)
    ref_state = ref.init_state()
    dibits = []
    for s in range(ratio):
        o = s * short.advance
        if s:
            ref_state = smoke.rebase_audio(short, ref_state, x, o)
        ref_out, ref_state = ref.step(x[:, o:o + short.block_len], ref_state)
        if s == 0:
            first = ref_out
        dibits.append(ref_out["dibits"])
    check(torch.equal(out["dibits"], torch.cat(dibits, dim=1)),
          "YSF long: dibits differ from chained 10-century steps")
    check(torch.equal(state.demod.pos,
                      ref_state.demod.pos + (ratio - 1) * short.advance)
          and torch.equal(state.demod.offset, ref_state.demod.offset)
          and torch.equal(state.demod.volume_ring,
                          ref_state.demod.volume_ring)
          and torch.equal(state.rrc.history, x[:, -state.rrc.history.shape[1]:]),
          "YSF long: carries differ from chained 10-century steps")
    shared = short.symbols_per_block // short.frame_size  # frames, one grid
    diffs = 0
    for k in short.fields:
        got = out[k].cpu().numpy()
        if k == "dibits":
            want_d = np.concatenate(
                [fx["expected_dibits"][variant, s] for s in range(smoke.STEPS)],
                axis=1)
            diffs = int((got[:, :want_d.shape[1]] != want_d).sum())
            continue
        check(torch.equal(out[k][:, :shared], first[k]),
              f"YSF long: {k} of the shared frames differs from the "
              f"10-century step's")
        if k == "fich_data":
            got = got.astype(np.uint32)
        check(np.array_equal(got[:, :shared], fx[f"expected_{k}"][variant, 0]),
              f"YSF long: {k} of the shared frames differs from the JAX "
              f"package's")
    ok = int((out["fich_ok"] & out["vd2_dch_ok"]).sum())
    frames = long.symbols_per_block // long.frame_size
    summary = (f"1 step x {CHANNELS} ch x {long.n_centuries} centuries "
               f"({x.shape[1]} samples, {frames} frames a channel) == {ratio} "
               f"chained {short.n_centuries}-century steps (dibits, pos, "
               f"offset, ring, history); the {shared} shared frames' fields "
               f"equal the JAX package's; FICH-ok and DCH-ok frames {ok}")
    state0 = pipe.init_state()

    def step():
        pipe.step(x, state0)

    return counts, diffs, summary, step


class BankRun:
    """One bank over the bank fixture's audio tiled over its channels:
    collects every channel's voice bytes and metadata events."""

    def __init__(self, bank, channels):
        from digiham_tpu_torch.runtime.meta import PipelineMetaWriter

        self.bank = bank
        self.voice = [b""] * channels
        self.events = [[] for _ in range(channels)]
        bank.on_output = self.on_output
        for c in range(channels):
            writer = PipelineMetaWriter(
                lambda b, ev=self.events[c]: ev.append(b.decode()))
            if hasattr(bank, "set_meta_writer"):
                bank.set_meta_writer(c, writer)
            else:
                bank.decoders[c].set_meta_writer(writer)

    def on_output(self, c, data):
        self.voice[c] += data

    def outputs(self):
        return self.voice, ["".join(ev) for ev in self.events]

    def push(self, audio, chunks, start=0):
        """Push ``chunks`` of ``audio`` [C, n] from sample ``start``."""
        for n in chunks:
            self.bank.push(audio[:, start:start + n])
            start += int(n)
        torch.cuda.synchronize()


# a streaming bank's path: (name, smoke stream, pipeline class and adapter
# class by name, protocol); the pipeline geometry is the JAX package's
# (examples/channel_bank.py: YSF 10 centuries at sps 10, NXDN 4 at sps 20,
# D-Star and POCSAG 4 at their sps; DMR 16 as bench.py's bank)
BANKS = (("dmr_bank", "DMR_BANK", "DmrPipeline", "DmrAdapter", "dmr"),
         ("ysf_bank", "YSF_BANK", "YsfPipeline", "YsfAdapter", "ysf"),
         ("nxdn_bank", "NXDN_BANK", "NxdnPipeline", "NxdnAdapter", "nxdn"),
         ("dstar_bank", "DSTAR_BANK", "FskPipeline", "DstarAdapter",
          "dstar"),
         ("pocsag_bank", "POCSAG_BANK", "FskPipeline", "PocsagAdapter",
          "pocsag"))
TWO_FSK = ("dstar", "pocsag")


def bank_pipeline(kind, protocol, channels, stream):
    """A bank's pipeline on the card at its stream's geometry."""
    if protocol in TWO_FSK:
        return kind(channels, protocol, n_centuries=stream.n_centuries,
                    sps=stream.sps)
    return kind(channels=channels, sps=stream.sps,
                n_centuries=stream.n_centuries)


def pending_header(bank):
    """True while some channel's D-Star hunt holds a header decode open
    (its exact stream position kept for the 660 header bits)."""
    return any(ch.tracker is None and not getattr(ch.hunt, "hunting", True)
               for ch in bank.chans)


def run_bank_path(smoke, name, stream_name, pipeline_name, adapter_name,
                  protocol):
    """A streaming bank at full width, through TrackedChannelBank's push
    and flush over its fixture: every channel's bytes and events must
    equal the JAX bank's, a mid-stream snapshot (D-Star: the first one
    taken while a header decode is pending) restored into a fresh bank
    must give the same remainder, and a plain ChannelBank with
    make_decoder() per channel the same bytes on PLAIN_BANK_CHANNELS.
    Launches of the 4FSK banks: K2 once per step, K5 once per decode round
    that found frames (YSF and NXDN; counted in the run, not written in),
    K4 once (the flush); of the 2FSK banks (no RRC): K3 once per step and
    nothing else. POCSAG runs with its fixture's widened function bits.
    Returns (launch counts, a summary, a closure that pushes the whole
    stream through a fresh bank, seconds per step, seconds of the flush,
    steps, decode rounds)."""
    import importlib

    from digiham_tpu_torch import pipeline as pipelines
    from digiham_tpu_torch.runtime import tracked_bank
    from digiham_tpu_torch.runtime.channel_bank import ChannelBank
    from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

    stream, fx, audio, chunks, want, variant = bank_fixture(smoke,
                                                            stream_name)
    kind = getattr(pipelines, pipeline_name)
    make_decoder = importlib.import_module(
        f"digiham_tpu_torch.protocols.{protocol}").make_decoder
    rounds = []  # one entry per decode round that found frames

    def make_bank(channels=CHANNELS, counted=False):
        pipe = bank_pipeline(kind, protocol, channels, stream)
        adapter = getattr(tracked_bank, adapter_name)()
        if counted:
            decode = adapter.decode_fields

            def decode_fields(frames, pipeline):
                rounds.append(len(frames))
                return decode(frames, pipeline)

            adapter.decode_fields = decode_fields
        return pipe, TrackedChannelBank(pipe, adapter=adapter)

    pipe, bank = make_bank(counted=True)
    check(bank.device.type == "cuda" and pipe.device.type == "cuda",
          f"{name}: the bank is not on the card")
    run = BankRun(bank, CHANNELS)
    meter_before = bank._meter.calls
    smoke.reset_launch_counts()
    push_s, cut = 0.0, None
    for i, n in enumerate(chunks[:-1]):
        t0 = time.perf_counter()
        run.push(audio, [n], start=sum(chunks[:i]))
        push_s += time.perf_counter() - t0
        if (pending_header(bank) if protocol == "dstar"
                else i + 1 == len(chunks) // 2):
            cut = i + 1
            break
    check(cut is not None, f"{name}: no push ended where the snapshot is "
                           f"taken")
    blob = bank.snapshot()  # mid-stream; launches nothing
    at_cut = [len(v) for v in run.voice], [len(e) for e in run.events]
    t0 = time.perf_counter()
    run.push(audio, chunks[cut:], start=sum(chunks[:cut]))
    push_s += time.perf_counter() - t0
    steps = bank._meter.calls - meter_before
    tail = bank.samples.fill
    t0 = time.perf_counter()
    bank.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    counts = smoke.launch_counts()
    expect = dict.fromkeys(counts, 0)
    if protocol in TWO_FSK:  # no RRC: K3 steps, nothing to filter
        expect["none"] = steps
    else:
        expect.update(rrc=steps, fir=1)
    if protocol in ("ysf", "nxdn"):  # the other frame decodes launch none
        expect["viterbi"] = len(rounds)
    check(steps >= 3 and rounds and counts == expect,
          f"{name} launches {counts} in {steps} steps and {len(rounds)} "
          f"decode rounds, want {expect}")
    check(tail == stream.flush_tail,
          f"{name} flush tail {tail}, the fixture (and K4, where there is an "
          f"RRC) was built for {stream.flush_tail}")
    check(set(rounds) == {bank._batch},
          f"{name}: decode batches {set(rounds)}, K5 was compared and timed "
          f"at the padded batch of {bank._batch} frames")
    voice, events = run.outputs()
    check_bank_outputs(name, voice, events, want, variant)

    # the snapshot, restored into a fresh bank, gives the same remainder
    _, second = make_bank()
    second.restore(blob)
    rerun = BankRun(second, CHANNELS)
    rerun.push(audio, chunks[cut:], start=sum(chunks[:cut]))
    second.flush()
    voice2, events2 = rerun.outputs()
    for c in range(CHANNELS):
        check(voice2[c] == voice[c][at_cut[0][c]:]
              and events2[c] == "".join(run.events[c][at_cut[1][c]:]),
              f"{name} channel {c}: the restored bank's remainder differs")

    # the plain ChannelBank with a symbol-domain Decoder per channel
    pipe3 = bank_pipeline(kind, protocol, PLAIN_BANK_CHANNELS, stream)
    plain = BankRun(ChannelBank(pipe3, [make_decoder() for _ in
                                        range(PLAIN_BANK_CHANNELS)]),
                    PLAIN_BANK_CHANNELS)
    plain.push(audio[:PLAIN_BANK_CHANNELS], chunks)
    plain.bank.flush()
    voice3, events3 = plain.outputs()
    check(voice3 == voice[:PLAIN_BANK_CHANNELS]
          and events3 == events[:PLAIN_BANK_CHANNELS],
          f"{name}: the plain ChannelBank differs from the tracked bank")

    def push_all():
        _, fresh = make_bank()
        BankRun(fresh, CHANNELS).push(audio, chunks)

    where = (f"after push {cut} of {len(chunks)}"
             + (", a header decode pending" if protocol == "dstar" else ""))
    summary = (f"{steps} steps x {CHANNELS} ch x {stream.n_centuries} "
               f"centuries (sps {stream.sps}) in {len(chunks)} pushes, "
               f"{len(rounds)} decode rounds (padded to {bank._batch} "
               f"frames), flush of a {tail}-sample tail; voice bytes "
               f"{sum(len(v) for v in voice)}, events "
               f"{sum(len(e) for e in run.events)}; every channel equals "
               f"the JAX bank's; snapshot ({where}) restored: remainder "
               f"equal; plain ChannelBank equal on {PLAIN_BANK_CHANNELS} ch")
    return (counts, summary, push_all, push_s / steps, flush_s, steps,
            len(rounds), voice)


def profile_bank(name, push_all, steps):
    """Kernels, device time, idle share and waits on the stream per step
    of a bank's pushes (the whole stream through a fresh bank, no flush),
    from torch.profiler."""
    from digiham_tpu_torch.bench import common

    session, wall = common.profiled(push_all, torch.device("cuda"))
    prof, kernels = session.prof, session.events
    wall_ms = wall * 1e3 / steps
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    check(kernels and busy_ms > 0, f"profile of {name}: no device time")
    # every blocking copy (Tensor.cpu(), Tensor.to(device) from pageable
    # memory) is a copy event and a wait for the stream
    waits = sum(e.name == "cudaStreamSynchronize" for e in prof.events())
    fetches = sum("Memcpy DtoH" in e.name for e in kernels)
    uploads = sum("Memcpy HtoD" in e.name for e in kernels)
    check(waits > 0 and fetches > 0, f"profile of {name}: no "
          "synchronisation seen")
    return {"path": name, "kernels_per_step": len(kernels) / steps,
            "synchronisations_per_step": waits / steps,
            "device_to_host_copies_per_step": fetches / steps,
            "host_to_device_copies_per_step": uploads / steps,
            "device_busy_ms_per_step": busy_ms,
            "wall_ms_per_step": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms}


BANK_HOST_PARTS = (  # (label, file ending, function) of the bank's push
    ("push", "tracked_bank.py", "push"),
    ("pipeline.step_symbols", ("bank.py", "fsk.py"), "step_symbols"),
    ("block to the device (Tensor.to)", "", "<method 'to' of "
     "'torch._C.TensorBase' objects>"),
    ("fetches (Tensor.cpu)", "", "<method 'cpu' of 'torch._C.TensorBase' "
     "objects>"),
    ("_consume_dibits", "tracked_bank.py", "_consume_dibits"),
    ("_fast_skip", "tracked_bank.py", "_fast_skip"),
    ("_hunt", "tracked_bank.py", "_hunt"),
    ("_decode_round", "tracked_bank.py", "_decode_round"),
    ("decode_fields", "tracked_bank.py", "decode_fields"),
    ("field_row", "tracked_bank.py", "field_row"),
    ("process_fields", "fields_phase.py", "process_fields"),
    ("host Viterbi (YSF rare frames, D-Star headers)", "viterbi.py",
     "viterbi_decode_np"),
    ("host Viterbi, numpy (phase 5's numpy turns)", "viterbi.py",
     "viterbi_decode_np_plain"),
    ("D-Star header parse", "header.py", "parse_from_header"),
    ("rrc_rebase_history", "stream.py", "rrc_rebase_history"),
    ("SampleBuffer.push", "stream.py", "push"),
    ("SampleBuffer.consume", "stream.py", "consume"),
    ("pipe receive (a MultiStreamBank worker)", "connection.py",
     "_recv_bytes"),
)


def profile_bank_host(name, push_all, steps):
    """Where the host spends a bank step: cumulative milliseconds per step
    of the named functions under cProfile (which slows the Python-heavy
    parts, so the shares are an ordering, not a timing)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(push_all)
    return dict(path=name, what="host ms per step under cProfile",
                **host_parts(pstats.Stats(prof).stats, steps))


def host_parts(stats, steps):
    """Cumulative ms per step of BANK_HOST_PARTS in pstats' table."""
    out = {}
    for label, ending, function in BANK_HOST_PARTS:
        total = sum(ct for (path, _, fn), (_, _, _, ct, _) in stats.items()
                    if fn == function and path.endswith(ending))
        out[label] = total * 1e3 / steps
    return out


def profile_multistream(smoke, steps):
    """What one MultiStreamBank worker costs a DMR step beyond the bank in
    this process (dmr_bank's fixture at 256 channels): the pushes through
    MultiStreamBank(n_procs=1), its worker under cProfile
    (smoke.profile_worker) with torch's threads as they are and at 1,
    beside the bank in this process under cProfile (after one run that
    warms it): wall ms per step and host ms per step by part, and the
    parent's pickling of the largest push."""
    import cProfile
    import functools
    import pickle
    import pstats

    from digiham_tpu_torch.pipeline import DmrPipeline
    from digiham_tpu_torch.runtime.multistream import MultiStreamBank
    from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

    stream, _, audio, chunks, _, _ = bank_fixture(smoke, "DMR_BANK")
    out = {"path": "multistream_dmr n_procs 1", "what": "host ms per step "
           "under cProfile (wall ms per step under it too)"}
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    try:
        for threads in (None, 1):
            with MultiStreamBank(
                    "dmr", CHANNELS, 1,
                    pipeline_kwargs={"n_centuries": stream.n_centuries,
                                     "sps": stream.sps},
                    worker_init=functools.partial(smoke.profile_worker,
                                                  str(workdir), threads)
                    ) as ms:
                ms.prewarm(max(chunks))
                t0, lo = time.perf_counter(), 0
                for n in chunks:
                    ms.push(audio[:, lo:lo + n])
                    lo += n
                wall = (time.perf_counter() - t0) * 1e3 / steps
                ms.flush()
                used = ms.worker_info[0]["threads"]
            stats = pstats.Stats(str(workdir / "worker-0.prof")).stats
            out[f"worker, {used} torch threads"] = dict(
                wall_ms_per_step=wall, **host_parts(stats, steps))
        for warm in (False, True):
            bank = TrackedChannelBank(DmrPipeline(
                CHANNELS, sps=stream.sps, n_centuries=stream.n_centuries))
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.runcall(BankRun(bank, CHANNELS).push, audio, chunks)
            wall = (time.perf_counter() - t0) * 1e3 / steps
        out["this process (warm)"] = dict(
            wall_ms_per_step=wall,
            **host_parts(pstats.Stats(prof).stats, steps))
        t0 = time.perf_counter()
        blob = pickle.dumps(("push", audio[:, :max(chunks)]))
        out["parent pickles the largest push"] = {
            "ms": (time.perf_counter() - t0) * 1e3, "bytes": len(blob)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def nxdn_frames(pipe, dibits):
    """The 192-symbol frames of a block's dibits through
    nxdn_decode_frames, as the tracked bank cuts them."""
    from digiham_tpu_torch.pipeline import nxdn_decode_frames

    n = pipe.symbols_per_block // 192
    return nxdn_decode_frames(
        dibits[:, :n * 192].reshape(pipe.channels, n, 192), pipe.tables())


def kernel_device_ms(fn, kernel_name, runs=10):
    """Mean device time of the kernel named ``kernel_name`` over ``runs``
    calls of fn, from torch.profiler (CUDA events around back-to-back
    calls include the host's gaps when the wrapper is slower than the
    kernel)."""
    from digiham_tpu_torch.bench import common

    fn()
    session, _ = common.profiled(lambda: [fn() for _ in range(runs)],
                                 torch.device("cuda"))
    device = session.events
    events = [e for e in device if kernel_name in e.name]
    check(len(events) == runs,
          f"profile: {len(events)} {kernel_name} kernels in {runs} calls; "
          f"the device events seen: {sorted({e.name[:60] for e in device})}")
    return sum(e.device_time for e in events) / 1e3 / runs


def profile_steps(name, step, steps=5):
    """Kernels and device time per step from torch.profiler."""
    from digiham_tpu_torch.bench import common

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    session, _ = common.profiled(lambda: [step() for _ in range(steps)],
                                 torch.device("cuda"))
    kernels = session.events
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    check(kernels and busy_ms > 0, f"profile of {name}: no device time")
    return {"path": name, "kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms,
            "host_enqueue_ms_per_step": enqueue_ms,
            "wall_ms_per_step": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms}


# --- serving and scale-out --------------------------------------------------

# MultiStreamBank paths: (name, bank fixture, protocol); the checked run
# spreads the 256 channels over MULTISTREAM_PROCS workers, phase 5 also
# times MULTISTREAM_TIMED_PROCS
MULTISTREAM = (("multistream_dmr", "DMR_BANK", "dmr"),
               ("multistream_ysf", "YSF_BANK", "ysf"),
               ("multistream_dstar", "DSTAR_BANK", "dstar"))
MULTISTREAM_PROCS = 4
MULTISTREAM_TIMED_PROCS = (1, 2)
# the (channel, time) mesh of the scale-out paths: one card named four times
MESH = (2, 2)
# TimeShardedTrackedBank paths: (name, bank fixture, protocol, centuries a
# time shard; at least one whole step on each fixture, frame-aligned for
# DMR and YSF)
TIMESHARDED = (("timesharded_dmr", "DMR_BANK", "dmr", 36),
               ("timesharded_ysf", "YSF_BANK", "ysf", 24),
               ("timesharded_nxdn", "NXDN_BANK", "nxdn", 8),
               ("timesharded_dstar", "DSTAR_BANK", "dstar", 16),
               ("timesharded_pocsag", "POCSAG_BANK", "pocsag", 8))
ADAPTERS = {"dmr": "DmrAdapter", "ysf": "YsfAdapter", "nxdn": "NxdnAdapter",
            "dstar": "DstarAdapter", "pocsag": "PocsagAdapter"}


def card_mesh(shape):
    """A (channel, time) mesh of this shape naming the card at every
    slot."""
    from digiham_tpu_torch.parallel import make_mesh

    return make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))


def bank_fixture(smoke, stream_name):
    """(stream, fixture, its FM audio over CHANNELS channels with the
    variants tiled, push chunks, (voice, events) per variant, variant per
    channel)."""
    stream = getattr(smoke, stream_name)
    fx = smoke.load(stream)
    variants = fx["tx_dibits"].shape[0]
    variant = np.arange(CHANNELS) % variants
    audio = np.ascontiguousarray(smoke.bank_audio(stream, fx)[variant])
    want = [smoke.bank_expected(fx, v) for v in range(variants)]
    return (stream, fx, audio, [int(n) for n in fx["chunks"]], want,
            variant)


def check_bank_outputs(name, voice, events, want, variant):
    for c in range(CHANNELS):
        check((voice[c], events[c]) == want[variant[c]],
              f"{name} channel {c} (variant {variant[c]}): voice bytes or "
              f"events differ from the JAX bank's")


def open_multistream(smoke, stream, protocol, n_procs, supervise=False):
    """Start a MultiStreamBank of n_procs workers on the card at the bank
    fixture's geometry; each worker runs smoke.record_worker into a
    directory of its own (events to files, launch counts restarted after
    the prewarm's restore, written after the flush). Returns what
    :func:`drive_multistream` takes, with the start (spawn to every
    worker's first reply)."""
    import functools

    from digiham_tpu_torch.runtime.multistream import MultiStreamBank

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_multistream_"))
    voice = [b""] * CHANNELS

    def on_output(c, data):
        voice[c] += data

    t0 = time.perf_counter()
    bank = MultiStreamBank(
        protocol, CHANNELS, n_procs, on_output=on_output,
        pipeline_kwargs={"n_centuries": stream.n_centuries,
                         "sps": stream.sps},
        supervise=supervise, replay_limit=2,
        worker_init=functools.partial(smoke.record_worker, str(workdir)))
    return {"bank": bank, "workdir": workdir, "voice": voice,
            "start_s": time.perf_counter() - t0}


def open_many(smoke, specs):
    """Start several MultiStreamBanks at once (their workers' starts
    overlap; each records how many workers started with it): specs of
    (stream, protocol, n_procs, supervise)."""
    with ThreadPoolExecutor(len(specs)) as pool:
        banks = list(pool.map(lambda spec: open_multistream(smoke, *spec),
                              specs))
    for bank in banks:
        bank["started_with"] = sum(spec[2] for spec in specs)
    return banks


def drive_multistream(smoke, opened, audio, chunks, kill_at=None,
                      flush=True):
    """An opened MultiStreamBank over the bank fixture: prewarm (one
    silence block of the largest push, rolled back), the pushes, flush
    (unless a timing run leaves it out), close. With ``kill_at`` (a
    supervised bank) worker 1 is SIGKILLed just before that push. Returns
    the voice bytes per channel, the events per channel, the workers'
    launches summed and the times."""
    import signal

    ms, workdir = opened["bank"], opened["workdir"]
    try:
        with ms:
            t0 = time.perf_counter()
            ms.prewarm(max(chunks))
            prewarm_s = time.perf_counter() - t0
            push_s, lo, killed = 0.0, 0, None
            for i, n in enumerate(chunks):
                if i == kill_at:
                    killed = ms._procs[1].pid
                    os.kill(killed, signal.SIGKILL)
                    ms._procs[1].join(timeout=30)
                t0 = time.perf_counter()
                ms.push(audio[:, lo:lo + n])
                push_s += time.perf_counter() - t0
                lo += n
            t0 = time.perf_counter()
            if flush:
                ms.flush()
            flush_s = time.perf_counter() - t0
            check(kill_at is None or ms._procs[1].pid != killed,
                  "the killed worker was never respawned")
            info = list(ms.worker_info)
            starts = list(ms.start_seconds)
        events, launches = smoke.read_worker_records(str(workdir), CHANNELS)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"voice": opened["voice"], "events": events,
            "launches": launches, "start_s": opened["start_s"],
            "started_with": opened.get("started_with", len(starts)),
            "worker_start_s": starts, "prewarm_s": prewarm_s,
            "push_s": push_s, "flush_s": flush_s,
            "threads": [i["threads"] for i in info],
            "devices": sorted({i["device"] for i in info})}


def run_multistream_paths(smoke, steps):
    """Every MULTISTREAM path at 256 channels on the card. All their banks
    start in one :func:`open_many` (the spawns overlap, paid once): for
    each path a checked bank of MULTISTREAM_PROCS, a supervised one of as
    many and the timing banks of MULTISTREAM_TIMED_PROCS. The checked and
    timing banks are driven one at a time (phase 5 reports their times):
    every channel's bytes and events of the checked run equal the JAX
    bank's (the events written by each worker), the workers' launches are
    K2 once a step and K4 once a flush each (K5 once a YSF decode round;
    2FSK: K3 once a step and nothing else), ``steps[name]`` the single
    bank's; the timing runs push the stream (no flush) and must give a
    prefix of those bytes. Then the supervised banks run together (their
    respawns overlap), worker 1 SIGKILLed before the middle push, and must
    give the same bytes. Returns name -> (launches, summary, runs by worker
    count)."""
    fixtures = {name: bank_fixture(smoke, stream_name)
                for name, stream_name, _ in MULTISTREAM}
    sizes = (MULTISTREAM_PROCS, MULTISTREAM_PROCS, *MULTISTREAM_TIMED_PROCS)
    opened = iter(open_many(smoke, [
        (fixtures[name][0], protocol, n, k == 1)
        for name, _, protocol in MULTISTREAM for k, n in enumerate(sizes)]))
    banks = {name: [next(opened) for _ in sizes]
             for name, _, _ in MULTISTREAM}
    results = {}
    for name, _, protocol in MULTISTREAM:
        stream, fx, audio, chunks, want, variant = fixtures[name]
        checked, _, *timed = banks[name]
        run = drive_multistream(smoke, checked, audio, chunks)
        check(all(d.startswith("cuda") for d in run["devices"]),
              f"{name}: workers on {run['devices']}")
        check_bank_outputs(name, run["voice"], run["events"], want, variant)
        counts = run["launches"]
        expect = dict.fromkeys(counts, 0)
        if protocol in TWO_FSK:
            expect["none"] = MULTISTREAM_PROCS * steps[name]
        else:
            expect.update(rrc=MULTISTREAM_PROCS * steps[name],
                          fir=MULTISTREAM_PROCS)
        if protocol == "ysf":
            expect["viterbi"] = counts.get("viterbi", 0)
            check(expect["viterbi"] >= MULTISTREAM_PROCS,
                  f"{name}: K5 launched {expect['viterbi']} times")
        check(counts == expect, f"{name} launches {counts}, want {expect}")
        runs = {MULTISTREAM_PROCS: run}
        for n_procs, bank in zip(MULTISTREAM_TIMED_PROCS, timed):
            # timing runs: the pushes only (the checked run flushed)
            runs[n_procs] = drive_multistream(smoke, bank, audio, chunks,
                                              flush=False)
            voice = runs[n_procs]["voice"]
            check(all(want[variant[c]][0].startswith(voice[c])
                      for c in range(CHANNELS)) and any(voice),
                  f"{name} at n_procs {n_procs}: bytes differ")
        results[name] = (counts, run, runs)

    def supervised(name):
        chunks = fixtures[name][3]
        return drive_multistream(smoke, banks[name][1], fixtures[name][2],
                                 chunks, kill_at=len(chunks) // 2)

    names = [name for name, _, _ in MULTISTREAM]
    with ThreadPoolExecutor(len(names)) as pool:
        killed = dict(zip(names, pool.map(supervised, names)))
    out = {}
    for name, _, protocol in MULTISTREAM:
        _, _, _, chunks, want, variant = fixtures[name]
        counts, run, runs = results[name]
        kill_at = len(chunks) // 2
        for c in range(CHANNELS):
            check(killed[name]["voice"][c] == want[variant[c]][0],
                  f"{name} channel {c}: the supervised run with worker 1 "
                  f"killed before push {kill_at} differs")
        out[name] = (counts, (
            f"MultiStreamBank({protocol!r}, {CHANNELS} ch, n_procs "
            f"{MULTISTREAM_PROCS}) on the card, {len(chunks)} pushes x "
            f"{steps[name]} steps a worker; every channel's bytes and events "
            f"(written by the workers) equal the JAX bank's; supervised with "
            f"worker 1 SIGKILLed before push {kill_at} (the {len(names)} "
            f"supervised banks driven together): bytes equal; n_procs "
            f"{MULTISTREAM_TIMED_PROCS} (timing, no flush): a prefix of "
            f"them; torch threads a worker {run['threads']}"), runs)
    return out


def run_timesharded_path(smoke, name, stream_name, protocol, cps):
    """TimeShardedTrackedBank over TimeShardedPipeline on a (2, 2) mesh
    naming the card four times, at 256 channels, fed the bank fixture:
    bytes and events equal the JAX bank's. Launches: per step K4 once (the
    four slots' segments with their halos in one launch; none for 2FSK),
    K3 once a time shard (the carry ring's rounds, two channel shards a
    launch), K5 once for YSF's frame fields; then K5 once a YSF/NXDN
    decode round that found frames and K4 once in the flush. Returns
    (launches, summary, wall seconds a step, flush seconds, steps, a
    closure that pushes the stream through a fresh bank, no flush)."""
    from digiham_tpu_torch.parallel.streaming import TimeShardedPipeline
    from digiham_tpu_torch.runtime import tracked_bank

    stream, fx, audio, chunks, want, variant = bank_fixture(smoke,
                                                            stream_name)
    sp = TimeShardedPipeline(card_mesh(MESH), CHANNELS, protocol,
                             sps=stream.sps, centuries_per_shard=cps)
    adapter = getattr(tracked_bank, ADAPTERS[protocol])()
    rounds = []
    decode = adapter.decode_fields

    def decode_fields(frames, pipeline):
        rounds.append(len(frames))
        return decode(frames, pipeline)

    adapter.decode_fields = decode_fields
    bank = tracked_bank.TimeShardedTrackedBank(sp, adapter=adapter)
    check(bank.device.type == "cuda", f"{name}: the bank is not on the card")
    run = BankRun(bank, CHANNELS)
    before = bank._meter.calls
    smoke.reset_launch_counts()
    t0 = time.perf_counter()
    run.push(audio, chunks)
    push_s = time.perf_counter() - t0
    steps = bank._meter.calls - before
    tail = bank.samples.fill
    t0 = time.perf_counter()
    bank.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    counts = smoke.launch_counts()
    n_time = MESH[1]
    expect = dict.fromkeys(counts, 0)
    expect["none"] = steps * n_time
    if protocol not in TWO_FSK:
        expect["fir"] = steps + 1
    if protocol in ("ysf", "nxdn"):
        expect["viterbi"] = len(rounds) + (steps if protocol == "ysf" else 0)
    check(steps >= 1 and counts == expect,
          f"{name} launches {counts} in {steps} steps and {len(rounds)} "
          f"decode rounds, want {expect}")
    check_bank_outputs(name, *run.outputs(), want, variant)
    summary = (f"TimeShardedTrackedBank on a {MESH} mesh of the card, "
               f"{CHANNELS} ch x {n_time} time shards x {cps} centuries "
               f"(block {sp.block_len} samples, halos {sp.h_left} / "
               f"{sp.h_right}); {steps} steps, {len(rounds)} decode rounds, "
               f"a flush of {tail} samples (the first {sp.h_left} the left "
               f"edge); every channel's bytes and events equal the JAX "
               f"bank's")

    def push_all():
        fresh = tracked_bank.TimeShardedTrackedBank(
            sp, adapter=getattr(tracked_bank, ADAPTERS[protocol])())
        BankRun(fresh, CHANNELS).push(audio, chunks)

    return counts, summary, push_s / steps, flush_s, steps, push_all


def run_mesh_bank(smoke, stream_name="DMR_BANK"):
    """TrackedChannelBank(DmrPipeline(256 ch), mesh=(4, 1) naming the card
    four times): each channel shard's 64 rows step (K2) and decode on the
    card through a copy of the pipeline; bytes and events equal the JAX
    bank's; K2 once a step a shard, K4 once a shard in the flush. Returns
    (launches, summary, steps, a closure that pushes the stream through a
    fresh bank, no flush)."""
    from digiham_tpu_torch.pipeline import DmrPipeline
    from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

    stream, fx, audio, chunks, want, variant = bank_fixture(smoke,
                                                            stream_name)
    shape = (4, 1)

    def make_bank():
        return TrackedChannelBank(
            DmrPipeline(CHANNELS, sps=stream.sps,
                        n_centuries=stream.n_centuries),
            mesh=card_mesh(shape))

    bank = make_bank()
    run = BankRun(bank, CHANNELS)
    before = bank._meter.calls
    smoke.reset_launch_counts()
    run.push(audio, chunks)
    bank.flush()
    torch.cuda.synchronize()
    steps = bank._meter.calls - before
    counts = smoke.launch_counts()
    expect = dict(dict.fromkeys(counts, 0), rrc=shape[0] * steps,
                  fir=shape[0])
    check(counts == expect, f"mesh_bank_dmr launches {counts}, want {expect}")
    check_bank_outputs("mesh_bank_dmr", *run.outputs(), want, variant)
    summary = (f"TrackedChannelBank(DmrPipeline({CHANNELS} ch, "
               f"{stream.n_centuries} centuries), mesh={shape} of the card), "
               f"{steps} steps; every channel's bytes and events equal the "
               f"JAX bank's")
    return (counts, summary, steps,
            lambda: BankRun(make_bank(), CHANNELS).push(audio, chunks))


# the bulk steps: (name, bank fixture, protocol)
SHARDED = (("sharded_dmr", "DMR_BANK", "dmr"),
           ("sharded_ysf", "YSF_BANK", "ysf"),
           ("sharded_nxdn", "NXDN_BANK", "nxdn"),
           ("sharded_dstar", "DSTAR_BANK", "dstar"),
           ("sharded_pocsag", "POCSAG_BANK", "pocsag"))


def sharded_reference(x, protocol, n_cent, sps, n_time):
    """The port's own single-device computation of a bulk step: the RRC
    over the whole row from a zero history, then per time shard a demod
    from a fresh state, the sync statistics and the frame decode. Returns
    (fields as the sharded step returns them, hits)."""
    from digiham_tpu_torch.dsp.demod import (demod_init, fsk_demod_block,
                                             gfsk_demod_block)
    from digiham_tpu_torch.dsp.rrc import RrcState, rrc_filter_block
    from digiham_tpu_torch.parallel import sharded
    from digiham_tpu_torch.pipeline.fsk import (bit_sync_correlate,
                                                dstar_decode_frames,
                                                pocsag_decode_frames)
    from digiham_tpu_torch.protocols.dstar.phases import (HEADER_SYNC,
                                                          VOICE_SYNC)
    from digiham_tpu_torch.protocols.pocsag import SYNC_PATTERN

    C, T = x.shape
    seg = T // n_time
    dev = x.device
    outs, hits = [], torch.zeros(C, dtype=torch.int64, device=dev)
    if protocol in TWO_FSK:
        for t in range(n_time):
            xs = x[:, t * seg:(t + 1) * seg]
            bits, _ = fsk_demod_block(xs, demod_init(C, dev), n_cent, sps,
                                      protocol == "pocsag")
            if protocol == "dstar":
                hits += ((bit_sync_correlate(bits, HEADER_SYNC) <= 2)
                         | (bit_sync_correlate(bits, VOICE_SYNC) <= 1)).sum(
                             -1)
                n = (bits.shape[1] - 24) // 96
                windows = torch.stack(
                    [bits[:, i * 96:i * 96 + 120] for i in range(n)], dim=1)
                outs.append({"voice": dstar_decode_frames(windows)["voice"]})
            else:
                hits += (bit_sync_correlate(bits, SYNC_PATTERN) <= 3).sum(-1)
                n = bits.shape[1] // 32
                outs.append({"ok": pocsag_decode_frames(
                    bits[:, :n * 32].reshape(C, n, 32))["ok"]})
        return {k: torch.cat([o[k] for o in outs], 1) for k in outs[0]}, hits
    design, _, frame_size, sync_fn, decode_fn, kind = sharded._gfsk_config(
        protocol)
    tables = sharded.device_tables(kind, str(dev))
    y, _ = rrc_filter_block(x, RrcState.init(C, design, dev), design)
    for t in range(n_time):
        dibits, _ = gfsk_demod_block(y[:, t * seg:(t + 1) * seg],
                                     demod_init(C, dev), n_cent, sps)
        hit = sync_fn(dibits, tables) <= 3
        hits += hit.reshape(C, -1).sum(-1)
        n = dibits.shape[1] // frame_size
        outs.append(decode_fn(dibits[:, :n * frame_size].reshape(
            C, n, frame_size), tables))
    return {k: torch.cat([o[k] for o in outs], 1) for k in outs[0]}, hits


def sharded_input(smoke, stream_name, dev):
    """The bulk steps' input: the bank fixture's audio of 256 channels, two
    time shards of n_centuries*(100*sps+1)+1 samples each."""
    stream, _, audio, _, _, _ = bank_fixture(smoke, stream_name)
    seg = stream.n_centuries * (100 * stream.sps + 1) + 1
    return stream, torch.from_numpy(
        np.ascontiguousarray(audio[:, :MESH[1] * seg])).to(dev)


def run_sharded_path(smoke, name, stream_name, protocol, dev):
    """A bulk step on the (2, 2) mesh of the card at 256 channels: fields
    and sync hits equal the port's own single-device computation per time
    shard; K4 once (4FSK; every slot's segment with its halo), K3 once
    (fresh states, every slot), K5 once for YSF and NXDN. DMR also through
    sharded_pipeline_step and sharded_rrc_filter (equal to the whole row's
    RRC). Returns (launches, summary, the input, a closure that runs the
    bulk step again)."""
    from digiham_tpu_torch.dsp.rrc import RrcState, rrc_filter_block
    from digiham_tpu_torch.parallel import (sharded_fsk_step,
                                            sharded_gfsk_step,
                                            sharded_pipeline_step,
                                            sharded_rrc_filter)

    stream, x = sharded_input(smoke, stream_name, dev)
    mesh = card_mesh(MESH)
    n_cent = stream.n_centuries

    def step():
        if protocol in TWO_FSK:
            out, hits = sharded_fsk_step(mesh, x, protocol, n_cent)
            return {"voice" if protocol == "dstar" else "ok": out}, hits
        return sharded_gfsk_step(mesh, x, protocol, n_cent)

    torch.cuda.synchronize()
    smoke.reset_launch_counts()
    fields, hits = step()
    torch.cuda.synchronize()
    counts = smoke.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect["none"] = 1
    if protocol not in TWO_FSK:
        expect["fir"] = 1
    if protocol in ("ysf", "nxdn"):
        expect["viterbi"] = 1
    check(counts == expect, f"{name} launches {counts}, want {expect}")
    want, want_hits = sharded_reference(x, protocol, n_cent, stream.sps,
                                        MESH[1])
    for k, w in want.items():
        check(torch.equal(fields[k], w), f"{name} field {k} differs from "
                                         f"the single-device computation")
    check(torch.equal(hits.to(torch.int64), want_hits),
          f"{name} sync hits differ")
    extra = ""
    if protocol == "dmr":
        voice, dmr_hits = sharded_pipeline_step(mesh, x, stream.sps, n_cent)
        check(torch.equal(voice, want["voice_payload"]),
              "sharded_pipeline_step voice differs")
        check(int(dmr_hits.sum()) > 0, "sharded_pipeline_step saw no sync")
        y = sharded_rrc_filter(mesh, x)
        whole, _ = rrc_filter_block(x, RrcState.init(CHANNELS, device=dev))
        check(torch.equal(y, whole), "sharded_rrc_filter differs from the "
                                     "whole row's RRC")
        extra = ("; sharded_pipeline_step's voice equal, sharded_rrc_filter"
                 " equal to the whole row's RRC bit for bit")
    summary = (f"{MESH} mesh of the card, {CHANNELS} ch x {MESH[1]} time "
               f"shards of {x.shape[1] // MESH[1]} samples ({n_cent} "
               f"centuries, sps {stream.sps}); fields ({', '.join(want)}) "
               f"and sync hits ({int(want_hits.sum())}) equal the port's "
               f"single-device computation per time shard{extra}")
    return counts, summary, x, step


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_distributed(smoke, x, dev, profile=False):
    """torch.distributed on the card: init_distributed with NCCL at world
    size 1 (TCP store on localhost), global_channel_mesh over four slots
    naming the card, this process's rows through make_global_array, one
    sharded_pipeline_step equal to the in-process mesh's result. Returns
    (launches, summary, and with ``profile`` the step's kernels, device
    time and idle share, taken before the process group goes)."""
    import torch.distributed as dist

    from digiham_tpu_torch.parallel import distributed, sharded_pipeline_step

    stream = smoke.DMR_BANK
    want = sharded_pipeline_step(card_mesh(MESH), x, stream.sps,
                                 stream.n_centuries)
    port = free_port()
    distributed.init_distributed(f"localhost:{port}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = distributed.global_channel_mesh(
            n_time_shards=MESH[1], devices=["cuda:0"] * (MESH[0] * MESH[1]))
        check(mesh.shape == {"channel": MESH[0], "time": MESH[1]},
              f"global mesh {mesh.shape}")
        rows = distributed.local_channel_slice(CHANNELS)
        local = distributed.make_global_array(x[rows], mesh)
        torch.cuda.synchronize()
        smoke.reset_launch_counts()
        voice, hits = sharded_pipeline_step(mesh, local, stream.sps,
                                            stream.n_centuries)
        torch.cuda.synchronize()
        counts = smoke.launch_counts()
        profiled = profile and profile_steps(
            "distributed", lambda: sharded_pipeline_step(
                mesh, local, stream.sps, stream.n_centuries))
    finally:
        dist.destroy_process_group()
    check(torch.equal(voice, want[0]) and torch.equal(hits, want[1]),
          "the distributed step differs from the in-process mesh's")
    expect = dict(dict.fromkeys(counts, 0), fir=1, none=1)
    check(counts == expect, f"distributed launches {counts}, want {expect}")
    return counts, (f"init_distributed (NCCL, world size 1, TCP store on "
                    f"localhost:{port}), global_channel_mesh {mesh.shape} of "
                    f"the card, rows {rows.start}:{rows.stop} through "
                    f"make_global_array, sharded_pipeline_step equal to the "
                    f"in-process mesh's"), profiled


def scale_out_shapes(dev, smoke):
    """The shapes the serving and scale-out paths give K2-K5, for phase 3:
    K2 over a MultiStreamBank worker's rows (CHANNELS / MULTISTREAM_PROCS)
    at the DMR and YSF bank blocks, K3 over a worker's D-Star rows, K4 over
    a worker's DMR and YSF flush tails, K5 over a YSF worker's padded decode
    round (its rows x (frames of a block + 2), FICH and DCH); for each
    TIMESHARDED path, K3 over a ring round (the two channel shards' rows in
    one launch, a segment with its halos, pos drift_budget into it) and,
    with an RRC, K4 over the four slots' segments with their halos in one
    launch. The flush tails of the time-sharded banks and the mesh shards'
    decode rounds depend on the stream: :class:`KernelRecorder` replays
    those. Returns {"K2": {label: (args, kwargs)}, "K3": the same, "K4":
    {label: (channels, length, design)}, "K5": {label: segments}}."""
    from digiham_tpu_torch.dsp.rrc import WIDE_RRC
    from digiham_tpu_torch.parallel.streaming import TimeShardedPipeline

    per = CHANNELS // MULTISTREAM_PROCS
    out = {"K2": {}, "K3": {}, "K4": {}, "K5": {}}
    for i, stream in enumerate((smoke.DMR_BANK, smoke.YSF_BANK)):
        out["K2"][f"{stream.name} worker {per} ch x {stream.block_len}"] = (
            k2_args(dev, per, stream.block_len, stream.sps, WIDE_RRC,
                    FOUR_LEVELS, 60 + 2 * i),
            dict(n_centuries=stream.n_centuries, sps=stream.sps))
        out["K4"][f"{stream.name} worker flush tail {per} ch x "
                  f"{stream.flush_tail}, 81 taps"] = (per, stream.flush_tail,
                                                      WIDE_RRC)
    ds = smoke.DSTAR_BANK
    out["K3"][f"dstar_bank worker {per} ch x {ds.block_len}"] = (
        k3_args(dev, per, ds.block_len, ds.sps, TWO_LEVELS, 64),
        dict(n_centuries=ds.n_centuries, sps=ds.sps, mode="fsk",
             invert=False))
    ys = smoke.YSF_BANK
    frames = per * (ys.symbols_per_block // ys.frame_size + 2)
    out["K5"][f"ysf_bank worker decode round 2 x ({frames} x 100)"] = (
        (frames, 100, 0), (frames, 100, 0))
    for i, (name, stream_name, protocol, cps) in enumerate(TIMESHARDED):
        sp = TimeShardedPipeline(card_mesh(MESH), CHANNELS, protocol,
                                 sps=getattr(smoke, stream_name).sps,
                                 centuries_per_shard=cps)
        length = sp.drift_budget + sp.seg_len + sp.h_right
        fsk = sp.cfg.kind == "fsk"
        args = k3_args(dev, CHANNELS, length, sp.sps,
                       TWO_LEVELS if fsk else FOUR_LEVELS, 66 + 2 * i)
        args[1] = args[1] + (sp.drift_budget - 8)  # pos about the origin
        out["K3"][f"{name} ring round {CHANNELS} ch x {length}"] = (
            args, dict(n_centuries=cps, sps=sp.sps,
                       mode="fsk" if fsk else "gfsk", invert=sp.invert))
        if sp.use_rrc:
            rows = CHANNELS * MESH[1]
            out["K4"][f"{name} step {rows} ch x {length} (four slots' "
                      f"segments with halos), {sp.rrc_design.ntaps} taps"] = (
                rows, length, sp.rrc_design)
    return out


def _arg_key(a):
    """A wrapper argument's part of a call's signature: a tensor's shape,
    dtype, strides and alignment to 16 bytes; K5's segments as a tuple of
    (tensor, blocked steps); anything else as it is."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), tuple(a.stride()),
                a.data_ptr() % 16)
    if isinstance(a, (list, tuple)):
        return tuple((_arg_key(o), b) for o, b in a)
    return a


def _describe(key):
    """The leading argument of a signature, short: its shape, and where
    they apply the strides and the bytes it lies off a 16-byte boundary
    (K5's segments: each batch's shape)."""
    first = key[0]
    if isinstance(first[0], tuple) and isinstance(first[0][0], tuple):
        return " + ".join(f"{list(t[0])}" for t, _ in first)
    shape, _, stride, lead = first
    out = f"{list(shape)}"
    if stride != tuple(torch.empty(shape, device="meta").stride()):
        out += f" strides {list(stride)}"
    return out + (f" {lead} B off" if lead else "")


def _same_layout(t):
    """A copy of tensor ``t`` with its shape, strides and alignment to 16
    bytes (the kernels read rows as they lie)."""
    if not isinstance(t, torch.Tensor):
        return t
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    lead = (t.data_ptr() % 16) // t.element_size()
    out = torch.empty(span + lead, dtype=t.dtype, device=t.device)
    out = out.as_strided(t.shape, t.stride(), lead)
    out.copy_(t)
    return out


class KernelRecorder:
    """While active (a context manager), the wrappers of K1-K5 note every
    call by its signature (the wrapper, its tensors' shapes, dtypes,
    strides and alignment, its other arguments) and keep copies of the
    inputs of the first KEEP calls of each, taken before the call; the
    wrapper then runs as it would and counts its launch. :meth:`replay`
    holds each kept call's kernel against its plain version on those
    inputs: the shapes, views and carries the paths really gave it. The
    callers look the wrappers up at call time (``dsp/demod.py``,
    ``fec/viterbi.py``), except K4's, which ``dsp/rrc.py`` binds at import:
    that name is patched there."""

    KEEP = 2

    def __init__(self):
        from digiham_tpu_torch.dsp import rrc
        from digiham_tpu_torch.fec.viterbi import viterbi_decode_plain
        from digiham_tpu_torch.ops import demod_front, fir, viterbi

        def many_plain(segments, num_states=16):
            return [viterbi_decode_plain(o, num_states, b)
                    for o, b in segments]

        self.targets = (  # (label, module, name, plain version)
            ("K1", demod_front, "demod_fm_front",
             demod_front.demod_fm_front_plain),
            ("K2", demod_front, "demod_front", demod_front.demod_front_plain),
            ("K3", demod_front, "demod", demod_front.demod_plain),
            ("K4", rrc, "rrc_filter_block_kernel",
             fir.rrc_filter_block_plain),
            ("K5", viterbi, "viterbi16",
             lambda o, blocked_steps=0, num_states=16: viterbi_decode_plain(
                 o, num_states, blocked_steps)),
            ("K5", viterbi, "viterbi16_many", many_plain))
        self.calls = {}  # signature -> [count, [(args, kwargs), ...]]
        self.kernels = {}  # signature -> (label, wrapper, plain)

    def _wrap(self, label, wrapper, plain):
        def recorded(*args, **kw):
            key = (label, wrapper.__name__,
                   tuple(_arg_key(a) for a in args),
                   tuple(sorted(kw.items())))
            seen = self.calls.setdefault(key, [0, []])
            seen[0] += 1
            if len(seen[1]) < self.KEEP:
                kept = [[(_same_layout(o), b) for o, b in a]
                        if isinstance(a, (list, tuple)) else _same_layout(a)
                        for a in args]
                seen[1].append((kept, dict(kw)))
                self.kernels[key] = (label, wrapper, plain)
            return wrapper(*args, **kw)
        return recorded

    def __enter__(self):
        self.saved = [(module, name, getattr(module, name))
                      for _, module, name, _ in self.targets]
        for label, module, name, plain in self.targets:
            setattr(module, name, self._wrap(label, getattr(module, name),
                                             plain))
        return self

    def __exit__(self, *exc):
        for module, name, wrapper in self.saved:
            setattr(module, name, wrapper)

    def replay(self):
        """Each kept call's kernel against its plain version: demod
        decisions, pos and offset exact and floats within FLOAT_ATOL (as
        :func:`compare_demod`), K4 and K5 exactly. Returns (calls replayed,
        label -> ["shape x calls seen", ...])."""
        n, seen = 0, {}
        for key, (label, wrapper, plain) in self.kernels.items():
            for args, kw in self.calls[key][1]:
                what = f"{label} at {_describe(key[2])} {kw}"
                if label in ("K1", "K2", "K3"):
                    compare_demod(what, wrapper, plain, args, **kw)
                else:
                    got, want = wrapper(*args, **kw), plain(*args, **kw)
                    torch.cuda.synchronize()
                    if key[1] == "viterbi16_many":
                        got = [t for pair in got for t in pair]
                        want = [t for pair in want for t in pair]
                    check(all(g.dtype == w.dtype and torch.equal(g, w)
                              for g, w in zip(got, want)),
                          f"{what} differs from the plain version")
                n += 1
            seen.setdefault(label, []).append(
                f"{_describe(key[2])} x {self.calls[key][0]}")
        self.calls.clear()
        self.kernels.clear()
        return n, seen


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def recorder_turns(smoke, name="timesharded_nxdn"):
    """The time-sharded bank ``name``'s wall ms per step with
    KernelRecorder off and on (the fixture's pushes through a fresh bank,
    no flush), in turns off, on, on, off, then off and on each after
    ``torch.cuda.empty_cache()`` (the allocator gives its cached blocks
    back, so that turn's allocations reach the driver again), with what
    the recorder kept (signatures, calls, copies and their bytes) and
    what the caching allocator did in the turn (the blocks it had to get
    from the driver and the MB it reserved more); then one push of each
    under cProfile, the functions that took the most host time by their
    own time (ms per step)."""
    import contextlib
    import cProfile
    import pstats

    from digiham_tpu_torch.parallel.streaming import TimeShardedPipeline
    from digiham_tpu_torch.runtime import tracked_bank

    _, stream_name, protocol, cps = next(t for t in TIMESHARDED
                                         if t[0] == name)
    stream, fx, audio, chunks, _, _ = bank_fixture(smoke, stream_name)
    sp = TimeShardedPipeline(card_mesh(MESH), CHANNELS, protocol,
                             sps=stream.sps, centuries_per_shard=cps)

    def allocator():
        m = torch.cuda.memory_stats()
        return m.get("segment.all.allocated", 0), torch.cuda.memory_reserved()

    def push(recorded, prof=None):
        bank = tracked_bank.TimeShardedTrackedBank(
            sp, adapter=getattr(tracked_bank, ADAPTERS[protocol])())
        run = BankRun(bank, CHANNELS)
        rec = KernelRecorder()
        before = bank._meter.calls
        torch.cuda.synchronize()
        segments, reserved = allocator()
        t0 = time.perf_counter()
        with rec if recorded else contextlib.nullcontext():
            if prof is None:
                run.push(audio, chunks)
            else:
                prof.runcall(run.push, audio, chunks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        segments_after, reserved_after = allocator()
        steps = bank._meter.calls - before
        kept = [args for _, copies in rec.calls.values()
                for args, _ in copies]
        return {"ms_per_step": ms / steps, "steps": steps,
                "signatures": len(rec.calls),
                "calls": sum(n for n, _ in rec.calls.values()),
                "copies_kept": len(kept),
                "bytes_kept": nbytes(list(_tensors(kept))),
                "driver_allocations": segments_after - segments,
                "reserved_mb_more": (reserved_after - reserved) / 2 ** 20}

    out = {"path": name, "turns": []}
    for recorded, empty in ((False, False), (True, False), (True, False),
                            (False, False), (False, True), (True, True)):
        if empty:
            torch.cuda.empty_cache()
        out["turns"].append(dict(push(recorded), recorder=recorded,
                                 after_empty_cache=empty))
    for recorded in (False, True):
        prof = cProfile.Profile()
        steps = push(recorded, prof)["steps"]
        top = sorted(pstats.Stats(prof).stats.items(),
                     key=lambda kv: -kv[1][2])[:6]
        out[f"cprofile, recorder {'on' if recorded else 'off'}"] = {
            f"{Path(f).name}:{line}({fn})": tt * 1e3 / steps
            for (f, line, fn), (_, _, tt, _, _) in top}
    return out


def profile_multistream_device(smoke, steps):
    """Device time of each MULTISTREAM path's workers: MultiStreamBank(
    n_procs=MULTISTREAM_PROCS) on the card over the bank fixture at 256
    channels, every worker under smoke.device_profile_worker (torch.profiler
    from the end of prewarm to the flush). Per path: the parent's wall ms a
    step, each worker's kernels, device busy ms and push ms a step and its
    idle share, and the card's busy ms a step (the workers' summed) over
    the parent's wall; a run in which a worker's profiler lost records is
    taken again. ``steps[name]``: the single bank's steps."""
    from digiham_tpu_torch.bench.common import PROFILE_TRIES

    out = []
    for name, stream_name, protocol in MULTISTREAM:
        stream, _, audio, chunks, _, _ = bank_fixture(smoke, stream_name)
        for _ in range(PROFILE_TRIES):  # until no worker lost a record
            wall_ms, workers = _device_profiled_run(smoke, stream, protocol,
                                                    audio, chunks)
            if all(w["lost"] == 0 for w in workers):
                break
        n = steps[name]
        check(len(workers) == MULTISTREAM_PROCS
              and all(w["kernels"] and w["lost"] == 0 for w in workers),
              f"profile of {name}: a worker's profiler recorded no device "
              f"kernel or lost records in {PROFILE_TRIES} runs ({workers})")
        busy = sum(w["busy_ms"] for w in workers)
        out.append({
            "path": name, "n_procs": MULTISTREAM_PROCS,
            "wall_ms_per_step": wall_ms / n,
            "device_busy_ms_per_step": busy / n,
            "device_idle_share": 1 - busy / wall_ms,
            "workers": [{"kernels_per_step": w["kernels"] / n,
                         "device_busy_ms_per_step": w["busy_ms"] / n,
                         "push_ms_per_step": w["push_s"] * 1e3 / n,
                         "device_idle_share":
                             1 - w["busy_ms"] / (w["push_s"] * 1e3)}
                        for w in workers]})
    return out


def _device_profiled_run(smoke, stream, protocol, audio, chunks):
    """One MultiStreamBank run of profile_multistream_device: (the
    parent's wall ms over the pushes, each worker's record)."""
    import functools

    from digiham_tpu_torch.runtime.multistream import MultiStreamBank

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_device_"))
    try:
        with MultiStreamBank(
                protocol, CHANNELS, MULTISTREAM_PROCS,
                pipeline_kwargs={"n_centuries": stream.n_centuries,
                                 "sps": stream.sps},
                worker_init=functools.partial(smoke.device_profile_worker,
                                              str(workdir))) as ms:
            ms.prewarm(max(chunks))
            t0, lo = time.perf_counter(), 0
            for n in chunks:
                ms.push(audio[:, lo:lo + n])
                lo += n
            wall_ms = (time.perf_counter() - t0) * 1e3
            ms.flush()
        workers = []
        for f in sorted(workdir.glob("device-*.json")):
            with open(f) as fh:
                workers.append(json.load(fh))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return wall_ms, workers


# --- the measuring programs -------------------------------------------------

# (label, module, arguments, launches per step each line must show): each
# program once, at a short length
PROGRAMS = (
    ("headline", "digiham_tpu_torch.bench",
     ["--reps", "2", "--steps", "8", "--procs", "0"], [{"fm_rrc": 1.0}]),
    ("bench_protocols", "digiham_tpu_torch.bench.bench_protocols",
     ["--reps", "1", "--steps", "8"],
     [{"rrc": 1.0}, {"rrc": 1.0, "viterbi": 1.0}, {"rrc": 1.0},
      {"none": 1.0}, {"none": 1.0}]),
    ("bench_multistream", "digiham_tpu_torch.bench.bench_multistream",
     ["--procs", "2", "--steps", "8", "--reps", "2"],
     [[{"rrc": 1.0}, {"rrc": 1.0}]]),
    ("bench_latency", "digiham_tpu_torch.bench.bench_latency",
     ["--driver", "streamdriver", "--driver", "tracked", "--block", "16384",
      "--nc", "16", "--channels", str(CHANNELS)], None),
)


def run_programs(card):
    """Each of PROGRAMS as a process of its own on the card, all started
    together (their walls overlap): exit 0, every line ``correct`` with
    this card in its provenance, distinct rep checksums (the latency rows:
    every synthesized frame matched), the launches per step its path
    makes. Returns label -> (wall s, lines)."""

    def run(program):
        _, module, args, _ = program
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        return r, time.perf_counter() - t0

    with ThreadPoolExecutor(len(PROGRAMS)) as pool:
        done = list(pool.map(run, PROGRAMS))
    out = {}
    for (label, _, _, launches), (r, wall) in zip(PROGRAMS, done):
        lines = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith("{")]
        check(r.returncode == 0 and lines, f"{label} exited {r.returncode}: "
              f"{r.stderr[-2000:]} {r.stdout[-1000:]}")
        for i, line in enumerate(lines):
            what = f"{label} line {i}"
            check(line.get("correct") is True and line.get("card") == card
                  and line.get("backend") == "gpu",
                  f"{what}: correct {line.get('correct')}, card "
                  f"{line.get('card')!r}, backend {line.get('backend')}")
            if "rep_checksums" in line:
                flat = [c for cs in line["rep_checksums"]
                        for c in (cs if isinstance(cs, list) else [cs])]
                check(len(set(flat)) == len(flat),
                      f"{what}: rep checksums {flat} repeat")
            else:
                check(line["frames_matched"] > 0
                      and line["frames_missed"] == 0,
                      f"{what}: frames matched {line['frames_matched']}, "
                      f"missed {line['frames_missed']}")
            if launches is not None:
                check(line["launches_per_step"] == launches[i],
                      f"{what}: launches per step "
                      f"{line['launches_per_step']}, want {launches[i]}")
        out[label] = (wall, lines)
    return out


# --- K6 and the command line ------------------------------------------------

# the serial chain that bounds K6: the newest output enters the next
# sample's feedback sum as its last term, so the IIR waits on a multiply
# and two adds a sample, the DC blocker on a multiply and an add; each
# dependent float32 operation is taken as 4 cycles of the SM clock
CHAIN_OPS = {"iir": 3, "dc_block": 2}
FP32_LATENCY_CYCLES = 4
LSB_FULL_SCALE = 8  # K6 against the JAX function on full-scale input
K6_PLAIN_SAMPLES = 320  # the plain version is timed on this many samples
DSP_TOOLS = ("rrc_filter", "fsk_demodulator", "gfsk_demodulator",
             "digitalvoice_filter")
HOST_TOOLS = ("dmr_decoder", "ysf_decoder", "nxdn_decoder", "dstar_decoder",
              "pocsag_decoder", "mbe_synthesizer")
RRC_RTOL, RRC_ATOL = 1e-4, 2e-2  # the JAX tools' own two backends' envelope
# a tool in a process of its own, as its script runs it, reporting the
# launches of its kernels on stderr when it is done
TOOL_LAUNCH = """
import json, sys
from digiham_tpu_torch.cli import tools
from digiham_tpu_torch.ops import demod_front, fir, recurrence
main = getattr(tools, sys.argv[1] + "_main")
sys.argv = sys.argv[1:]
rc = main()
print("LAUNCHES " + json.dumps(dict(
    demod_front.LAUNCHES, fir=fir.LAUNCHES,
    iir=recurrence.LAUNCHES["digitalvoice_iir"])), file=sys.stderr)
sys.exit(rc)
"""
ROOT = Path(__file__).resolve().parent
START = time.perf_counter()  # the process's start, for its age


def k6_coeffs():
    from digiham_tpu_torch.dsp.audio import _FEEDBACK, _FORWARD, GAIN, SHRT_MAX

    return (_FORWARD, _FEEDBACK, SHRT_MAX, GAIN)


def k6_args(dev, channels, length, seed, pcm_dtype=torch.int16):
    """Seeded PCM from speech level to far past full scale (a gain drawn per
    channel), and random carries."""
    from digiham_tpu_torch.ops import variants

    return variants.k6_inputs(dev, "iir", channels, length, seed, pcm_dtype)


def dc_args(dev, channels, length, seed):
    from digiham_tpu_torch.ops import variants

    return variants.k6_inputs(dev, "dc_block", channels, length, seed)


def compare_k6(dev, iir_shapes, dc_shapes):
    """K6 against its plain version on the card, exactly, state included:
    the IIR at ``iir_shapes``, at T 0, 1, 9, 10, 11 and one, two and three
    tiles -1, +0, +1, at 1, 7, 31, 33, 255, 256 and 257 channels and where
    the channels a block takes step (the SM count times 1 and 2, +0 and +1,
    and times 16, -1, +0, +1), on int32 PCM past the int16 range and
    on rows of a wider array; the DC blocker at ``dc_shapes``, the same
    tile edges and channel counts, and on a strided view. Returns (largest
    difference, the number of shapes)."""
    from digiham_tpu_torch.ops import recurrence

    tile = recurrence.TILE
    sms = recurrence.sm_count(torch.cuda.current_device())
    edges = [(3, t) for t in [0, 1, 9, 10, 11] + [
        k * tile + d for k in (1, 2, 3) for d in (-1, 0, 1)]]
    widths = [(c, 1000) for c in (1, 7, 31, 33, 255, 256, 257)]
    # where the channels a block takes step (recurrence.block_rows)
    widths += [(k * sms + d, 333) for k, d in (
        (1, 0), (1, 1), (2, 0), (2, 1), (16, -1), (16, 0), (16, 1))]
    iir = [(c, t, torch.int16) for c, t in [*iir_shapes.values(), *edges,
                                            *widths]]
    iir += [(c, t, torch.int32) for c, t in ((1, 11), (17, 961), (256, 4000))]
    err, seed = 0, 600

    def same(got, want, what):
        for part, g, w in zip(("output", "carried input", "carried output"),
                              got, want):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and torch.equal(g, w),
                  f"K6 {what}: {part} differs from the plain version")

    for channels, length, dtype in iir:
        seed += 1
        args = k6_args(dev, channels, length, seed, dtype)
        before = recurrence.LAUNCHES["digitalvoice_iir"]
        got = recurrence.digitalvoice_iir(*args, *k6_coeffs())
        want = recurrence.digitalvoice_iir_plain(*args, *k6_coeffs())
        torch.cuda.synchronize()
        check(recurrence.LAUNCHES["digitalvoice_iir"]
              == before + (1 if length else 0), f"K6 launch count at T={length}")
        same(got, want, f"iir at {channels} ch x {length} {dtype}")
        if length:
            err = max(err, float((got[0].float() - want[0].float()).abs()
                                 .max()))
    wide = k6_args(dev, 5, 4000, 690)
    strided = [wide[0][:, 100:3100], *wide[1:]]
    same(recurrence.digitalvoice_iir(*strided, *k6_coeffs()),
         recurrence.digitalvoice_iir_plain(*strided, *k6_coeffs()),
         "iir on rows of a wider array")
    dc = [*dc_shapes.values(), *((c, t) for c, t in edges if t), *widths]
    for channels, length in dc:
        seed += 1
        args = dc_args(dev, channels, length, seed)
        before = recurrence.LAUNCHES["dc_block"]
        got = recurrence.dc_block(*args, 0.999)
        want = recurrence.dc_block_plain(*args, 0.999)
        torch.cuda.synchronize()
        check(recurrence.LAUNCHES["dc_block"] == before + 1,
              "K6 dc_block launch count")
        same(got, want, f"dc_block at {channels} ch x {length}")
    wide = dc_args(dev, 19, 2000, 790)
    strided = [wide[0][:, 1:1700], *wide[1:]]
    same(recurrence.dc_block(*strided, 0.999),
         recurrence.dc_block_plain(strided[0].contiguous(), *strided[1:],
                                   0.999), "dc_block on a strided view")
    return err, len(iir) + len(dc) + 2


def k6_time(dev, entry, channels, length, clock_hz, seed):
    """K6 entry's times at [channels, length]: CUDA events over back-to-back
    wrapper calls and the kernel's device time (profiler), beside the same
    of the earlier one-warp design (csrc/recurrence_serial.cu, launched
    uncounted through ops/variants.py), in turns: serial, split, split,
    serial. Also its plain version's time (timed on K6_PLAIN_SAMPLES samples
    and scaled to ``length``: a launch loop per sample) and its bound: the
    larger of the bytes over 3.35 TB/s and the serial chain, length x
    CHAIN_OPS dependent float32 operations x FP32_LATENCY_CYCLES at
    ``clock_hz``."""
    from digiham_tpu_torch.ops import build, recurrence, variants

    args = variants.k6_inputs(dev, entry, channels, length, seed)
    short = variants.k6_inputs(dev, entry, channels, K6_PLAIN_SAMPLES, seed)
    serial_lib = build.library(recurrence.SERIAL_SOURCE,
                               recurrence.SERIAL_SIGNATURES)
    if entry == "iir":
        kernel = lambda: recurrence.digitalvoice_iir(*args, *k6_coeffs())
    else:
        kernel = lambda: recurrence.dc_block(*args, 0.999)
    serial = lambda: variants.k6_call(serial_lib, entry, args, None)
    got, before = kernel(), serial()
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, before)),
          f"K6 {entry} at {channels} x {length}: the split and the serial "
          f"designs differ")
    split_name, serial_name = variants.K6_KERNELS[entry]
    runs = {"split": ([], []), "serial": ([], [])}
    for which in ("serial", "split", "split", "serial"):
        fn, name = ((kernel, split_name) if which == "split"
                    else (serial, serial_name))
        runs[which][0].append(time_ms(fn, 5, warmup=1))
        runs[which][1].append(kernel_device_ms(fn, name, runs=5))
    plain_ms = time_ms(lambda: variants.k6_plain(entry, short), 1,
                       warmup=1) * length / K6_PLAIN_SAMPLES
    moved = nbytes(args) + nbytes(got)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    ops = length * CHAIN_OPS[entry]
    by_chain = ops * FP32_LATENCY_CYCLES / clock_hz * 1e3
    mean = lambda v: None if None in v else sum(v) / len(v)
    return {"ms": mean(runs["split"][0]), "plain_ms": plain_ms,
            "bound_ms": max(by_bytes, by_chain),
            "bound_by": "operations" if by_chain >= by_bytes else "bytes",
            "bytes": moved, "operations": ops, "library_ms": None,
            "plain_timed_on": K6_PLAIN_SAMPLES,
            "device_ms": mean(runs["split"][1]),
            "serial_ms": mean(runs["serial"][0]),
            "serial_device_ms": mean(runs["serial"][1])}


def stage_launches(err_path):
    """The launch counts a tool's process reported, and its stderr."""
    text = Path(err_path).read_text()
    for line in text.splitlines():
        if line.startswith("LAUNCHES "):
            return json.loads(line[len("LAUNCHES "):]), text
    return None, text


def tool_env():
    """The environment of a tool's process: this checkout on its path."""
    return dict(os.environ, PYTHONPATH=str(ROOT))


def start_seconds(tool, args, stdin_path, timeout=300):
    """Wall seconds of one tool in a fresh interpreter (its script's
    entry), stdin from a file."""
    with open(stdin_path, "rb") as stdin:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", TOOL_LAUNCH, tool,
                               *args], stdin=stdin, capture_output=True,
                              cwd=ROOT, env=tool_env(), timeout=timeout)
        seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tool} {args} exited {proc.returncode}: "
          f"{proc.stderr.decode(errors='replace')[-2000:]}")
    return seconds


def tool_startups(smoke, workdir, server):
    """Each tool's wall time in a fresh process on a small input, twice in
    a row: cold (the first start of that tool in this run; the kernels are
    built already) and warm. The DSP tools take 2,048 samples on the card
    (the CUDA context, the library's load, one launch); the decoders an
    empty stream; mbe_synthesizer its -t check against the stand-in."""
    rng = np.random.default_rng(5)
    f32 = workdir / "startup.f32"
    (rng.normal(0, 800, 2048).astype(np.float32)).tofile(f32)
    s16 = workdir / "startup.s16"
    (rng.normal(0, 3000, 2048).astype(np.int16)).tofile(s16)
    empty = workdir / "startup.empty"
    empty.write_bytes(b"")
    out = {}
    for tool in DSP_TOOLS + HOST_TOOLS:
        if tool in DSP_TOOLS:
            args, src = ["--backend", "cuda"], (
                s16 if tool == "digitalvoice_filter" else f32)
        elif tool == "mbe_synthesizer":
            args, src = ["-t", "-s", server.path], empty
        else:
            args, src = [], empty
        out[tool] = [start_seconds(tool, args, src) for _ in range(2)]
    return out


def run_cli_chain(smoke, chain, fx, workdir, server, backend):
    """One example chain as a shell pipe of the port's tools, one process a
    stage (the tools' own entries), every stage's output kept by tee.
    Every stage's output must equal the fixture's (the JAX tools'): the
    filtered audio within the JAX tools' own rrc envelope, symbols, decoder
    bytes, metadata and PCM exactly, the post-filter within LSB_FULL_SCALE
    (cuda; the stand-in's PCM is full scale) or equal to the port's numpy
    oracle (numpy). Launches: K4 once a chunk, K3 once a century, K6 once a
    chunk on the card; none with --backend numpy. Returns (wall seconds,
    air seconds, launches summed over the stages, a summary)."""
    from digiham_tpu_torch.cli.base import BUF_SIZE
    from digiham_tpu_torch.dsp.audio import DigitalVoiceFilterNp

    n = chain.name
    audio = smoke.cli_audio(chain)
    src = workdir / f"{n}.f32"
    audio.tofile(src)
    meta = workdir / f"{n}_{backend}.meta"
    stages = chain.tools()
    outs = [workdir / f"{n}_{backend}_{i}.out" for i in range(len(stages))]
    errs = [workdir / f"{n}_{backend}_{i}.err" for i in range(len(stages))]
    parts = []
    for i, (tool, args) in enumerate(stages):
        args = [a.format(meta=meta, server=server.path) for a in args]
        if tool in DSP_TOOLS:
            args += ["--backend", backend]
        cmd = shlex.join([sys.executable, "-c", TOOL_LAUNCH, tool, *args])
        cmd += f" 2> {shlex.quote(str(errs[i]))}"
        if i < len(stages) - 1:
            cmd += f" | tee {shlex.quote(str(outs[i]))}"
        parts.append(cmd)
    script = (f"set -o pipefail; < {shlex.quote(str(src))} "
              + " | ".join(parts) + f" > {shlex.quote(str(outs[-1]))}")
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", "-c", script], cwd=ROOT, env=tool_env(),
                          capture_output=True, timeout=600)
    wall = time.perf_counter() - t0
    reports = [stage_launches(e) for e in errs]
    check(proc.returncode == 0 and all(r is not None for r, _ in reports),
          f"cli {n} ({backend}) exited {proc.returncode}: "
          + " | ".join(t[-800:] for _, t in reports))
    launched = dict.fromkeys(reports[0][0], 0)
    for r, _ in reports:
        for k, v in r.items():
            launched[k] += v
    notes = []
    for (tool, _), out, (r, _) in zip(stages, outs, reports):
        data = out.read_bytes()
        made = {k: v for k, v in r.items() if v}
        what = f"cli {n} ({backend}) {tool}"
        if backend == "numpy" or tool not in DSP_TOOLS:
            check(not made, f"{what} launched {made}")
        if tool == "rrc_filter":
            got = np.frombuffer(data, np.float32)
            want = fx[f"{n}_filtered"]
            check(got.shape == want.shape and np.allclose(
                got, want, rtol=RRC_RTOL, atol=RRC_ATOL),
                f"{what}: filtered audio outside the envelope")
            notes.append(f"rrc max diff {float(np.abs(got - want).max()):.2e}")
            if backend == "cuda":
                check(made == {"fir": -(-len(audio) * 4 // BUF_SIZE)},
                      f"{what} launches {made}")
        elif tool == chain.demod:
            check(data == fx[f"{n}_symbols"].tobytes(),
                  f"{what}: symbols differ from the JAX tool's")
            if backend == "cuda":
                k3 = made.get("none", 0)
                check(set(made) == {"none"}
                      and 0 <= len(data) - 100 * k3 <= 101,
                      f"{what}: {made} for {len(data)} symbols")
        elif tool == chain.decoder:
            check(data == fx[f"{n}_decoded"].tobytes(),
                  f"{what}: bytes differ from the JAX tool's")
            if chain.meta:
                check(meta.read_bytes() == fx[f"{n}_meta"].tobytes(),
                      f"{what}: metadata differs from the JAX tool's")
            notes.append(f"{len(data)} bytes, "
                         f"{len(fx[f'{n}_meta'].tobytes().splitlines())} "
                         f"events")
        elif tool == "mbe_synthesizer":
            check(data == fx[f"{n}_pcm"].tobytes(),
                  f"{what}: PCM differs from the JAX tool's")
        else:  # digitalvoice_filter
            got = np.frombuffer(data, np.int16).astype(np.int64)
            if backend == "numpy":
                want = DigitalVoiceFilterNp().process(fx[f"{n}_pcm"])
                check(np.array_equal(got, want), f"{what} differs from the "
                                                 f"oracle")
            else:
                want = fx[f"{n}_voice"].astype(np.int64)
                lsb = int(np.abs(got - want).max())
                check(got.shape == want.shape and lsb <= LSB_FULL_SCALE,
                      f"{what}: {lsb} LSB from the JAX tool's")
                notes.append(f"voice {lsb} LSB from JAX")
            if backend == "cuda":
                check(made == {"iir": -(-len(data) // BUF_SIZE)},
                      f"{what} launches {made}")
    return wall, len(audio) / smoke.FS, launched, "; ".join(notes)


def run_bank_voice(dev, smoke, voice, server):
    """The voice post-filter at bank width: every channel's voice bytes of
    the dmr_bank path through an MbeSynthesizer of its own on the stand-in,
    the PCM as one [CHANNELS, T] block through digitalvoice_filter on the
    card (K6 once). Equal to the plain version on the card, and within
    LSB_FULL_SCALE of the JAX function's output in the fixture for the
    channel's variant. Returns (launches, the largest LSB difference, T)."""
    from digiham_tpu_torch.codec import MbeSynthesizer, TableMode
    from digiham_tpu_torch.dsp.audio import (DigitalVoiceState,
                                             digitalvoice_filter)
    from digiham_tpu_torch.ops import recurrence

    fx = smoke.load(smoke.DMR_BANK)
    variant = np.arange(CHANNELS) % fx["tx_dibits"].shape[0]
    with np.load(smoke.CLI_FIXTURE) as f:
        want = f["bank_voice"]
    for c in range(CHANNELS):
        synth = MbeSynthesizer(server.path)
        synth.set_mode(TableMode(33))
        synth.process(voice[c])
        check(synth.drain(), f"bank voice channel {c}: speech missing")
        pcm = synth.read_pcm()
        synth.close()
        check(pcm == smoke.stand_in_speech(voice[c]),
              f"bank voice channel {c}: the stand-in's PCM differs")
    pcm = torch.from_numpy(smoke.bank_voice_pcm(voice)).to(dev)
    check(pcm.shape[1] == want.shape[1],
          f"bank voice T {pcm.shape[1]}, the fixture's {want.shape[1]}")
    smoke.reset_launch_counts()
    y, state = digitalvoice_filter(pcm, DigitalVoiceState.init(CHANNELS))
    torch.cuda.synchronize()
    counts = smoke.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect["iir"] = 1
    check(counts == expect, f"bank voice launches {counts}, want {expect}")
    zeros = torch.zeros((CHANNELS, 10), device=dev)
    plain = recurrence.digitalvoice_iir_plain(pcm, zeros, zeros,
                                              *k6_coeffs())
    check(torch.equal(y, plain[0]) and torch.equal(state.yv, plain[2]),
          "bank voice: K6 differs from the plain version")
    lsb = int((y.cpu().long() - torch.from_numpy(want[variant]).long())
              .abs().max())
    check(lsb <= LSB_FULL_SCALE,
          f"bank voice: {lsb} LSB from the JAX function's")
    return counts, lsb, pcm.shape[1]



# the soak and impaired-RF programs (digiham_tpu_torch/soak), at bank width
SOAK_FRAMES = 200  # of the DMR soak (its full run: 400)
IMPAIRED_FRAMES = 24
FUZZ_CASES_PER_PROTOCOL = 2  # 10 cases in all, every protocol twice
FUZZ_CHANNELS = CHANNELS
# the time-sharded pipeline's halo budget (its default 24): at 32 and 256
# channels the fuzz's noisy streams walk some channels' timing past it in
# their idle stretches, in the JAX bank as in the port's
FUZZ_DRIFT_BUDGET = 64


def run_soak(dev):
    """The soak programs at CHANNELS channels, each through its module's
    ``run``: the DMR soak (SOAK_FRAMES frames: at least 99% bit-exact, no
    UNCLASSIFIED miss; K2 once a step, K4 once in the flush), the
    impaired-RF matrix (IMPAIRED_FRAMES frames, every case on both paths:
    every channel at the bar or its shortfall classified; path A K1 once a
    step, path B K2 once a step and K4 once in the flush), ser_equiv (one
    repetition a SNR: 0 cross-path mismatches; K1, K2, K4 and K3 once a
    point) and fuzz_timesharded (FUZZ_CASES_PER_PROTOCOL cases of each
    protocol: the time-sharded bank identical to the unsharded one).
    Each module sets the launch counts to 0 before its work and reads
    them after; the KernelRecorder notes each program's kernel calls, and
    right after it they are replayed against the plain versions. Returns
    (launches summed, summary lines, seconds)."""
    from digiham_tpu_torch.soak import (dmr_soak, fuzz_timesharded,
                                        impaired, ser_equiv)

    def quiet(text):
        pass

    t0 = time.perf_counter()
    lines, total = [], {}
    # every kernel call of the four programs is noted; after each program
    # the first calls of each signature are replayed against the plain
    # versions
    recorder = KernelRecorder()

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def replay(name):
        n, seen = recorder.replay()
        lines.append(f"{name}: its kernel calls == plain versions on their "
                     f"own inputs ({n} replayed): " + "; ".join(
                         f"{k} {', '.join(v)}" for k, v in seen.items()))

    with recorder:
        r = dmr_soak.run(channels=CHANNELS, frames=SOAK_FRAMES, device=dev,
                         log=quiet)
    replay("dmr_soak")
    check(r["ok"], f"dmr_soak: {r['frames_bit_exact']} of "
                   f"{r['frames_expected']} frames bit-exact, "
                   f"{r['unclassified']} unclassified misses: "
                   f"{r['miss_list'][:5]}")
    want = {"rrc": r["steps"], "fir": 1}
    check(r["launches"] == want,
          f"dmr_soak launches {r['launches']}, want {want}")
    add(r["launches"])
    lines.append(
        f"dmr_soak {CHANNELS} ch x {SOAK_FRAMES} frames ({r['air_s']:.2f} s "
        f"of air a channel, {r['steps']} steps): {r['frames_bit_exact']} of "
        f"{r['frames_expected']} active-slot frames bit-exact "
        f"({100 * r['share_bit_exact']:.3f}%), misses by class "
        f"{r['miss_classes']}, wall {r['wall_s']:.2f} s (noise "
        f"{r['generate_s']:.2f}, pushes {r['push_s']:.2f}, flush "
        f"{r['flush_s']:.2f}), {r['wall_ms_per_step']:.2f} ms a step; "
        f"launches {r['launches']}")
    with recorder:
        r = impaired.run(channels=CHANNELS, frames=IMPAIRED_FRAMES,
                         device=dev, log=quiet)
    replay("impaired")
    for name, row in r["cases"].items():
        check(not row["A"]["unclassified"] and not row["B"]["unclassified"],
              f"impaired {name}: unclassified shortfall A "
              f"{row['A']['unclassified'][:3]} B "
              f"{row['B']['unclassified'][:3]}")
        want_a = {"fm_rrc": row["A"]["steps"]}
        want_b = {"rrc": row["B"]["steps"], "fir": 1}
        check(row["A"]["launches"] == want_a
              and row["B"]["launches"] == want_b,
              f"impaired {name} launches A {row['A']['launches']} B "
              f"{row['B']['launches']}, want {want_a} {want_b}")
        for path in "AB":
            add(row[path]["launches"])
        lines.append(
            f"impaired {name}, {CHANNELS} ch x {IMPAIRED_FRAMES} frames "
            f"(bar {r['bar']}): frames a channel A (K1) min "
            f"{row['A']['min']} median {row['A']['median']}, B (K2) min "
            f"{row['B']['min']} median {row['B']['median']}; channels below "
            f"the bar A {row['A']['channels_below_bar']} B "
            f"{row['B']['channels_below_bar']}, their missed frames by class "
            f"A {row['A']['miss_classes']} B {row['B']['miss_classes']}; "
            f"wall A {row['A']['wall_s']:.2f} s B {row['B']['wall_s']:.2f} s")
    check(r["ok"], "impaired: a case failed")
    with recorder:
        r = ser_equiv.run(channels=CHANNELS, reps=1, device=dev, log=quiet)
    replay("ser_equiv")
    check(r["ok"], f"ser_equiv: cross-path mismatches {r['points']}")
    n = len(ser_equiv.SNRS)
    want = {"fm_rrc": n, "rrc": n, "fir": n, "none": n}
    check(r["launches"] == want,
          f"ser_equiv launches {r['launches']}, want {want}")
    add(r["launches"])
    lines.append(
        f"ser_equiv {CHANNELS} ch x {r['centuries']} centuries, 1 "
        f"repetition a SNR: " + "; ".join(
            f"{p['snr_db']:g} dB SER K2 {p['ser_K2']:.6f} K3 "
            f"{p['ser_K3']:.6f} K1 {p['ser_K1']:.6f}, cross-path mismatch "
            f"{p['cross_path_mismatch']}" for p in r["points"])
        + f"; launches {r['launches']}, wall {r['wall_s']:.2f} s")
    for proto in fuzz_timesharded.PROTOS:
        with recorder:
            r = fuzz_timesharded.run(cases=FUZZ_CASES_PER_PROTOCOL,
                                     channels=FUZZ_CHANNELS, device=dev,
                                     proto=proto,
                                     drift_budget=FUZZ_DRIFT_BUDGET,
                                     log=quiet)
        replay(f"fuzz_timesharded {proto}")
        check(r["ok"], f"fuzz_timesharded {proto}: divergences "
                       f"{r['divergences']}")
        add(r["launches"])
        lines.append(
            f"fuzz_timesharded {proto}, {FUZZ_CASES_PER_PROTOCOL} cases x "
            f"{FUZZ_CHANNELS} ch on a (2, 2) mesh of the card (drift budget "
            f"{FUZZ_DRIFT_BUDGET}; case walls "
            f"{[round(w, 2) for w in r['case_wall_s']]} s): the time-sharded "
            f"bank's bytes ({r['bytes']}) and events ({r['events']}) equal "
            f"the unsharded bank's, {r['restored']} restored mid-stream; "
            f"launches {r['launches']}, wall {r['wall_s']:.2f} s")
    for k in ("fm_rrc", "rrc", "none", "fir", "viterbi"):
        check(total.get(k), f"the soak phase never launched {k}: {total}")
    return total, lines, time.perf_counter() - t0


def run_entry(dev, smoke):
    """The entry module: entry()'s step on the card (K2 once), every output
    field equal to the same step on the CPU (the plain versions; integers
    exact, floats within FLOAT_ATOL); then dryrun_multichip(4), the mesh
    naming the card four times. Returns (launches of both, summary)."""
    from digiham_tpu_torch import entry

    smoke.reset_launch_counts()
    fn, args = entry.entry()
    check(args[0].device.type == "cuda", "entry(): samples not on the card")
    out, _ = fn(*args)
    torch.cuda.synchronize()
    step_counts = smoke.launch_counts()
    check(step_counts["rrc"] == 1 and sum(step_counts.values()) == 1,
          f"entry() step launches {step_counts}, want K2 once")
    cpu_fn, cpu_args = entry.entry("cpu")
    want, _ = cpu_fn(*cpu_args)
    check(set(out) == set(want), "entry(): fields differ from the CPU step's")
    for key, w in want.items():
        g = out[key].cpu()
        ok = (torch.allclose(g, w, atol=FLOAT_ATOL) if w.is_floating_point()
              else torch.equal(g, w))
        check(ok and g.dtype == w.dtype, f"entry(): {key} differs from the "
                                         f"CPU step's")
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    counts = smoke.launch_counts()
    check(counts["rrc"] >= 2 and counts["fir"] >= 1 and counts["none"] >= 1,
          f"dryrun_multichip(4) launches {counts}")
    return counts, (f"entry(): one DmrPipeline step of 8 ch x 2 centuries "
                    f"on the card, K2 once, {len(want)} fields equal the "
                    f"CPU step's; dryrun_multichip(4) on the card named 4 "
                    f"times in {dry_s:.1f} s")


# the example programs, each run once as its user runs it: (script,
# arguments, the stream its result line is on, that line's pattern)
EXAMPLES = (
    ("torch_channel_bank", ["ysf", "8", "1000"], "stdout",
     r"^\[ysf\] decoded [1-9]\d* payload bytes across 8 channels on cuda; "
     r"8/8 channels equal the JAX bank's output$"),
    ("torch_iq_to_audio", ["--ambe", "{workdir}/demo.ambe", "--codecserver",
                           "{server}"], "stderr",
     r"^decoded [1-9]\d* voice payload bytes \(\d+ DMR bursts\) on cuda$"),
    ("torch_multistream_bank", ["8", "2"], "stdout",
     r"^8/8 channels decoded the JAX bank's voice bytes"),
)


def run_examples(smoke, workdir, server):
    """The three examples/torch_*.py on the card, as processes started
    together: each must exit 0 and print its result line; the IQ demo's
    PCM (its voice bytes through the codec stand-in, then K6) must be the
    length of the stand-in's speech. Returns (seconds, summary)."""
    import re

    procs = []
    t0 = time.perf_counter()
    for script, args, _, _ in EXAMPLES:
        args = [a.format(workdir=workdir, server=server.path) for a in args]
        procs.append(subprocess.Popen(
            [sys.executable, f"examples/{script}.py", *args], cwd=ROOT,
            env=tool_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = [p.communicate(timeout=600) for p in procs]
    seconds = time.perf_counter() - t0
    lines = []
    for (script, _, where, pattern), p, (out, err) in zip(EXAMPLES, procs,
                                                          results):
        text = (out if where == "stdout" else err).decode(errors="replace")
        check(p.returncode == 0, f"{script} exited {p.returncode}: "
              f"{err.decode(errors='replace')[-2000:]}")
        found = [ln for ln in text.splitlines() if re.search(pattern, ln)]
        check(found, f"{script}: no line matching {pattern!r} in "
                     f"{text[-2000:]}")
        lines.append(f"{script}: {found[0]}")
        if script == "torch_iq_to_audio":
            voice = (workdir / "demo.ambe").read_bytes()
            check(len(out) == len(smoke.stand_in_speech(voice)),
                  f"{script}: {len(out)} PCM bytes for {len(voice)} voice "
                  f"bytes")
    return seconds, "; ".join(lines)


# the host Viterbi's callers, where phase 5 swaps the native decode for
# the numpy one
VITERBI_CALLERS = ("digiham_tpu_torch.protocols.ysf.primitives",
                   "digiham_tpu_torch.protocols.dstar.header",
                   "digiham_tpu_torch.protocols.nxdn.components")
NATIVE_TIMED = ("ysf_bank", "dstar_bank", "nxdn_bank")


def numpy_viterbi():
    """A context in which the host Viterbi's callers run the numpy decode
    (the decode before the native library), by patching their name."""
    import contextlib
    import importlib
    from unittest import mock

    from digiham_tpu_torch.fec.viterbi import viterbi_decode_np_plain

    stack = contextlib.ExitStack()
    for name in VITERBI_CALLERS:
        stack.enter_context(mock.patch.object(
            importlib.import_module(name), "viterbi_decode_np",
            viterbi_decode_np_plain))
    return stack


def time_native_banks(banks, profile):
    """Wall ms per step of NATIVE_TIMED's whole pushes (a fresh bank each),
    in turns numpy, native, native, numpy; with ``profile`` also the
    cProfile host split of each decode. Returns name -> {"native": [ms,
    ms], "numpy": [ms, ms], "host": {...}}."""
    import contextlib

    out = {}
    for name in NATIVE_TIMED:
        _, _, push_all, _, _, steps, _, _ = banks[name]
        runs = {"native": [], "numpy": []}
        for mode in ("numpy", "native", "native", "numpy"):
            with (numpy_viterbi() if mode == "numpy"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                push_all()
                torch.cuda.synchronize()
                runs[mode].append((time.perf_counter() - t0) * 1e3 / steps)
        if profile:
            runs["host"] = {}
            for mode in ("native", "numpy"):
                with (numpy_viterbi() if mode == "numpy"
                      else contextlib.nullcontext()):
                    runs["host"][mode] = profile_bank_host(name, push_all,
                                                           steps)
        out[name] = runs
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also count kernels and device time per step "
                             "of each path with torch.profiler")
    opts = parser.parse_args(argv)

    # phase 1: the device
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    print(f"phase 1 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda}; SM clock at most {clock_mhz:.0f} MHz",
          flush=True)

    from digiham_tpu_torch import smoke
    from digiham_tpu_torch.dsp.rrc import NARROW_RRC, WIDE_RRC
    from digiham_tpu_torch.fec.viterbi import (viterbi_decode_many,
                                               viterbi_decode_plain)
    from digiham_tpu_torch.dsp.rrc import RrcDesign
    from digiham_tpu_torch.ops import (build, demod_front, fir, recurrence,
                                       viterbi)
    from digiham_tpu_torch.pipeline import (DmrPipeline, FskPipeline,
                                            NxdnPipeline, YsfPipeline)

    # phase 2: build every source from this checkout, all at once: the
    # CUDA sources with nvcc, the native host library with g++
    from digiham_tpu_torch import native

    sources = (demod_front.SOURCE, fir.SOURCE, viterbi.SOURCE,
               recurrence.SOURCE, recurrence.SERIAL_SOURCE)
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(build.build_host, native.SOURCE, [native.HEADER])
        built = list(pool.map(build.build, sources))
        host_path, host_seconds, _ = host.result()
    for source, (path, seconds, report) in zip(sources, built):
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"phase 2 build: {source} -> {path.name} in {seconds:.1f} s | "
              + " | ".join(ptxas), flush=True)
    check(native.load() is not None and native.library_path() == host_path,
          "the native host library did not load")
    print(f"phase 2 build: native host library {native.SOURCE.name} -> "
          f"{host_path} in {host_seconds:.1f} s ({build.cxx()})", flush=True)

    dmr, ysf, nxdn = smoke.DMR, smoke.YSF, smoke.NXDN
    resident = {}
    for label, front, ntaps, stream_sps, nc in (
            ("K1 dmr 16", "fm_rrc", 81, dmr.sps, dmr.n_centuries),
            ("K2 dmr 16", "rrc", 81, dmr.sps, dmr.n_centuries),
            ("K2 ysf 10", "rrc", 81, ysf.sps, ysf.n_centuries),
            ("K2 nxdn 4", "rrc", 161, nxdn.sps, nxdn.n_centuries),
            ("K3 ysf 10", "none", 0, ysf.sps, ysf.n_centuries),
            ("K1 dmr 32", "fm_rrc", 81, dmr.sps, 32),
            ("K2 ysf 40", "rrc", 81, ysf.sps, LONG_CENTURIES),
            ("K2 nxdn 16", "rrc", 161, nxdn.sps, 16),
            *((f"K3 sps {k3_sps} x {nc}", "none", 0, k3_sps, nc)
              for nc, k3_sps, _ in K3_2FSK.values() if k3_sps <= 94)):
        blocks, sms = demod_front.occupancy(front, ntaps, stream_sps, nc)
        resident[label] = blocks
        check(blocks * sms >= CHANNELS,
              f"{label}: {blocks} blocks per SM x {sms} SMs hold fewer than "
              f"{CHANNELS} channels at once")
    for ntaps in (81, 161):
        blocks, _ = fir.occupancy(ntaps)
        resident[f"K4 {ntaps} taps"] = blocks
        check(blocks >= 2, f"K4 at {ntaps} taps: {blocks} block per SM, so "
                           f"no block's staging overlaps another's FIR")
    print(f"phase 2 occupancy: blocks per SM the runtime keeps resident "
          f"{resident} on {sms} SMs, shared memory per block "
          f"{demod_front.smem_bytes(81, dmr.sps, dmr.n_centuries)} B (K1 dmr "
          f"16), {fir.smem_bytes(81)} B (K4, 81 taps), "
          f"{viterbi.smem_bytes(100)} B (K5, T 100); all {CHANNELS} channels "
          f"of every shape of K1-K3 run at once", flush=True)

    # phase 3: every kernel against its plain version on the card
    errs = {}
    k1_main = k1_args(dev, CHANNELS, dmr.block_len, dmr.sps, FOUR_LEVELS, 11)
    k1_kw = dict(n_centuries=dmr.n_centuries, sps=dmr.sps)
    # the long blocks of tools/bench_protocols.py, which no block's shared
    # memory held while K1 and K2 kept their whole row there
    ysf_long = dataclasses.replace(ysf, n_centuries=LONG_CENTURIES)
    nxdn_long = dataclasses.replace(nxdn, n_centuries=16)
    dmr_long = dataclasses.replace(dmr, n_centuries=32)
    k1_long = k1_args(dev, CHANNELS, dmr_long.block_len, dmr.sps, FOUR_LEVELS,
                      13)
    k1_long_kw = dict(n_centuries=dmr_long.n_centuries, sps=dmr.sps)
    errs["K1"] = max(
        compare_demod("K1", demod_front.demod_fm_front,
                      demod_front.demod_fm_front_plain, k1_main, **k1_kw),
        compare_demod("K1", demod_front.demod_fm_front,
                      demod_front.demod_fm_front_plain,
                      k1_args(dev, 32, 3 * 1001 + 40, 10, TWO_LEVELS, 12),
                      n_centuries=3, sps=10, mode="fsk", invert=True),
        compare_demod("K1", demod_front.demod_fm_front,
                      demod_front.demod_fm_front_plain, k1_long,
                      **k1_long_kw))
    k2_shapes = {  # main-path shapes: (args, kwargs)
        "ysf": (k2_args(dev, CHANNELS, ysf.block_len, ysf.sps, WIDE_RRC,
                        FOUR_LEVELS, 21),
                dict(n_centuries=ysf.n_centuries, sps=ysf.sps)),
        "nxdn": (k2_args(dev, CHANNELS, nxdn.block_len, nxdn.sps, NARROW_RRC,
                         FOUR_LEVELS, 22),
                 dict(n_centuries=nxdn.n_centuries, sps=nxdn.sps)),
        "dmr": (k2_args(dev, CHANNELS, dmr.block_len, dmr.sps, WIDE_RRC,
                        FOUR_LEVELS, 23),
                dict(n_centuries=dmr.n_centuries, sps=dmr.sps)),
        "ysf_long": (k2_args(dev, CHANNELS, ysf_long.block_len, ysf.sps,
                             WIDE_RRC, FOUR_LEVELS, 24),
                     dict(n_centuries=ysf_long.n_centuries, sps=ysf.sps)),
        "nxdn_long": (k2_args(dev, CHANNELS, nxdn_long.block_len, nxdn.sps,
                              NARROW_RRC, FOUR_LEVELS, 25),
                      dict(n_centuries=nxdn_long.n_centuries, sps=nxdn.sps)),
    }
    # rows off a 16-byte boundary, as a channel shard's or a worker's rows
    # may reach K2: a contiguous view one float into its storage
    a, kw = k2_shapes["dmr"]
    flat = torch.empty(a[0].numel() + 1, device=dev)
    shifted = flat[1:].view(a[0].shape)
    shifted.copy_(a[0])
    check(shifted.data_ptr() % 16 != 0, "the shifted row is aligned")
    # the serving and scale-out paths' shapes (their in-process calls are
    # replayed on their own inputs in phase 4 as well)
    scale_shapes = scale_out_shapes(dev, smoke)
    errs["K2"] = max(*(compare_demod("K2", demod_front.demod_front,
                                     demod_front.demod_front_plain, a, **kw)
                       for a, kw in [*k2_shapes.values(),
                                     *scale_shapes["K2"].values()]),
                     compare_demod("K2", demod_front.demod_front,
                                   demod_front.demod_front_plain,
                                   [shifted, *a[1:]], **kw))
    k3_main = k3_args(dev, CHANNELS, ysf.block_len, ysf.sps, FOUR_LEVELS, 31)
    k3_kw = dict(n_centuries=ysf.n_centuries, sps=ysf.sps)
    long_row = 60000  # far longer than its 14 centuries consume
    k3_fsk = {}  # label: (args, kwargs) at the 2FSK shapes
    for i, (label, (nc, k3_sps, inverted)) in enumerate(K3_2FSK.items()):
        length = -(-(nc * (100 * k3_sps + 1) + 24) // 128) * 128
        k3_fsk[label] = (k3_args(dev, CHANNELS, length, k3_sps, TWO_LEVELS,
                                 33 + i),
                         dict(n_centuries=nc, sps=k3_sps, mode="fsk",
                              invert=inverted))
    k3_cli = {}  # label: (args, kwargs) at the tools' shape
    for i, (label, (k3_sps, mode, inverted)) in enumerate(K3_CLI.items()):
        k3_cli[label] = (k3_args(dev, 1, 100 * k3_sps + 18, k3_sps,
                                 FOUR_LEVELS if mode == "gfsk" else TWO_LEVELS,
                                 50 + i),
                         dict(n_centuries=1, sps=k3_sps, mode=mode,
                              invert=inverted))
    errs["K3"] = max(
        *(compare_demod("K3", demod_front.demod, demod_front.demod_plain,
                        a, **kw) for a, kw in k3_cli.values()),
        compare_demod("K3", demod_front.demod, demod_front.demod_plain,
                      k3_main, **k3_kw),
        compare_demod("K3", demod_front.demod, demod_front.demod_plain,
                      k3_args(dev, 64, long_row, 40, TWO_LEVELS, 32),
                      n_centuries=14, sps=40, mode="fsk", invert=True),
        *(compare_demod("K3", demod_front.demod, demod_front.demod_plain,
                        a, **kw) for a, kw in k3_fsk.values()),
        *(compare_demod("K3", demod_front.demod, demod_front.demod_plain,
                        a, **kw) for a, kw in scale_shapes["K3"].values()))
    custom = RrcDesign("custom129", 3.0, tuple(
        float(t) for t in np.random.default_rng(129).normal(0, 0.3, 129)))
    k4_shapes = {  # label: (channels, samples, design)
        "256 ch x 16128 samples, 81 taps (a whole bank block)":
            (CHANNELS, 16128, WIDE_RRC),
        f"dmr_bank flush tail 256 ch x {smoke.DMR_BANK.flush_tail} "
        "samples, 81 taps": (CHANNELS, smoke.DMR_BANK.flush_tail, WIDE_RRC),
        f"ysf_bank flush tail 256 ch x {smoke.YSF_BANK.flush_tail} "
        "samples, 81 taps": (CHANNELS, smoke.YSF_BANK.flush_tail, WIDE_RRC),
        f"nxdn_bank flush tail 256 ch x {smoke.NXDN_BANK.flush_tail} "
        "samples, 161 taps": (CHANNELS, smoke.NXDN_BANK.flush_tail,
                              NARROW_RRC),
        "256 ch x 8064 samples, 161 taps": (CHANNELS, 8064, NARROW_RRC),
        f"ysf_prefiltered stream 256 ch x {ysf.stream_len} samples, 81 taps":
            (CHANNELS, ysf.stream_len, WIDE_RRC),
        "64 ch x 60000 samples, 81 taps": (64, long_row, WIDE_RRC),
        "129 ch x 5003 samples, 129 taps (asymmetric)": (129, 5003, custom),
        "rrc_filter chunk 1 ch x 16384 samples, 81 taps":
            (1, 16384, WIDE_RRC),
        "rrc_filter -n chunk 1 ch x 16384 samples, 161 taps":
            (1, 16384, NARROW_RRC),
    }
    errs["K4"], k4_lib_err, n_k4 = compare_k4(
        dev, {**k4_shapes, **scale_shapes["K4"]}, k2_shapes["dmr"])
    n_k5, n_k5_fused = compare_k5(dev, scale_shapes["K5"])
    n_k5_4, n_k5_4_fused, k5_4_launches = compare_k5_4(dev)
    errs["K5"] = 0.0  # integers only: exact or a failure
    n_native, native_ms = compare_native()
    errs["K6"], n_k6 = compare_k6(dev, K6_IIR, K6_DC)
    # K6's times are taken here, right after its comparison (printed in
    # phase 5)
    k6_times = {label: k6_time(dev, "dc_block" if label in K6_DC else "iir",
                               channels, length, clock_mhz * 1e6, 90 + i)
                for i, (label, (channels, length)) in enumerate(
                    [*K6_IIR.items(), *K6_DC.items()])}
    print(f"phase 3 kernels == plain versions: K1 at {CHANNELS} ch x "
          f"{dmr.n_centuries} centuries (gfsk), 32 ch x 3 (fsk inverted) and "
          f"{CHANNELS} ch x {dmr_long.n_centuries} centuries "
          f"({dmr_long.block_len} samples);"
          f" K2 at the YSF (81 taps, sps 10), NXDN (161 taps, sps 20) and "
          f"DMR shapes (and on DMR rows not 16-byte aligned), at YSF x "
          f"{ysf_long.n_centuries} centuries "
          f"({ysf_long.block_len} samples) and NXDN x "
          f"{nxdn_long.n_centuries} centuries ({nxdn_long.block_len} samples,"
          f" 161 taps); K3 at the YSF shape, at 64 ch x {long_row} "
          f"samples (fsk inverted, sps 40) and at the 2FSK shapes "
          f"({'; '.join(k3_fsk)}); K4 on {n_k4} shapes "
          f"({', '.join(k4_shapes)}; T 0/1/4/5/6/79/80/81/{fir.TILE - 1}/"
          f"{fir.TILE}/{fir.TILE + 1} x 1/3/129 ch x 81/161 taps; 1/2/9/10 "
          f"taps), on a strided view, on 5 rows whose samples are not "
          f"16-byte aligned (82 taps, odd row strides), K4 -> K3 == K2 "
          f"exactly, and within {k4_lib_err:.2e} of the row's peak of conv1d;"
          f" K5 on {n_k5} batches (T 100, 36 and 96 blocked, 1 and 1 "
          f"blocked, batches 1/2/3/129/512/4096; noisy, noise, and constant "
          f"at the batches every run has held; "
          f"int64, int32, uint8 and strided rows; T {viterbi.MAX_STEPS}) and "
          f"{n_k5_fused} segments of fused launches (2 x 512 x 100; 512 x 36 "
          f"+ 1024 x 96 blocked; four mixed; the banks' padded decode "
          f"rounds, 2 x 1024 x 100 and 1024 x 36 + 2048 x 96 blocked); "
          f"K5 at 4 states on {n_k5_4} batches (the D-Star header, 1 and 256 "
          f"x 330, blocked 0 and 2, as int64, int32, uint8 and strided rows; "
          f"T 1, 2, 3, 36 and {viterbi.max_steps(4)}) and {n_k5_4_fused} "
          f"segments of fused 4-state launches (1 x 330 + 256 x 330 blocked "
          f"+ 5 x 36 + 129 x 1 blocked; 2 x 256 x 330), {k5_4_launches} "
          f"launches of the 4-state instance; "
          f"integers exact; K6 on {n_k6} shapes ({', '.join(K6_IIR)}; T "
          f"0/1/9/10/11 and 1, 2, 3 tiles of {recurrence.TILE} -1/+0/+1; "
          f"1/7/31/33/255/256/257 ch and the SM count x 1, 2 (+0/+1) and "
          f"x 16 (-1/+0/+1); int32 PCM; rows of a wider array; "
          f"{', '.join(K6_DC)}, the edges, the widths and a strided view) "
          f"exact, state included; K3 at the tools' "
          f"shape ({'; '.join(K3_CLI)}); at the serving and scale-out "
          f"paths' shapes: "
          + "; ".join(f"{k} {', '.join(v)}" for k, v in scale_shapes.items())
          + f"; max float diffs {errs}", flush=True)
    print(f"phase 3 native host Viterbi == the numpy decode on this host: "
          f"{n_native} sequences ("
          + ", ".join(f"{k} {v[0]} states T {v[1]}"
                      + (" blocked" if v[2] else "")
                      for k, v in NATIVE_SHAPES.items())
          + f"; T 0; {NATIVE_RANDOM} random); per call, native / numpy ms: "
          + "; ".join(f"{k} {a:.4f} / {b:.4f}"
                      for k, (a, b) in native_ms.items()), flush=True)

    # phase 4: the main paths on the committed fixtures
    paths = {"dmr_iq": run_iq_path(dev, smoke)}
    paths["dmr_audio"] = run_audio_path(
        dev, smoke, "DMR audio", dmr, DmrPipeline, {"rrc": 1})
    paths["ysf_audio"] = run_audio_path(
        dev, smoke, "YSF audio", ysf, YsfPipeline, {"rrc": 1, "viterbi": 1})
    paths["nxdn_audio"] = run_audio_path(
        dev, smoke, "NXDN audio", nxdn, NxdnPipeline,
        {"rrc": 1, "viterbi": 1}, post=nxdn_frames)
    paths["ysf_prefiltered"] = run_audio_path(
        dev, smoke, "YSF pre-filtered", ysf, YsfPipeline,
        {"none": 1, "viterbi": 1}, prefiltered=True)
    for protocol in TWO_FSK:  # no RRC: the samples go straight to K3
        paths[f"{protocol}_audio"] = run_audio_path(
            dev, smoke, f"{protocol} audio", getattr(smoke, protocol.upper()),
            lambda channels, sps, n_centuries, use_rrc, p=protocol:
                FskPipeline(channels, p, n_centuries=n_centuries, sps=sps),
            {"none": 1})
    long_counts, long_diffs, long_summary, long_step = run_long_ysf_path(
        dev, smoke)
    banks = {}
    launches = dict.fromkeys(smoke.launch_counts(), 0)
    native_calls = {}  # the host Viterbi of the banks in this process
    decode_one = native.viterbi

    def counted_viterbi(*args, **kw):
        native_calls[current] = native_calls.get(current, 0) + 1
        return decode_one(*args, **kw)

    native.viterbi = counted_viterbi
    try:
        for name, *where in BANKS:
            current = name
            with smoke.function_bits(smoke.load(getattr(smoke, where[0]))):
                banks[name] = run_bank_path(smoke, name, *where)
            counts, summary = banks[name][:2]
            for k, v in counts.items():
                launches[k] += v
            print(f"phase 4 {name}: {summary}; launches "
                  f"{ {k: v for k, v in counts.items() if v} }; native host "
                  f"Viterbi calls {native_calls.get(name, 0)}", flush=True)
    finally:
        native.viterbi = decode_one
    check(native_calls.get("ysf_bank") and native_calls.get("dstar_bank"),
          f"the YSF and D-Star banks ran no native Viterbi: {native_calls}")
    soak_launches, soak_lines, soak_s = run_soak(dev)
    for text in soak_lines:
        print(f"phase 4 soak {text}", flush=True)
    print(f"phase 4 soak: the four programs in {soak_s:.1f} s on {card}; "
          f"launches {soak_launches}", flush=True)
    scale = {}  # the serving and scale-out paths: name -> launches
    multistream = {}
    for name, (counts, summary, multistream[name]) in run_multistream_paths(
            smoke, {name: banks[f"{protocol}_bank"][5]
                    for name, _, protocol in MULTISTREAM}).items():
        scale[name] = counts
        print(f"phase 4 {name}: {summary}; workers' launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    timesharded = {}
    # every kernel call of the in-process scale-out paths is noted; after
    # each path its calls are replayed against the plain versions
    recorder = KernelRecorder()

    def replay(name):
        n, seen = recorder.replay()
        print(f"phase 4 {name}: its kernel calls == plain versions on their "
              f"own inputs ({n} replayed): "
              + "; ".join(f"{k} {', '.join(v)}" for k, v in seen.items()),
              flush=True)

    for name, stream_name, protocol, cps in TIMESHARDED:
        with smoke.function_bits(smoke.load(getattr(smoke, stream_name))):
            with recorder:
                counts, summary, *ts_times = run_timesharded_path(
                    smoke, name, stream_name, protocol, cps)
        timesharded[name] = ts_times
        scale[name] = counts
        print(f"phase 4 {name}: {summary}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        replay(name)
    with recorder:
        scale["mesh_bank_dmr"], summary, mesh_steps, mesh_push_all = \
            run_mesh_bank(smoke)
    print(f"phase 4 mesh_bank_dmr: {summary}; launches "
          f"{ {k: v for k, v in scale['mesh_bank_dmr'].items() if v} }",
          flush=True)
    replay("mesh_bank_dmr")
    sharded_steps = {}  # name -> a closure that runs the bulk step again
    for name, stream_name, protocol in SHARDED:
        with recorder:
            scale[name], summary, x, sharded_steps[name] = run_sharded_path(
                smoke, name, stream_name, protocol, dev)
        if protocol == "dmr":
            dmr_x = x
        print(f"phase 4 {name}: {summary}; launches "
              f"{ {k: v for k, v in scale[name].items() if v} }", flush=True)
        replay(name)
    with recorder:
        scale["distributed"], summary, distributed_profile = run_distributed(
            smoke, dmr_x, dev, opts.profile)
    print(f"phase 4 distributed: {summary}; launches "
          f"{ {k: v for k, v in scale['distributed'].items() if v} }",
          flush=True)
    replay("distributed")
    for counts in scale.values():
        for k, v in counts.items():
            launches[k] += v
    for name, (counts, diffs, summary, _) in paths.items():
        for k, v in counts.items():
            launches[k] += v
        made = {k: v for k, v in counts.items() if v}
        print(f"phase 4 {name}: {smoke.STEPS} chained steps x {CHANNELS} ch;"
              f" fields equal the JAX package's on every channel; launches "
              f"{made}; {summary}; dibits differing from JAX's {diffs}",
              flush=True)
    for k, v in long_counts.items():
        launches[k] += v
    print(f"phase 4 ysf_long: {long_summary}; launches "
          f"{ {k: v for k, v in long_counts.items() if v} }; dibits differing "
          f"from JAX's over the fixture's span {long_diffs}", flush=True)
    entry_counts, summary = run_entry(dev, smoke)
    for k, v in entry_counts.items():
        launches[k] += v
    print(f"phase 4 entry: {summary}; launches "
          f"{ {k: v for k, v in entry_counts.items() if v} }", flush=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    server = smoke.CodecStandIn(str(workdir / "codec.sock"))
    try:
        bank_voice_counts, bank_voice_lsb, bank_voice_t = run_bank_voice(
            dev, smoke, banks["dmr_bank"][7], server)
        for k, v in bank_voice_counts.items():
            launches[k] += v
        print(f"phase 4 bank voice: the voice bytes of dmr_bank's {CHANNELS} "
              f"channels through {CHANNELS} MbeSynthesizers on the codec "
              f"stand-in, the PCM [{CHANNELS}, {bank_voice_t}] through "
              f"digitalvoice_filter on the card: K6 once, equal to the plain "
              f"version, {bank_voice_lsb} LSB from the JAX function's "
              f"(bound {LSB_FULL_SCALE}: the stand-in's PCM is full scale)",
              flush=True)
        with np.load(smoke.CLI_FIXTURE) as f:
            cli_fx = {k: f[k] for k in f.files}
        # each tool's start, before any chain has run it
        startups = tool_startups(smoke, workdir, server)
        chains = {}
        for chain in smoke.CLI_CHAINS:
            for backend in ("cuda", "numpy"):
                chains[chain.name, backend] = run_cli_chain(
                    smoke, chain, cli_fx, workdir, server, backend)
            wall, air, made, notes = chains[chain.name, "cuda"]
            for k, v in made.items():
                launches[k] += v
            print(f"phase 4 cli {chain.name}: "
                  + " | ".join(f"{tool} {' '.join(args)}"
                               for tool, args in chain.tools())
                  + f" as a shell pipe (--backend cuda); every stage equals "
                    f"the JAX tools' (fixture); {notes}; launches "
                    f"{ {k: v for k, v in made.items() if v} }; --backend "
                    f"numpy equal too, no launch", flush=True)
        examples_s, summary = run_examples(smoke, workdir, server)
        print(f"phase 4 examples, started together, {examples_s:.1f} s: "
              f"{summary}", flush=True)
    finally:
        server.close()
        shutil.rmtree(workdir, ignore_errors=True)
    check(all(launches.values()), f"a kernel never launched: {launches}")

    # phase 5: times on the card
    timed = []  # (kernel's name in a trace, one call of its wrapper)

    def measure(kernel, plain, args, ops, trace_name="demod_kernel",
                iters=20, plain_iters=3, library=None, **kw):
        timed.append((trace_name, lambda: kernel(*args, **kw)))
        ms = time_ms(lambda: kernel(*args, **kw), iters)
        plain_ms = time_ms(lambda: plain(*args, **kw), plain_iters, warmup=1)
        library_ms = None if library is None else time_ms(
            library(*args, **kw), iters)
        moved = nbytes(args) + nbytes(kernel(*args, **kw))
        bound_ms, bound_by = bound(moved, ops)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": moved, "operations": ops,
                "library_ms": library_ms, "timed_index": len(timed) - 1}

    def demod_ops(args_row, ntaps, kw, fm=False):
        return demod_operations(args_row.shape[0], args_row.shape[1], ntaps,
                                kw["n_centuries"], kw["sps"], fm)

    times = {"K1": {
        "dmr 256 ch x 16 centuries, sps 10, 81 taps": measure(
            demod_front.demod_fm_front, demod_front.demod_fm_front_plain,
            k1_main, demod_ops(k1_main[0], 81, k1_kw, fm=True), **k1_kw),
        "dmr 256 ch x 32 centuries, sps 10, 81 taps": measure(
            demod_front.demod_fm_front, demod_front.demod_fm_front_plain,
            k1_long, demod_ops(k1_long[0], 81, k1_long_kw, fm=True),
            **k1_long_kw)}}
    times["K2"] = {}
    for label, ntaps, shape in (
            ("ysf 256 ch x 10 centuries, sps 10, 81 taps", 81, "ysf"),
            ("nxdn 256 ch x 4 centuries, sps 20, 161 taps", 161, "nxdn"),
            ("dmr 256 ch x 16 centuries, sps 10, 81 taps", 81, "dmr"),
            ("ysf 256 ch x 40 centuries, sps 10, 81 taps", 81, "ysf_long"),
            ("nxdn 256 ch x 16 centuries, sps 20, 161 taps", 161,
             "nxdn_long")):
        a, kw = k2_shapes[shape]
        times["K2"][label] = measure(
            demod_front.demod_front, demod_front.demod_front_plain, a,
            demod_ops(a[0], ntaps, kw), **kw)
    times["K3"] = {"ysf 256 ch x 10 centuries, sps 10": measure(
        demod_front.demod, demod_front.demod_plain, k3_main,
        demod_ops(k3_main[0], 0, k3_kw), **k3_kw)}
    for label, (a, kw) in k3_fsk.items():
        times["K3"][label] = measure(demod_front.demod,
                                     demod_front.demod_plain, a,
                                     demod_ops(a[0], 0, kw), **kw)
    for label, (a, kw) in k3_cli.items():
        times["K3"][label] = measure(demod_front.demod,
                                     demod_front.demod_plain, a,
                                     demod_ops(a[0], 0, kw), **kw)
    times["K4"] = {}
    for i, (label, (channels, length, design)) in enumerate(
            k4_shapes.items()):
        times["K4"][label] = measure(
            fir.rrc_filter_block_kernel, fir.rrc_filter_block_plain,
            k4_args(dev, channels, length, design, 40 + i),
            2 * design.ntaps * channels * length, trace_name="fir_kernel",
            library=conv1d_library)
    # what a step launches now: all of its batches at once (the YSF frames'
    # own uint8 dibits; NXDN's depunctured int32 ones), then the single
    # batches as every earlier run timed them
    def k5_many(*obs, b):
        return tuple(t for pair in viterbi_decode_many([(o, b) for o in obs])
                     for t in pair)

    def k5_many_plain(*obs, b):
        return tuple(t for o in obs for t in viterbi_decode_plain(o, 16, b))

    # the soak phase's own shapes (phase 4 replayed its calls)
    from digiham_tpu_torch.soak import ser_equiv

    ser_kw = dict(n_centuries=ser_equiv.CENTURIES, sps=ser_equiv.SPS)
    ser_len = (ser_equiv.CENTURIES * 100 + 4) * ser_equiv.SPS
    ser_label = (f"soak ser_equiv {CHANNELS} ch x {ser_equiv.CENTURIES} "
                 f"centuries, sps 10, L {ser_len}")
    a = k1_args(dev, CHANNELS, ser_len, 10, FOUR_LEVELS, 95)
    times["K1"][ser_label] = measure(
        demod_front.demod_fm_front, demod_front.demod_fm_front_plain, a,
        demod_ops(a[0], 81, ser_kw, fm=True), **ser_kw)
    path_b_kw = dict(n_centuries=2, sps=10)
    for label, a, kw in (
            (ser_label, k2_args(dev, CHANNELS, ser_len, 10, WIDE_RRC,
                                FOUR_LEVELS, 96), ser_kw),
            (f"soak impaired path B {CHANNELS} ch x 2 centuries, sps 10, L "
             f"{2 * 1001 + 8}", k2_args(dev, CHANNELS, 2 * 1001 + 8, 10,
                                        WIDE_RRC, FOUR_LEVELS, 97),
             path_b_kw)):
        times["K2"][label] = measure(
            demod_front.demod_front, demod_front.demod_front_plain, a,
            demod_ops(a[0], 81, kw), **kw)
    a = k3_args(dev, CHANNELS, ser_len, 10, FOUR_LEVELS, 98)
    times["K3"][ser_label] = measure(demod_front.demod,
                                     demod_front.demod_plain, a,
                                     demod_ops(a[0], 0, ser_kw), **ser_kw)
    times["K4"][f"soak ser_equiv {CHANNELS} ch x {ser_len} samples, 81 "
                f"taps"] = measure(
        fir.rrc_filter_block_kernel, fir.rrc_filter_block_plain,
        k4_args(dev, CHANNELS, ser_len, WIDE_RRC, 99),
        2 * WIDE_RRC.ntaps * CHANNELS * ser_len, trace_name="fir_kernel",
        library=conv1d_library)
    for shapes in times.values():  # their device time, as the 4-state rows
        for label, t in shapes.items():
            if label.startswith("soak "):
                t["device_ms"] = kernel_device_ms(*reversed(
                    timed[t["timed_index"]]))
    times["K5"] = {}
    for label, dtype, blocked, segments in (
            ("ysf fich + dch in one launch, 2 x (512 x 100)", torch.uint8, 0,
             ((512, 100), (512, 100))),
            ("nxdn sacch + facch1 in one launch, 512 x 36 + 1024 x 96 "
             "blocked", torch.int32, 4, ((512, 36), (1024, 96))),
            ("ysf_bank decode round, 2 x (1024 x 100) in one launch",
             torch.uint8, 0, ((1024, 100), (1024, 100))),
            ("nxdn_bank decode round, 1024 x 36 + 2048 x 96 blocked in one "
             "launch", torch.int32, 4, ((1024, 36), (2048, 96)))):
        obs = [k5_cases(dev, batch, steps, blocked, 70 + i)["noisy"].to(dtype)
               for i, (batch, steps) in enumerate(segments)]
        times["K5"][label] = measure(
            k5_many, k5_many_plain, obs,
            sum(viterbi_operations(*seg) for seg in segments),
            trace_name="viterbi_kernel<16>", b=blocked)
    for label, steps, blocked in (
            ("ysf fich/dch 512 x 100", 100, 0),
            ("nxdn facch1 512 x 96 blocked", 96, 4),
            ("nxdn sacch 512 x 36 blocked", 36, 4)):
        obs = k5_cases(dev, 512, steps, blocked, 77)["noisy"].to(torch.int32)
        times["K5"][label] = measure(
            lambda o, b: viterbi.viterbi16(o, b),
            lambda o, b: viterbi_decode_plain(o, 16, b), [obs],
            viterbi_operations(512, steps), trace_name="viterbi_kernel<16>",
            b=blocked)
    # the 4-state instance at the D-Star header's shape (on no main path:
    # the header decodes on the host)
    for label, batch, blocked in (
            ("4 states: one D-Star header, 1 x 330", 1, 0),
            ("4 states: 256 D-Star headers, 256 x 330", 256, 0),
            ("4 states: 256 x 330, blocked start of 2", 256, 2)):
        obs = k5_cases(dev, batch, 330, blocked, 78, num_states=4)[
            "noisy"].to(torch.uint8)
        times["K5"][label] = measure(
            lambda o, b: viterbi.viterbi16(o, b, num_states=4),
            lambda o, b: viterbi_decode_plain(o, 4, b), [obs],
            viterbi_operations(batch, 330, 4), trace_name="viterbi_kernel<4>",
            b=blocked)
        times["K5"][label]["device_ms"] = kernel_device_ms(
            timed[-1][1], "viterbi_kernel<4>")
    obs = [k5_cases(dev, b, t, bl, 79 + t, num_states=4)["noisy"].to(
        torch.uint8) for b, t, bl in K5_4_FUSED[0]]

    def k5_4_many(*obs):
        return tuple(t for pair in viterbi_decode_many(
            [(o, bl) for o, (_, _, bl) in zip(obs, K5_4_FUSED[0])],
            num_states=4) for t in pair)

    def k5_4_many_plain(*obs):
        return tuple(t for o, (_, _, bl) in zip(obs, K5_4_FUSED[0])
                     for t in viterbi_decode_plain(o, 4, bl))

    times["K5"]["4 states: four segments in one launch, 1 x 330 + 256 x 330 "
                "blocked + 5 x 36 + 129 x 1 blocked"] = measure(
        k5_4_many, k5_4_many_plain, obs,
        sum(viterbi_operations(b, t, 4) for b, t, _ in K5_4_FUSED[0]),
        trace_name="viterbi_kernel<4>")
    times["K5"]["4 states: four segments in one launch, 1 x 330 + 256 x 330 "
                "blocked + 5 x 36 + 129 x 1 blocked"]["device_ms"] = \
        kernel_device_ms(timed[-1][1], "viterbi_kernel<4>")
    # K6's device times were taken after phase 3 (no profile of it here)
    times["K6"] = k6_times
    # the floor of these times: back-to-back calls of the cheapest wrapper
    # (K5 on one sequence of one step) cost the host this much each
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    launch_ms = time_ms(lambda: viterbi.viterbi16(one), 50)
    for kernel, shapes in times.items():
        for label, t in shapes.items():
            library = ("" if t["library_ms"] is None
                       else f", conv1d {t['library_ms']:.4f} ms")
            if "device_ms" in t and "plain_timed_on" not in t:
                library += f", device {t['device_ms']:.4f} ms (profiler)"
            if "plain_timed_on" in t:
                library += (f" (plain timed on {t['plain_timed_on']} samples "
                            f"and scaled; bound: the serial chain, "
                            f"{FP32_LATENCY_CYCLES} cycles a dependent "
                            f"operation at {clock_mhz:.0f} MHz, or bytes); "
                            f"timed after phase 3: device {t['device_ms']} "
                            f"ms (profiler), "
                            f"{t['bound_ms'] / (t['device_ms'] or t['ms']):.1%}"
                            f" of the bound; the earlier serial design in "
                            f"the same turns {t['serial_ms']:.4f} ms, device "
                            f"{t['serial_device_ms']} ms")
            print(f"phase 5 {kernel} [{label}] on {card}: {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms{library}, bound "
                  f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes']} "
                  f"B, {t['operations']} ops)", flush=True)
    print(f"phase 5 one launch through its wrapper (K5, 1 sequence x 1 "
          f"step) on {card}: {launch_ms:.4f} ms", flush=True)

    step_ms, per_step = {}, {}
    step_fns = {name: step for name, (_, _, _, step) in paths.items()}
    step_fns["ysf_long"] = long_step
    for name, step in step_fns.items():
        before = smoke.launch_counts()
        step_ms[name] = time_ms(step, 20)
        per_step[name] = {k: (v - before[k]) / 22
                          for k, v in smoke.launch_counts().items()
                          if v != before[k]}
        print(f"phase 5 step {name} on {card}: {step_ms[name]:.4f} ms, "
              f"launches per step {per_step[name]}", flush=True)
    # the headline's provenance: the kernels its path launched in the run
    # just timed, not a name written here
    check(per_step["dmr_iq"] == {"fm_rrc": 1.0},
          f"dmr_iq launches per step {per_step['dmr_iq']}, want K1 once")
    flush_ms = {}
    for name, stream_name, _, _, protocol in BANKS:
        _, _, _, step_s, flush_s, steps, rounds, _ = banks[name]
        stream = getattr(smoke, stream_name)
        air_ms = stream.symbols_per_block * stream.sps / smoke.FS * 1e3
        print(f"phase 5 {name} on {card}: {step_s * 1e3:.4f} ms wall per "
              f"step against {air_ms:.1f} ms of air time, over {steps} steps "
              f"and {rounds} decode rounds (host machines and the "
              f"synchronisations of every fetch included), flush "
              f"{flush_s * 1e3:.1f} ms wall ("
              + ("" if protocol in TWO_FSK else "K4 on the tail, then ")
              + f"the per-symbol host oracle over {CHANNELS} channels)",
              flush=True)
        step_ms[name] = step_s * 1e3
        flush_ms[name] = flush_s * 1e3
    native_banks = time_native_banks(banks, opts.profile)
    for name, runs in native_banks.items():
        stream = getattr(smoke, dict((b[0], b[1]) for b in BANKS)[name])
        air_ms = stream.symbols_per_block * stream.sps / smoke.FS * 1e3
        with_native, with_numpy = (", ".join(f"{t:.4f}" for t in runs[mode])
                                   for mode in ("native", "numpy"))
        print(f"phase 5 {name} host Viterbi on {card}: wall ms per step with "
              f"the native decode {with_native}, with the numpy decode "
              f"{with_numpy} (turns numpy, "
              f"native, native, numpy; the whole stream through a fresh bank, "
              f"no flush) against {air_ms:.1f} ms of air", flush=True)
        for mode, split in runs.get("host", {}).items():
            print("profile " + json.dumps(dict(split, decode=mode)),
                  flush=True)
    print(f"phase 5 host: os.cpu_count() {os.cpu_count()}, CPUs this "
          f"process may run on {len(os.sched_getaffinity(0))}", flush=True)
    serving = {}
    for name, stream_name, protocol in MULTISTREAM:
        stream = getattr(smoke, stream_name)
        bank_name = f"{protocol}_bank"
        steps = banks[bank_name][5]
        air_ms = stream.symbols_per_block * stream.sps / smoke.FS * 1e3
        runs = multistream[name]
        serving[name] = {
            n: {"wall_ms_per_step": r["push_s"] / steps * 1e3,
                "flush_ms": r["flush_s"] * 1e3,
                "start_s": r["start_s"], "worker_start_s": r["worker_start_s"],
                "started_with": r["started_with"],
                "prewarm_s": r["prewarm_s"], "threads": r["threads"]}
            for n, r in sorted(runs.items())}
        for n, t in serving[name].items():
            print(f"phase 5 {name} n_procs {n} on {card}: "
                  f"{t['wall_ms_per_step']:.4f} ms wall per step (the single "
                  f"TrackedChannelBank {step_ms[bank_name]:.4f}, air "
                  f"{air_ms:.1f}) over {steps} steps, flush "
                  + (f"{t['flush_ms']:.1f} ms" if n == MULTISTREAM_PROCS
                     else "left out") + f"; start {t['start_s']:.3f} s (each "
                  f"worker from spawn to its first reply: "
                  f"{', '.join(f'{w:.3f}' for w in t['worker_start_s'])} s; "
                  f"{t['started_with']} workers starting at once), "
                  f"prewarm {t['prewarm_s']:.3f} s, torch threads a worker "
                  f"{t['threads']}", flush=True)
    for name, (step_s, flush_s, steps, _) in timesharded.items():
        print(f"phase 5 {name} on {card}: {step_s * 1e3:.4f} ms wall per "
              f"step over {steps} steps, flush {flush_s * 1e3:.1f} ms; "
              f"launches {scale[name]}", flush=True)
    for name in ("mesh_bank_dmr", *(n for n, *_ in SHARDED), "distributed",
                 *(n for n, *_ in MULTISTREAM)):
        print(f"phase 5 {name} launches {scale[name]}", flush=True)
    for tool, (cold, warm) in startups.items():
        print(f"phase 5 startup {tool} on {card}: cold {cold:.3f} s, warm "
              f"{warm:.3f} s", flush=True)
    for (name, backend), (wall, air, _, _) in chains.items():
        print(f"phase 5 cli {name} --backend {backend} on {card}: "
              f"{wall:.3f} s wall for {air:.3f} s of air ({wall / air:.2f} x"
              f" real time; processes started per stage included)",
              flush=True)

    # phase 6: the measuring programs, each a process of its own
    programs = run_programs(card)
    for label, (wall, lines) in programs.items():
        for line in lines:
            keys = ("metric", "value", "vs_baseline", "per_step_seconds",
                    "aggregate_msps", "per_proc_wall_s", "driver", "block",
                    "channels", "algo_latency_ms", "push_wall_ms",
                    "launches_per_step", "rep_checksums")
            print(f"phase 6 {label} ({wall:.1f} s, the four started "
                  f"together; exit 0, correct, "
                  f"distinct checksums) on {card}: "
                  + json.dumps({k: line[k] for k in keys if k in line}),
                  flush=True)
    iq_s = step_ms["dmr_iq"] / 1e3
    msps = CHANNELS * dmr.symbols_per_block * dmr.sps / iq_s / 1e6
    print(json.dumps({
        "metric": "dmr_iq_pipeline_throughput", "value": msps,
        "unit": "Msamples/s/chip", "vs_baseline": msps / 0.048,
        "channels": CHANNELS,
        "samples_per_step": dmr.symbols_per_block * dmr.sps,
        "per_step_seconds": iq_s,
        "kernel_path": " + ".join(KERNEL_OF_COUNTER[k]
                                  for k in per_step["dmr_iq"]),
        "k1_launches_per_step": per_step["dmr_iq"].get("fm_rrc", 0.0),
        "step_ms": step_ms,
        "dmr_bank_flush_ms": flush_ms["dmr_bank"],
        "bank_flush_ms": flush_ms,
        "launch_latency_ms": launch_ms, "card": card,
        "cli_wall_s": {f"{n} {b}": w for (n, b), (w, _, _, _) in
                       chains.items()},
        "tool_startup_s": startups,
        "multistream": serving,
        "timesharded_ms_per_step": {n: t[0] * 1e3
                                    for n, t in timesharded.items()},
        "host_viterbi_ms_per_step": {
            n: {k: r[k] for k in ("native", "numpy")}
            for n, r in native_banks.items()},
        "host_viterbi_call_ms": {k: {"native": a, "numpy": b}
                                 for k, (a, b) in native_ms.items()},
        "cpu_count": os.cpu_count(),
        "cpu_affinity": len(os.sched_getaffinity(0)),
        "torch": torch.__version__}), flush=True)

    if opts.profile:
        # first: cProfile only, no torch.profiler session
        print("profile " + json.dumps(profile_multistream(
            smoke, banks["dmr_bank"][5])), flush=True)
        for kernel, label, (kernel_name, call) in (
                (k, lb, timed[t["timed_index"]])
                for k, shapes in times.items() if k != "K6"
                for lb, t in shapes.items()):
            print("profile " + json.dumps({
                "kernel": kernel, "shape": label,
                "device_ms": kernel_device_ms(call, kernel_name)}),
                flush=True)
        for name, step in step_fns.items():
            print("profile " + json.dumps(profile_steps(name, step)),
                  flush=True)
        for name, stream_name, *_ in BANKS:
            _, _, push_all, _, _, steps, rounds, _ = banks[name]
            with smoke.function_bits(smoke.load(getattr(smoke,
                                                        stream_name))):
                print("profile " + json.dumps(dict(
                    profile_bank(name, push_all, steps),
                    decode_rounds_per_step=rounds / steps)), flush=True)
                print("profile " + json.dumps(profile_bank_host(
                    name, push_all, steps)), flush=True)
        # the serving and scale-out paths
        for name, stream_name, *_ in TIMESHARDED:
            _, _, steps, push_all = timesharded[name]
            with smoke.function_bits(smoke.load(getattr(smoke,
                                                        stream_name))):
                print("profile " + json.dumps(profile_bank(name, push_all,
                                                           steps)),
                      flush=True)
        print("profile " + json.dumps(profile_bank(
            "mesh_bank_dmr", mesh_push_all, mesh_steps)), flush=True)
        for name, step in sharded_steps.items():
            print("profile " + json.dumps(profile_steps(name, step, 3)),
                  flush=True)
        print("profile " + json.dumps(distributed_profile), flush=True)
        for line in profile_multistream_device(
                smoke, {name: banks[f"{protocol}_bank"][5]
                        for name, _, protocol in MULTISTREAM}):
            print("profile " + json.dumps(line), flush=True)
        turns = recorder_turns(smoke)
        print(f"profile {turns['path']} with KernelRecorder off and on on "
              f"{card}: " + json.dumps(turns), flush=True)

    def entry(kernel, name, source, replaces, count):
        shapes = list(times[kernel].items())
        label, main = shapes[0]
        out = {"name": name, "route": "cuda",
               "source": f"digiham_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[count],
               "soak_launches": soak_launches.get(count, 0),
               "max_abs_err": errs[kernel], "shape": label}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "serial_ms", "serial_device_ms")
        out.update({k: main[k] for k in keys if k in main})
        out["other_shapes"] = [dict(shape=lb, **{k: t[k] for k in keys
                                                 if k in t})
                               for lb, t in shapes[1:]]
        return out

    print(json.dumps({"kernels": [
        entry("K1", "demod_fm_front", "demod_front.cu", f"{PALLAS}:841",
              "fm_rrc"),
        entry("K2", "demod_front", "demod_front.cu", f"{PALLAS}:811", "rrc"),
        entry("K3", "demod", "demod_front.cu", f"{PALLAS}:638", "none"),
        entry("K4", "rrc_filter_block_kernel", "fir.cu",
              "digiham_tpu/ops/fir.py:54", "fir"),
        dict(entry("K5", "viterbi16", "viterbi.cu",
                   "digiham_tpu/ops/viterbi_pallas.py:149", "viterbi"),
             launches_4_states_phase3=k5_4_launches,
             note="one source, templated on the number of states; launches: "
                  "the 16-state instance on the main paths (no main path "
                  "runs 4 states: the D-Star header decodes on the host); "
                  "the 4-state rows replace the XLA scan the JAX package "
                  "runs at 4 states (digiham_tpu/fec/viterbi.py:93)"),
        dict(entry("K6", "digitalvoice_iir", "recurrence.cu",
                   "digiham_tpu/dsp/audio.py:62", "iir"),
             note="replaces an XLA lax.scan: no Pallas counterpart; its "
                  "second entry dc_block replaces digiham_tpu/dsp/fm.py:56; "
                  "serial_*: the earlier one-warp design "
                  "(csrc/recurrence_serial.cu) timed in the same turns"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = START
    rc = main()
    print(f"# chip_smoke wall {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
