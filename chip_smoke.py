"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero, with no
result line):
  1. the device: a CUDA card must be present; prints its name and power
     limit as nvidia-smi reports them;
  2. builds kernel K1 (csrc/demod_front.cu) with nvcc from this checkout;
  3. K1 against its plain PyTorch version on the card, at the main path's
     shape (256 channels x 16 centuries, sps 10) on a synthesized 4FSK I/Q
     bank with a seeded per-channel noise floor, and on a small inverted
     2FSK bank: dibits, pos and offset exact, floats within 1e-3;
  4. the main path, DmrPipeline(channels=256, sps=10, n_centuries=16)
     .step_iq_planes, over 3 chained steps of the committed DMR fixture
     (digiham_tpu_torch/data/dmr_smoke.npz); the decoded fields must equal
     the JAX package's on every channel, and K1 must have launched once per
     step;
  5. times (CUDA events, after warm-up): K1 alone, its plain version, and
     the whole step, with a line in bench.py's JSON shape.
Then the kernels line and, last, the device line.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

CHANNELS, SPS, N_CENTURIES = 256, 10, 16
RING_ATOL = 1e-3  # float outputs: f32 rounding-order envelope
K1_REPLACES = "digiham_tpu/ops/demod_pallas.py:841"


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


def fsk_bank(dev, channels, length, levels, seed):
    """Rect FSK I/Q planes on the card: random symbols, continuous phase,
    complex noise with a per-channel floor drawn from the seed."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lv = torch.tensor(levels, dtype=torch.float64, device=dev)
    sym = torch.randint(0, len(levels), (channels, length // SPS + 2),
                        generator=g, device=dev)
    freq = lv[sym].repeat_interleave(SPS, dim=1)[:, :length] * 1944.0
    phase = 2 * np.pi * torch.cumsum(freq, dim=1) / 48000.0
    sigma = 0.01 + 0.04 * torch.rand((channels, 1), generator=g,
                                     dtype=torch.float64, device=dev)
    noise = torch.randn((2, channels, length), generator=g,
                        dtype=torch.float64, device=dev) * sigma
    return ((torch.cos(phase) + noise[0]).float().contiguous(),
            (torch.sin(phase) + noise[1]).float().contiguous())


def k1_args(dev, channels, n_centuries, length, levels, seed):
    from digiham_tpu_torch.dsp.rrc import WIDE_RRC

    re, im = fsk_bank(dev, channels, length, levels, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    return [re, im, re[:, 0].clone(), im[:, 0].clone(),
            300 * torch.randn((channels, WIDE_RRC.ntaps - 1), generator=g,
                              device=dev),
            WIDE_RRC.taps_tensor(dev),
            torch.randint(0, 16, (channels,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.randint(-1, 2, (channels,), generator=g, device=dev,
                          dtype=torch.int32),
            300 * torch.randn((channels, 100), generator=g, device=dev)]


def compare_k1(args, **kw):
    """K1 vs its plain version on the same inputs. Returns max |float
    difference| (ring and RRC history)."""
    from digiham_tpu_torch.ops import demod_front

    got = demod_front.demod_fm_front(*args, **kw)
    want = demod_front.demod_fm_front_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dibits", "pos", "offset"), got[:3], want[:3]):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"K1 {name} differ from the plain version {kw}: "
              f"{int((g != w).sum())} of {g.numel()}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[3:], want[3:]))
    check(err <= RING_ATOL, f"K1 ring/history differ by {err} {kw}")
    return err


def main():
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
    print(f"phase 1 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from digiham_tpu_torch import smoke
    from digiham_tpu_torch.ops import demod_front
    from digiham_tpu_torch.pipeline import DmrPipeline

    # phase 2: build K1 from this checkout
    path, build_s, report = demod_front.build()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: K1 {path.name} in {build_s:.1f} s | "
          + " | ".join(ptxas[:6]), flush=True)

    # phase 3: K1 vs plain on the card
    L = smoke.BLOCK_LEN
    main_args = k1_args(dev, CHANNELS, N_CENTURIES, L,
                        [1 / 3, 1.0, -1 / 3, -1.0], seed=11)
    main_kw = dict(n_centuries=N_CENTURIES, sps=SPS)
    err = compare_k1(main_args, **main_kw)
    small_kw = dict(n_centuries=3, sps=SPS, mode="fsk", invert=True)
    err = max(err, compare_k1(k1_args(dev, 32, 3, 3 * 1001 + 40,
                                      [-1.0, 1.0], seed=12), **small_kw))
    print(f"phase 3 K1 == plain: dibits/pos/offset exact at {CHANNELS} ch x "
          f"{N_CENTURIES} centuries (gfsk) and 32 ch x 3 (fsk inverted); "
          f"max float diff {err}", flush=True)

    # phase 4: the main path on the DMR fixture
    fx = smoke.load()
    V = fx["tx_dibits"].shape[0]
    re_np, im_np = smoke.modulate(fx["tx_dibits"], fx["noise_seeds"])
    variant = np.arange(CHANNELS) % V
    re = torch.from_numpy(re_np[variant]).to(dev)
    im = torch.from_numpy(im_np[variant]).to(dev)
    pipe = DmrPipeline(channels=CHANNELS, sps=SPS, n_centuries=N_CENTURIES,
                       device=dev)
    state = pipe.init_state()
    carry = (torch.ones(CHANNELS, device=dev),
             torch.zeros(CHANNELS, device=dev))
    outs = []
    demod_front.LAUNCHES = 0
    for s in range(smoke.STEPS):
        o = s * smoke.ADVANCE
        if s:
            state, carry = smoke.rebase(state, re, im, o)
        out, carry, state = pipe.step_iq_planes(
            re[:, o:o + L], im[:, o:o + L], *carry, state)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    launches = demod_front.LAUNCHES
    check(launches == smoke.STEPS,
          f"K1 launched {launches} times in {smoke.STEPS} steps")
    n_frames = N_CENTURIES * 100 // 144
    dibit_diffs = 0
    for s, out in enumerate(outs):
        check(out["dibits"].shape == (CHANNELS, N_CENTURIES * 100),
              "dibits shape")
        check(out["sync_dist_dense"].shape == (CHANNELS,
                                               N_CENTURIES * 100 - 23, 4),
              "sync_dist_dense shape")
        for k in ("voice_payload", "sync_type", "slot_type_ok",
                  "data_type", "bptc_data", "bptc_ok"):
            want = fx[f"expected_{k}"][variant, s]
            check(out[k].shape[:2] == (CHANNELS, n_frames)
                  and out[k].dtype == want.dtype
                  and np.array_equal(out[k], want),
                  f"step {s} {k} differs from the JAX package's on "
                  f"{int((out[k] != want).reshape(CHANNELS, -1).any(1).sum())}"
                  " channels")
        dibit_diffs += int((out["dibits"]
                            != fx["expected_dibits"][variant, s]).sum())
    ok_frames = int(sum(o["bptc_ok"].sum() for o in outs))
    print(f"phase 4 main path: {smoke.STEPS} chained steps x {CHANNELS} ch; "
          f"fields equal the JAX package's on every channel; K1 launches "
          f"{launches}; BPTC-ok frames {ok_frames}; dibits differing from "
          f"JAX's {dibit_diffs}", flush=True)

    # phase 5: times on the card
    k1_ms = time_ms(lambda: demod_front.demod_fm_front(*main_args,
                                                        **main_kw), 20)
    plain_ms = time_ms(lambda: demod_front.demod_fm_front_plain(
        *main_args, **main_kw), 5, warmup=1)
    st0 = pipe.init_state()
    c0 = (torch.ones(CHANNELS, device=dev), torch.zeros(CHANNELS, device=dev))
    blk = (re[:, :L].contiguous(), im[:, :L].contiguous())
    before = demod_front.LAUNCHES
    iters = 20
    step_ms = time_ms(lambda: pipe.step_iq_planes(*blk, *c0, st0), iters)
    per_step = (demod_front.LAUNCHES - before) / (iters + 2)
    check(per_step == 1, f"K1 launches per timed step: {per_step}")
    msps = CHANNELS * N_CENTURIES * 100 * SPS / (step_ms / 1e3) / 1e6
    print(f"phase 5 times on {card}: K1 {k1_ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, step_iq_planes {step_ms:.4f} ms", flush=True)
    print(json.dumps({
        "metric": "dmr_iq_pipeline_throughput", "value": msps,
        "unit": "Msamples/s/chip", "vs_baseline": msps / 0.048,
        "channels": CHANNELS, "samples_per_step": N_CENTURIES * 100 * SPS,
        "per_step_seconds": step_ms / 1e3,
        "kernel_path": "K1 cuda demod_fm_front" if per_step == 1 else
                       "plain", "k1_launches_per_step": per_step,
        "card": card, "torch": torch.__version__}), flush=True)

    print(json.dumps({"kernels": [{
        "name": "demod_fm_front", "route": "cuda",
        "source": "digiham_tpu_torch/csrc/demod_front.cu",
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": k1_ms, "plain_ms": plain_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"# chip_smoke wall {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
