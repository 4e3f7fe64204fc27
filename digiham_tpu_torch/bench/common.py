"""What the port's measuring programs share: the device, the provenance of
a run, the gate over the committed fixtures, the step loop with its
checksum, and the profiler window.

Every program runs on the card unless it is called with ``--device cpu``.
With no card it prints :func:`fail_line`'s line (``value: null`` and an
``error``) and exits non-zero; it never carries on on the CPU. Before any
timing it runs its pipeline over a committed fixture
(``digiham_tpu_torch/data/*_smoke.npz``) and holds every field to the JAX
package's; a failed gate prints the failure line, so no timed number is
ever printed without ``"correct": true`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .. import resolve_device, smoke

# one reference channel in real time: 48 kS/s (BASELINE.md), so
# vs_baseline = MS/s / 0.048 is the real-time channels one card carries
BASELINE_MSPS = 0.048
UNIT = "Msamples/s/chip"
# each step reads the window ``k * STRIDE`` into one base stream a rep
STRIDE = 512
# protocol -> (sps, the smoke stream that gates it)
PROTOCOLS = {"dmr": (10, smoke.DMR), "ysf": (10, smoke.YSF),
             "nxdn": (20, smoke.NXDN), "dstar": (10, smoke.DSTAR),
             "pocsag": (40, smoke.POCSAG)}


class GateFailed(RuntimeError):
    """The program's pipeline disagreed with its committed fixture."""


def add_arguments(parser, reps: bool = True) -> None:
    """``--device``, which every program takes; and for the programs whose
    unit is a rep, ``--seed`` and ``--profile``."""
    parser.add_argument("--device", default=None,
                        help="where to run: the card unless this says "
                             "otherwise (\"cpu\" runs the kernels' plain "
                             "versions)")
    if not reps:
        return
    parser.add_argument("--seed", type=int, default=0,
                        help="base of every rep's input seed")
    parser.add_argument("--profile", action="store_true",
                        help="after the timing, a shorter window under "
                             "torch.profiler: kernels and device busy ms "
                             "per step, and the idle share")


def fail_line(metric: str, backend: str, error: str, **extra) -> int:
    """bench.py's failure line: one parseable JSON object with a null
    value. Returns the exit code a program ends with."""
    print(json.dumps({"metric": metric, "value": None, "unit": UNIT,
                      "backend": backend, "error": error[-400:], **extra}),
          flush=True)
    return 1


def run_main(metric: str, body, argv=None) -> int:
    """Run ``body(argv)``, a program's main; turn the absence of a card, a
    failed gate or any other error into the failure line and exit 1."""
    try:
        return body(argv)
    except GateFailed as e:
        return fail_line(metric, "gate", str(e), correct=False)
    except Exception as e:  # a measuring program ends with a line
        import traceback

        no_card = "no CUDA device" in str(e)
        if not no_card:
            traceback.print_exc(file=sys.stderr)
        return fail_line(metric, "unavailable" if no_card else "error",
                         f"{type(e).__name__}: {e}")


def open_device(arg) -> torch.device:
    """The run's device: the card unless ``arg`` names another; raises
    (``resolve_device``) when there is no card."""
    dev = resolve_device(arg)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def backend(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def provenance(dev: torch.device) -> dict:
    """What this run ran on, read from the run itself: on the card its
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
    gives them, its highest SM clock, and the torch and CUDA versions."""
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cuda":
        out["card"] = _nvidia_smi("name,power.limit")
        out["kind"] = torch.cuda.get_device_name(dev)
        out["sm_clock_max_mhz"] = float(
            _nvidia_smi("clocks.max.sm").split()[0])
    else:
        out["card"] = None
    return out


def launches_since(before: dict, steps: int) -> dict:
    """Each kernel's launches per step since ``before``
    (``smoke.launch_counts()``), from the ops' ``LAUNCHES`` counters:
    ``fm_rrc`` K1, ``rrc`` K2, ``none`` K3, ``fir`` K4, ``viterbi`` K5,
    ``iir`` K6."""
    now = smoke.launch_counts()
    return {k: (now[k] - before[k]) / steps for k in now
            if now[k] != before[k]}


# -- pipelines and the gate ---------------------------------------------------

def make_pipeline(protocol: str, channels: int, n_centuries: int, device):
    """The protocol's bank pipeline at its sps (tools/bench_protocols.py's
    configurations): DMR and YSF at 10, NXDN at 20, D-Star 10, POCSAG 40."""
    from ..pipeline import DmrPipeline, FskPipeline, NxdnPipeline, YsfPipeline

    sps = PROTOCOLS[protocol][0]
    if protocol in ("dstar", "pocsag"):
        return FskPipeline(channels, protocol, n_centuries=n_centuries,
                           sps=sps, device=device)
    kind = {"dmr": DmrPipeline, "ysf": YsfPipeline,
            "nxdn": NxdnPipeline}[protocol]
    return kind(channels=channels, sps=sps, n_centuries=n_centuries,
                device=device)


def _frame_fields(protocol, pipe, dibits):
    """What the fixture holds beyond a step's outputs: NXDN's frame fields
    (``nxdn_decode_frames`` on the block's 192-symbol frames)."""
    if protocol != "nxdn":
        return {}
    from ..pipeline import nxdn_decode_frames

    n = pipe.symbols_per_block // 192
    return nxdn_decode_frames(
        dibits[:, :n * 192].reshape(pipe.channels, n, 192), pipe.tables())


def gate(protocol: str, channels: int, dev, iq: bool = False) -> dict:
    """The protocol's pipeline at ``channels`` over its committed fixture
    (``smoke.STEPS`` chained blocks, the fixture's stream variants tiled
    over the channels) at the fixture's block: raw I/Q planes through
    ``step_iq_planes`` when ``iq`` (DMR), FM audio through ``step``
    otherwise. Every field must equal the JAX package's on every channel;
    raises :class:`GateFailed` naming the first that does not. Returns
    what was checked."""
    stream = PROTOCOLS[protocol][1]
    fx = smoke.load(stream)
    variant = np.arange(channels) % fx["tx_dibits"].shape[0]
    pipe = make_pipeline(protocol, channels, stream.n_centuries, dev)
    state = pipe.init_state()
    outs = []
    if iq:
        re, im = (torch.from_numpy(p[variant]).to(dev) for p in
                  smoke.modulate(stream, fx["tx_dibits"], fx["noise_seeds"]))
        carry = (torch.ones(channels, device=dev),
                 torch.zeros(channels, device=dev))
    else:
        x = torch.from_numpy(smoke.audio(
            stream, fx["tx_dibits"], fx["noise_seeds"])[variant]).to(dev)
    for s in range(smoke.STEPS):
        o = s * stream.advance
        window = slice(o, o + stream.block_len)
        if iq:
            if s:
                state, carry = smoke.rebase_iq(stream, state, re, im, o)
            out, carry, state = pipe.step_iq_planes(
                re[:, window], im[:, window], *carry, state)
        else:
            if s:
                state = smoke.rebase_audio(stream, state, x, o)
            out, state = pipe.step(x[:, window], state)
        out.update(_frame_fields(protocol, pipe, out["dibits"]))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    for s, out in enumerate(outs):
        for k in stream.fields:
            want = fx[f"expected_{k}"][variant, s]
            got = out[k]
            if k == "fich_data":  # int64 holding the unsigned 32-bit word
                got = got.astype(np.uint32)
            if got.dtype != want.dtype or got.shape != want.shape:
                raise GateFailed(f"{protocol} step {s} {k}: {got.dtype} "
                                 f"{got.shape}, the fixture's {want.dtype} "
                                 f"{want.shape}")
            bad = int((got != want).reshape(channels, -1).any(1).sum())
            if bad:
                raise GateFailed(f"{protocol} step {s} {k} differs from the "
                                 f"JAX package's on {bad} of {channels} "
                                 f"channels")
    return {"fixture": f"digiham_tpu_torch/data/{stream.fixture.name}",
            "path": "step_iq_planes" if iq else "step",
            "channels": channels, "steps": smoke.STEPS,
            "n_centuries": stream.n_centuries, "sps": stream.sps,
            "fields": list(stream.fields)}


# -- the step loop ------------------------------------------------------------

def block_len(n_centuries: int, sps: int) -> int:
    """A step's window: ``n_centuries * (100 * sps + 1) + 8`` samples, as
    bench.py and tools/bench_protocols.py size it (the demod reads at most
    ``n_centuries * (100 * sps + 1) + 1`` from pos 0)."""
    return n_centuries * (100 * sps + 1) + 8


def base_stream(dev, seed: int, rows: int, length: int, planes: int,
                scale: float = 1.0):
    """One rep's input: ``planes`` [rows, length] float32 normal planes
    times ``scale``, drawn on ``dev`` from a generator seeded by
    ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = [torch.randn((rows, length), generator=g, device=dev)
           for _ in range(planes)]
    return out if scale == 1.0 else [p.mul_(scale) for p in out]


def _wrap32(total: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 it is modulo 2**32 (JAX sums int32 in
    int32 and wraps)."""
    return (total + 2 ** 31) % 2 ** 32 - 2 ** 31


def iq_checksum(out: dict) -> torch.Tensor:
    """bench.py's checksum of one raw-IQ DMR step (:322-329): the int32
    sums of dibits, dense sync distances, voice payload, BPTC data, sync
    type and TACT slot; an int64 tensor holding the int32 value."""
    return _wrap32(sum(out[k].to(torch.int64).sum() for k in (
        "dibits", "sync_dist_dense", "voice_payload", "bptc_data",
        "sync_type", "tact_slot")))


def iq_carry_checksum(state) -> torch.Tensor:
    """bench.py's checksum of the final carry (:393-396): the volume
    ring's and the RRC history's float sums cast to int32, and the
    offsets."""
    return (state.demod.volume_ring.sum().to(torch.int32).to(torch.int64)
            + state.demod.offset.to(torch.int64).sum()
            + state.rrc.history.sum().to(torch.int32).to(torch.int64))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_checksum(tree) -> torch.Tensor:
    """tools/bench_protocols.py's checksum: the float32 sum of every
    tensor of an output dict or a state."""
    return sum(t.to(torch.float32).sum() for t in _leaves(tree))


def iq_steps(pipe, re_base, im_base, state, L: int, steps: int):
    """bench.py's step loop on raw I/Q (``step_k``, :355-396): ``steps``
    dependent ``step_iq_planes`` calls on the windows ``[k * STRIDE, k *
    STRIDE + L)`` of the base planes, the demod's read index reset every
    step (bench.py's ``rebase``), the checksum of every step and of the
    final carry accumulated on the device. Returns the checksum (an int64
    tensor holding bench.py's int32) and the final state."""
    channels = re_base.shape[0]
    dev = re_base.device
    last_re = torch.ones(channels, device=dev)
    last_im = torch.zeros(channels, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(steps):
        window = slice(k * STRIDE, k * STRIDE + L)
        out, (last_re, last_im), state = pipe.step_iq_planes(
            re_base[:, window], im_base[:, window], last_re, last_im, state)
        acc = acc + iq_checksum(out)
        state.demod.pos = torch.zeros_like(state.demod.pos)
    return _wrap32(acc + iq_carry_checksum(state)), state


def audio_steps(pipe, base, state, L: int, steps: int):
    """tools/bench_protocols.py's step loop (``bench_pipe``, :34-58):
    ``steps`` dependent ``step`` calls on the windows of one FM-audio base
    row, pos reset every step, the float32 sums of every output and of the
    final state accumulated on the device."""
    acc = torch.zeros((), dtype=torch.float32, device=base.device)
    for k in range(steps):
        out, state = pipe.step(base[:, k * STRIDE:k * STRIDE + L], state)
        acc = acc + tree_checksum(out)
        state.demod.pos = torch.zeros_like(state.demod.pos)
    return acc + tree_checksum(state), state


# tools/bench_multistream.py's stage prefixes of the raw-IQ chain
# (``_make_stage_step``, :68-141): stage -> (base planes, their scale)
STAGE_PREFIXES = {"fm": (2, 1.0), "rrc": (1, 100.0), "demod": (1, 100.0),
                  "fm_rrc": (2, 1.0)}


def stage_steps(stage: str, pipe, planes, L: int, steps: int):
    """A stage prefix of the raw-IQ DMR chain over ``steps`` windows of one
    base stream (tools/bench_multistream.py's ``_make_stage_step``):
    ``fm`` the FM discriminator on I/Q planes, its carry chained; ``rrc``
    ``rrc_filter_block`` (K4) on FM-audio-scaled noise, its history
    chained; ``demod`` ``gfsk_demod_block`` (K3) with ``pos`` reset every
    step, the rest of its state chained; ``fm_rrc`` the two chained (the
    audio times 5,000). The float32 sum of every step's output (the
    symbols' for ``demod``, plus the final offsets) accumulated on the
    device; returns it."""
    from ..dsp.demod import demod_init, gfsk_demod_block
    from ..dsp.fm import fm_discriminator
    from ..dsp.rrc import WIDE_RRC, RrcState, rrc_filter_block

    dev = planes[0].device
    C = pipe.channels
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    last = (torch.ones(C, device=dev), torch.zeros(C, device=dev))
    rrc = RrcState.init(C, WIDE_RRC, dev)
    dm = demod_init(C, dev)
    for k in range(steps):
        win = [p[:, k * STRIDE:k * STRIDE + L] for p in planes]
        if stage in ("fm", "fm_rrc"):
            audio, last = fm_discriminator(*win, *last)
            if stage == "fm":
                acc = acc + audio.sum()
                continue
            win = [audio * 5000.0]
        if stage == "demod":
            dib, dm = gfsk_demod_block(win[0], dm, pipe.n_centuries,
                                       pipe.sps)
            acc = acc + dib.to(torch.float32).sum()
            dm.pos = torch.zeros_like(dm.pos)
        else:
            y, rrc = rrc_filter_block(win[0], rrc, WIDE_RRC)
            acc = acc + y.sum()
    if stage == "demod":
        acc = acc + dm.offset.sum()
    return acc


@dataclasses.dataclass
class Loop:
    """One program's timed unit, a rep: a base stream drawn on the device
    (seeded by the rep), then ``steps`` dependent pipeline steps over its
    windows, then the checksum fetched once. ``stage`` is ``"step_iq"``
    (raw I/Q planes through ``step_iq_planes``, bench.py's loop; DMR only),
    ``"step"`` (FM audio through ``step``, tools/bench_protocols.py's) or
    a stage prefix of the raw-IQ chain (:data:`STAGE_PREFIXES`,
    :func:`stage_steps`; DMR only)."""

    pipe: object
    stage: str
    steps: int

    def __post_init__(self):
        self.dev = self.pipe.device
        self.L = block_len(self.pipe.n_centuries, self.pipe.sps)
        self.length = self.L + STRIDE * (self.steps - 1)
        self.state0 = self.pipe.init_state()
        self.samples_per_step = (self.pipe.channels * self.pipe.n_centuries
                                 * 100 * self.pipe.sps)

    def run(self, seed: int):
        """One rep. Returns (checksum as a Python number, the base
        stream's generation ms: CUDA events on the card, None on the
        CPU)."""
        cuda = self.dev.type == "cuda"
        if cuda:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        iq = self.stage == "step_iq"
        # FM audio at bench_protocols' scale (x 100) or unit I/Q planes
        planes, scale = STAGE_PREFIXES.get(
            self.stage, (2, 1.0) if iq else (1, 100.0))
        base = base_stream(self.dev, seed, self.pipe.channels, self.length,
                           planes, scale)
        if cuda:
            events[1].record()
        if self.stage in STAGE_PREFIXES:
            value = float(stage_steps(self.stage, self.pipe, base, self.L,
                                      self.steps))
        elif iq:
            acc, _ = iq_steps(self.pipe, *base, self.state0, self.L,
                              self.steps)
            value = int(acc)
        else:
            acc, _ = audio_steps(self.pipe, base[0], self.state0, self.L,
                                 self.steps)
            value = float(acc)
        gen_ms = events[0].elapsed_time(events[1]) if cuda else None
        return value, gen_ms


def timed_reps(loop: Loop, seeds) -> dict:
    """The reps of ``seeds`` back to back under one host clock that ends
    with the last checksum fetched (which waits for the device). Returns
    the wall, the checksums, each rep's wall and generation ms, and the
    launches per step the window made."""
    before = smoke.launch_counts()
    checks, rep_s, gen_ms = [], [], []
    synchronize(loop.dev)
    t0 = time.perf_counter()
    for seed in seeds:
        t1 = time.perf_counter()
        value, gen = loop.run(seed)
        rep_s.append(time.perf_counter() - t1)
        checks.append(value)
        gen_ms.append(gen)
    wall = time.perf_counter() - t0
    n_steps = len(checks) * loop.steps
    return {"wall": wall, "checksums": checks, "rep_seconds": rep_s,
            "generation_ms": gen_ms, "n_steps": n_steps,
            "launches_per_step": launches_since(before, n_steps)}


def distinct(checksums) -> bool:
    """bench.py's guard (:456): the reps' checksums must differ."""
    return len(checksums) == 1 or len(set(checksums)) > 1


# -- the profiler window ------------------------------------------------------

# torch.profiler (Kineto over CUPTI) drops device records it takes to lie
# outside the session's capture window: CUPTI's kernel timestamps drift
# against the host's clock, by more the older the process, and Kineto logs
# the dropped records as "Out-of-range" (KINETO_LOG_LEVEL=0), a kernel
# before the runtime call that launched it. A 10-call session loses none
# of its kernels at the start of a process, 5 after 80 s, all 10 after
# 180 s (profiler_probe.py at the repository's root), and a session of a
# given work loses the same count when taken again at once. So a session
# opens margin_s before its work and closes margin_s after it, and between
# them runs a mark, one of the port's own kernels (K6's DC blocker on one
# sample), then the work. It is complete when every launch it saw has its
# device record: each runtime call of LAUNCH_CALLS the session recorded
# (every kernel launch, copy and fill, torch's and the port's) is matched
# to a device record by its correlation id, and the port's kernels it
# recorded are counted against their launch counters, the mark included
# (the port's libraries link the CUDA runtime statically, so their launch
# calls may not show). One that is not complete is taken again with the
# margins doubled, at most PROFILE_TRIES times; then the profile raises.
PROFILE_TRIES = 5
MARGIN_S = 0.25
PORT_KERNELS = ("demod_kernel", "fir_kernel", "viterbi_kernel",
                "iir_split_kernel", "dc_split_kernel")
# runtime and driver calls that each leave one device record
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
    "cudaMemset"))


def port_launches() -> int:
    """The port's kernel launches so far in this process (K1-K6), from
    the ops' counters."""
    from ..ops import demod_front, fir, recurrence, viterbi

    return (sum(demod_front.LAUNCHES.values()) + fir.LAUNCHES
            + viterbi.LAUNCHES + sum(recurrence.LAUNCHES.values()))


def device_events(prof):
    """The device events a profile recorded, in the order they ran."""
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def unmatched_launches(prof) -> dict:
    """The runtime calls of :data:`LAUNCH_CALLS` a profile recorded whose
    correlation id no device record carries, counted by name."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == cuda}
    out: dict = {}
    for e in events:
        if (e.device_type() != cuda and e.name() in LAUNCH_CALLS
                and e.correlation_id() not in recorded):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


class Session:
    """One torch.profiler session (CPU and CUDA activity) around a work,
    open ``margin_s`` before the mark and ``margin_s`` after the work.
    After it: ``events``, the device events of the work; ``lost``, the
    launches of the session with no device record (runtime calls by
    correlation id, the port's kernels by their counters); ``lost_by``,
    the same by name; ``complete`` when there are none."""

    def __init__(self, dev, margin_s: float = MARGIN_S):
        from torch.profiler import ProfilerActivity, profile

        self.dev = dev
        self.margin_s = margin_s
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        from ..ops import recurrence

        one = torch.zeros((1, 1), device=self.dev)
        synchronize(self.dev)
        self.before = port_launches()
        self.prof.__enter__()
        time.sleep(self.margin_s)
        recurrence.dc_block(one, one[:, 0], one[:, 0], 0.5)
        synchronize(self.dev)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            synchronize(self.dev)
            time.sleep(self.margin_s)
        self.prof.__exit__(*exc)
        self.complete = False
        if exc[0] is None:
            events = device_events(self.prof)
            ours = sum(1 for e in events
                       if any(k in e.name for k in PORT_KERNELS))
            self.lost_by = unmatched_launches(self.prof)
            port_lost = port_launches() - self.before - ours
            if port_lost:
                self.lost_by["the port's kernels"] = port_lost
            self.lost = sum(self.lost_by.values())
            self.complete = self.lost == 0
            self.events = events[1:] if self.complete else []  # the mark
        return False


def profiled(fn, dev) -> tuple[Session, float]:
    """``fn()`` under a :class:`Session`, taken again with the margins
    doubled until one is complete (at most :data:`PROFILE_TRIES`; then
    raises). Returns (the session: ``events`` are those of ``fn``,
    ``prof`` the profile, ``margin_s`` its margins; the wall seconds of
    ``fn`` and a synchronize)."""
    lost = []
    for t in range(PROFILE_TRIES):
        with Session(dev, MARGIN_S * 2 ** t) as session:
            t0 = time.perf_counter()
            fn()
            synchronize(dev)
            wall = time.perf_counter() - t0
        if session.complete:
            return session, wall
        lost.append(session.lost_by)
    raise RuntimeError(f"profile: torch.profiler lost device records in "
                       f"every one of {PROFILE_TRIES} sessions (launches "
                       f"without a record: {lost})")


def profile_window(fn, steps: int, dev) -> dict:
    """Kernels and device busy ms per step, and the idle share, of
    ``fn()`` (``steps`` steps) under :func:`profiled`. A window in which
    the profiler recorded no device kernel raises: the device path was not
    seen."""
    session, wall = profiled(fn, dev)
    kernels = session.events
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    if not kernels or busy_ms <= 0:
        raise RuntimeError("profile: torch.profiler recorded no device "
                           "kernel in the window")
    wall_ms = wall * 1e3 / steps
    return {"kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms,
            "wall_ms_per_step": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms}
