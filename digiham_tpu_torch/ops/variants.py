"""Variants of kernels K3, K4, K5 and K6, built and timed beside the
kernels as they are: the measurements behind the choices in
``csrc/demod_front.cu``, ``csrc/fir.cu``, ``csrc/viterbi.cu`` and
``csrc/recurrence.cu``. Needs an NVIDIA GPU and ``nvcc``; nothing here runs
on import and no part of the port calls it.

    python3 -m digiham_tpu_torch.ops.variants             # from the repo root
    python3 -m digiham_tpu_torch.ops.variants K6          # one kernel's only

K3's list is tools/bench_demod_pallas.py's ``BENCH_ABLATE`` (:78-85): the
kernel with its timing search switched off (no column variances, no slew)
and with its AGC switched off (fixed -1 / +1 window), timing only. Its
``shift`` ablation switched off the TPU's lane shifter, which the card's
kernel does not have.

K6's list also holds its earlier one-warp design, kept whole as
``csrc/recurrence_serial.cu`` (every design constant of the split one
differs from it, so no text replacement could make it).

Each variant is the committed source with some text replaced (another
constant, a part switched off, an alternative loop), compiled into
``build/digiham_tpu_torch/variants/``, launched through ctypes, held
against the plain version (``exact`` says whether it agrees; a variant with
a part switched off cannot) and timed on the device with torch.profiler.
One JSON line per variant, in two rounds (so the spread shows), then the
host cost of what a wrapper call is made of.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..fec.viterbi import conv_encode, viterbi_decode_plain
from . import build, demod_front, fir, recurrence, viterbi

_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_longlong)


def _between(text: str, start: str, end: str, new: str) -> str:
    """``text`` with everything from ``start`` up to ``end`` replaced."""
    a = text.index(start)
    return text[:a] + new + text[text.index(end, a):]


# --- K3: the JAX tool's ablations (one part switched off, inexact) ---------

_TIMING_FROM = "      const float* cv = colv + (c & 1) * sps;"
_TIMING_TO = "      pos = pos + n + off;"
_COLUMNS = ("      for (int kc0 = SW - 1 - warp; kc0 < sps; "
            "kc0 += COLUMNS_AT_ONCE * SW) {")
_WINDOW = ("        const float wmin = fminf(omn[q], q < 3 ? bmn[q + 1] : nmn);\n"
           "        const float wmax = fmaxf(omx[q], q < 3 ? bmx[q + 1] : nmx);")
K3_VARIANTS = {
    "as committed": [],
    "timing search off (inexact)": [
        (_COLUMNS, "      for (int kc0 = sps; kc0 < sps; "
                   "kc0 += COLUMNS_AT_ONCE * SW) {"),
        ("between", (_TIMING_FROM, _TIMING_TO,
                     "      const int new_off = 0;\n"))],
    "AGC off (inexact)": [
        ("    scan100<false>(bmn, bmx, lane);", "    "),
        ("    scan100<true>(omn, omx, lane);", "    "),
        (_WINDOW, "        const float wmin = -1.0f;\n"
                  "        const float wmax = 1.0f;")],
}
# label -> (channels, centuries, sps): tools/bench_demod_pallas.py's shape
# and the YSF path's
K3_SHAPES = {"256 ch x 8 centuries, sps 10": (256, 8, 10),
             "256 ch x 10 centuries, sps 10": (256, 10, 10)}


def _k3_sources(source: str) -> dict[str, str]:
    out = {}
    for name, replacements in K3_VARIANTS.items():
        text = source
        for old, new in replacements:
            if old == "between":
                text = _between(text, *new)
                continue
            if old not in text:
                raise RuntimeError(f"K3 variant '{name}': '{old}' not found")
            text = text.replace(old, new)
        out[name] = text
    return out


def k3_call(lib, samples, pos, offset, ring, nc: int, sps: int):
    """One launch of ``lib``'s K3 entry (gfsk), uncounted: (dibits, pos,
    offset, ring)."""
    from ..dsp.demod import CENTURY, _eval_bounds

    C, L = samples.shape
    dev = samples.device
    lo, hi = _eval_bounds(sps)
    outs = [torch.empty((C, nc * CENTURY), dtype=torch.uint8, device=dev),
            torch.empty((C,), dtype=torch.int32, device=dev),
            torch.empty((C,), dtype=torch.int32, device=dev),
            torch.empty((C, CENTURY), dtype=torch.float32, device=dev)]
    rc = lib.digiham_demod(*[t.data_ptr() for t in
                             (samples, pos, offset, ring, *outs)],
                           C, L, sps, lo, hi, nc,
                           demod_front.MODES[("gfsk", False)], _stream())
    if rc:
        raise RuntimeError(f"K3 variant launch failed: CUDA error {rc}")
    return outs


def run_k3(dev, card: str) -> None:
    from ..dsp.demod import demod_init

    data = {}
    for label, (channels, nc, sps) in K3_SHAPES.items():
        g = torch.Generator(device=dev)
        g.manual_seed(nc)
        st = demod_init(channels, dev)
        args = (500 * torch.randn((channels, nc * (100 * sps + 1) + 8),
                                  generator=g, device=dev),
                st.pos, st.offset, st.volume_ring)
        data[label] = (args, nc, sps, demod_front.demod_plain(
            *args, n_centuries=nc, sps=sps))
    sources = _k3_sources((build.CSRC / demod_front.SOURCE).read_text())
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda a: _compile("demod_front", *a),
                              enumerate(sources.values())))
    for rnd in range(2):
        for name, (lib, ptxas) in zip(sources, built):
            lib.digiham_demod.argtypes = demod_front._SIGNATURES[
                "digiham_demod"]
            lib.digiham_demod.restype = _I
            exact, ms = True, {}
            for label, (args, nc, sps, want) in data.items():
                got = k3_call(lib, *args, nc, sps)
                torch.cuda.synchronize()
                exact = exact and all(torch.equal(a, b)
                                      for a, b in zip(got, want))
                ms[label] = _device_ms(lambda: k3_call(lib, *args, nc, sps),
                                       "demod_kernel")
            print(json.dumps({"kernel": "K3", "round": rnd, "variant": name,
                              "exact": exact, "device_ms": ms,
                              "registers": ptxas, "card": card}), flush=True)


# --- K4: one constant or one part at a time --------------------------------

_OUTPUTS = "constexpr int FIR_OUTPUTS = 7;"
_THREADS = "constexpr int THREADS = 256;"
_BLOCKS = "constexpr int MIN_BLOCKS = 4;"
_STORE = ("    for (int r = 0; r < FIR_OUTPUTS; ++r) out_s[first + r] = "
          "acc[r];\n  }\n  __syncwarp();")
_STORE_DIRECT = (
    "    for (int r = 0; r < FIR_OUTPUTS; ++r)\n"
    "      if (first + r < n_out) (y + (size_t)c * T + t0)[first + r] = "
    "acc[r];\n  }\n  return;")

K4_VARIANTS = {
    "as committed: 7 outputs a thread, 16-byte staging, 256 threads": [],
    "3 outputs a thread": [(_OUTPUTS, "constexpr int FIR_OUTPUTS = 3;")],
    "5 outputs a thread": [(_OUTPUTS, "constexpr int FIR_OUTPUTS = 5;")],
    "9 outputs a thread": [(_OUTPUTS, "constexpr int FIR_OUTPUTS = 9;"),
                           (_BLOCKS, "constexpr int MIN_BLOCKS = 3;")],
    "11 outputs a thread": [(_OUTPUTS, "constexpr int FIR_OUTPUTS = 11;"),
                            (_BLOCKS, "constexpr int MIN_BLOCKS = 3;")],
    "4-byte staging only": [("if (i >= i0 && i + 4 <= n_in) {",
                             "if (false) {")],
    "outputs stored straight from registers": [(_STORE, _STORE_DIRECT)],
    "128 threads a block": [(_THREADS, "constexpr int THREADS = 128;"),
                            (_BLOCKS, "constexpr int MIN_BLOCKS = 8;")],
    "512 threads a block": [(_THREADS, "constexpr int THREADS = 512;"),
                            (_BLOCKS, "constexpr int MIN_BLOCKS = 2;")],
    "2 blocks an SM asked": [(_BLOCKS, "constexpr int MIN_BLOCKS = 2;")],
    "6 blocks an SM asked": [(_BLOCKS, "constexpr int MIN_BLOCKS = 6;")],
}

# --- K5 ---------------------------------------------------------------------

_WARPS = "constexpr int WARPS = 2;"
_FORWARD_FROM = "  uint32_t cur = mine[0];"
_FORWARD_TO = "  // the lowest-numbered minimal final state"
_BACK_FROM = "    unsigned word = words[T - 1] >> low;"
_BACK_TO = "  __syncthreads();\n\n  int* out = s.bits"
_BACK_LOOP = "    for (int u = T - 1; u >= 0; --u) {"
_GROUPS = "  const int groups = row_bytes / GROUP;"

# a byte load and a byte store per step, each read one step early
_FORWARD_BYTES = """  const uint8_t* mine8 = sym + row * row_bytes;
  int d = mine8[0];
  for (int t = 0; t < T; ++t) {
    const int d_next = mine8[t + 1 < T ? t + 1 : t];
    const bool take1 = t < s.blocked
                           ? trellis_step<S, true>(m, d, t, i, p, e0, e1)
                           : trellis_step<S, false>(m, d, t, i, p, e0, e1);
    const unsigned word = __ballot_sync(FULL, take1);
    if (lane == 0) words[t] = word;
    d = d_next;
  }
  (void)groups;

"""
_BACK_BYTES = """    uint8_t* mine8 = sym + row * row_bytes;
    unsigned word = words[T - 1];
    for (int u = T - 1; u >= 0; --u) {
      const unsigned word_next = words[u ? u - 1 : 0];
      mine8[u] = state >> (St::BITS - 1);
      state = ((state << 1) & (S - 2)) | ((word >> (low + state)) & 1);
      word = word_next;
    }
  }
"""

# 8 lanes a sequence, 2 states a lane (2j and 2j + 1), 4 sequences a warp:
# new state i reads both slots of lane i & 7, so a step is 4 shuffles and 2
# ballots
_LANES8 = r"""
constexpr int SEQS8 = 4 * WARPS;
template <int S>
__global__ void __launch_bounds__(THREADS)
viterbi_kernel(const __grid_constant__ Segments a) {
  extern __shared__ __align__(16) uint32_t smem[];
  Segment s = a.seg[0];
#pragma unroll
  for (int k = 1; k < MAX_SEGMENTS; ++k)
    if (k < a.count && (int)blockIdx.x >= a.seg[k].first_block) s = a.seg[k];
  const int T = s.steps;
  const int seq0 = ((int)blockIdx.x - s.first_block) * SEQS8;
  const int nseq = min(SEQS8, s.batch - seq0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, j = lane & 7;
  uint32_t* words = smem + warp * 2 * T;  // [WARPS][T][2]
  uint8_t* sym = reinterpret_cast<uint8_t*>(smem + WARPS * 2 * T);
  for (int at = tid; at < SEQS8 * T; at += THREADS) {
    const int r = at / T;
    sym[at] = r < nseq ? load_dibit(s.obs, s.elem_size,
                                    (long long)(seq0 + r) * s.row_stride +
                                        (at - r * T)) & 3
                       : 0;
  }
  __syncthreads();
  const int ia = 2 * j, ib = 2 * j + 1, la = ia & 7, lb = ib & 7;
  const int ea0 = (a.exp0 >> (2 * ia)) & 3, ea1 = (a.exp1 >> (2 * ia)) & 3;
  const int eb0 = (a.exp0 >> (2 * ib)) & 3, eb1 = (a.exp1 >> (2 * ib)) & 3;
  const int row = 4 * warp + q;
  uint8_t* mine = sym + row * T;
  int ma = 0, mb = 0;
  int d = mine[0];
  const int blocked = min(s.blocked, T);
  for (int t = 0; t < T; ++t) {
    const int d_next = mine[t + 1 < T ? t + 1 : t];
    const int a0 = __shfl_sync(FULL, ma, la, 8);
    const int a1 = __shfl_sync(FULL, mb, la, 8);
    const int b0 = __shfl_sync(FULL, ma, lb, 8);
    const int b1 = __shfl_sync(FULL, mb, lb, 8);
    const int mask = t < blocked ? (15 << t) & 15 : 0;
    const int ca0 = a0 + __popc(ea0 ^ d), cb0 = b0 + __popc(eb0 ^ d);
    int ca1 = a1 + __popc(ea1 ^ d), cb1 = b1 + __popc(eb1 ^ d);
    if (ia & mask) ca1 = BIG;
    if (ib & mask) cb1 = BIG;
    const bool ta = ca1 < ca0, tb = cb1 < cb0;
    ma = ta ? ca1 : ca0;
    mb = tb ? cb1 : cb0;
    const unsigned wa = __ballot_sync(FULL, ta), wb = __ballot_sync(FULL, tb);
    if (lane == 0) {
      words[2 * t] = wa;
      words[2 * t + 1] = wb;
    }
    d = d_next;
  }
  int key = min((ma << 4) | ia, (mb << 4) | ib);
#pragma unroll
  for (int x = 4; x; x >>= 1) key = min(key, __shfl_xor_sync(FULL, key, x, 8));
  __syncwarp();
  if (j == 0 && row < nseq) {
    s.metric[seq0 + row] = key >> 4;
    int state = key & 15;
    const int low = 8 * q;
    unsigned wa = words[2 * (T - 1)], wb = words[2 * (T - 1) + 1];
    for (int u = T - 1; u >= 0; --u) {
      const int v = u ? u - 1 : 0;
      const unsigned na = words[2 * v], nb = words[2 * v + 1];
      mine[u] = state >> 3;
      const unsigned w = (state & 1) ? wb : wa;
      state = ((state << 1) & 14) | ((w >> (low + (state >> 1))) & 1);
      wa = na;
      wb = nb;
    }
  }
  __syncthreads();
  int* out = s.bits + (size_t)seq0 * T;
  for (int at = tid; at < nseq * T; at += THREADS) out[at] = sym[at];
}

template <int S>
size_t smem_of(int steps) {
  return (size_t)steps * (2 * WARPS * sizeof(uint32_t) + SEQS8);
}

"""


def _k5_sources(source: str) -> dict[str, str]:
    by_bytes = _between(_between(source, _FORWARD_FROM, _FORWARD_TO,
                                 _FORWARD_BYTES),
                        _BACK_FROM, _BACK_TO, _BACK_BYTES)
    lanes8 = _between(source, "template <int S>\n__global__ void "
                      "__launch_bounds__(THREADS)\nviterbi_kernel",
                      "template <int S>\nint launch(Segments& a", _LANES8)
    lanes8 = lanes8.replace(
        "(a.seg[k].batch + States<S>::SEQS - 1) / States<S>::SEQS",
        "(a.seg[k].batch + SEQS8 - 1) / SEQS8")
    no_back = source.replace(_BACK_LOOP, _BACK_LOOP.replace("u >= 0",
                                                            "u >= T"))
    no_forward = source.replace(_GROUPS, "  const int groups = 0;")
    out = {
        "as committed: 16 lanes a sequence, 4 steps a turn, 2 warps": source,
        "1 warp a block": source.replace(_WARPS, "constexpr int WARPS = 1;"),
        "4 warps a block": source.replace(_WARPS, "constexpr int WARPS = 4;"),
        "a byte load and a byte store per step": by_bytes,
        "8 lanes x 2 states, 4 sequences a warp": lanes8,
        "traceback off (inexact)": no_back,
        "forward off (inexact)": no_forward,
        "forward and traceback off (inexact)": no_back.replace(
            _GROUPS, "  const int groups = 0;"),
    }
    for name, text in out.items():
        if name != next(iter(out)) and text == source:
            raise RuntimeError(f"K5 variant '{name}': nothing was replaced")
    return out


def _compile(stem: str, n: int, text: str):
    """-> (loaded library, registers and spills from -Xptxas -v)."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{stem}_{n}.cu", out / f"{stem}_{n}.so"
    cu.write_text(text)
    proc = subprocess.run(
        [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
         "-fPIC", "-I", str(build.CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr[-3000:]}")
    used = [ln.split("Used")[1].split(",")[0].strip()
            for ln in proc.stderr.splitlines() if "Used" in ln]
    spills = sum("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                 "loads" not in ln for ln in proc.stderr.splitlines())
    return ctypes.CDLL(str(so)), f"{', '.join(used)}; spills: {spills}"


def _device_ms(fn, kernel_name: str, runs: int = 20) -> float:
    """Mean device time of the named kernel over ``runs`` calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel_name in e.name]
    if len(events) != runs:
        raise RuntimeError(f"{len(events)} {kernel_name} kernels in {runs} "
                           f"calls")
    return sum(e.device_time for e in events) / 1e3 / runs


def _host_us(fn, calls: int = 3000) -> float:
    """Host microseconds per call of fn in a tight loop (no wait for the
    device inside it)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def _stream() -> int:
    return build.stream_pointer(torch.device("cuda"))


def run_k4(dev, card: str) -> None:
    rng = np.random.default_rng(4)
    shapes = {"256 ch x 16128 x 81 taps": (256, 16128, 81),
              "256 ch x 8064 x 161 taps": (256, 8064, 161),
              "129 ch x 5003 x 129 taps": (129, 5003, 129),
              "64 ch x 60000 x 81 taps": (64, 60000, 81)}
    data = {}
    for label, (channels, length, ntaps) in shapes.items():
        g = torch.Generator(device=dev)
        g.manual_seed(ntaps + length)
        taps = torch.from_numpy(rng.normal(0, 0.3, ntaps)
                                .astype(np.float32)).to(dev)
        # one odd-strided array, samples off a 16-byte boundary
        x = 800 * torch.randn((channels, length + ntaps), generator=g,
                              device=dev)[:, 1:]
        data[label] = (x, taps, fir.fir_cmajor_plain(x, taps))
    source = (build.CSRC / fir.SOURCE).read_text()
    texts = []
    for name, replacements in K4_VARIANTS.items():
        text = source
        for old, new in replacements:
            if old not in text:
                raise RuntimeError(f"K4 variant '{name}': '{old}' not found")
            text = text.replace(old, new)
        texts.append(text)
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda a: _compile("fir", *a),
                              enumerate(texts)))
    for rnd in range(2):
        for name, (lib, ptxas) in zip(K4_VARIANTS, built):
            fn = lib.digiham_fir
            fn.argtypes = [_P, _L, _P, _L, _P, _P, _I, _I, _I, _P]
            fn.restype = _I
            exact, ms = True, {}
            for label, (x, taps, want) in data.items():
                halo = taps.shape[0] - 1
                y = torch.empty_like(want)

                def call():
                    return fn(x.data_ptr(), x.stride(0),
                              x[:, halo:].data_ptr(), x.stride(0),
                              taps.data_ptr(), y.data_ptr(), y.shape[0],
                              y.shape[1], halo + 1, _stream())

                rc = call()
                torch.cuda.synchronize()
                exact = exact and rc == 0 and torch.equal(y, want)
                ms[label] = _device_ms(call, "fir_kernel")
            print(json.dumps({"kernel": "K4", "round": rnd, "variant": name,
                              "exact": exact, "device_ms": ms,
                              "registers": ptxas, "card": card}), flush=True)


def run_k5(dev, card: str) -> None:
    rng = np.random.default_rng(5)

    def inputs(batch, steps, blocked, noise):
        if noise:
            obs = rng.integers(0, 4, (batch, steps))
        else:
            bits = rng.integers(0, 2, (batch, steps))
            bits[:, :blocked] = 0
            obs = conv_encode(bits)
            flips = rng.random(obs.shape) < 0.12
            obs = np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
        obs = torch.from_numpy(obs.astype(np.uint8)).to(dev)
        return obs, blocked, viterbi_decode_plain(obs, 16, blocked)

    cases = {f"{b} x {t}{' blocked' if bl else ''}"
             f"{' noise' if noise else ''}": inputs(b, t, bl, noise)
             for b, t, bl in ((512, 100, 0), (512, 36, 4), (512, 96, 4),
                              (3, 7, 4), (5, 2, 4), (1000, 101, 0), (512, 1, 0))
             for noise in (False, True)}
    timed = ("512 x 100", "512 x 36 blocked", "512 x 96 blocked", "512 x 1")
    sources = _k5_sources((build.CSRC / viterbi.SOURCE).read_text())
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda a: _compile("viterbi", *a),
                              enumerate(sources.values())))
    exp0, exp1 = viterbi._packed_expected()
    for rnd in range(2):
        for name, (lib, ptxas) in zip(sources, built):
            one, many = lib.digiham_viterbi16, lib.digiham_viterbi16_many
            one.argtypes = viterbi._SIGNATURES["digiham_viterbi16"]
            many.argtypes = viterbi._SIGNATURES["digiham_viterbi16_many"]
            one.restype = many.restype = _I
            exact, ms = True, {}
            for label, (obs, blocked, want) in cases.items():
                bits = torch.empty(obs.shape, dtype=torch.int32, device=dev)
                metric = torch.empty(obs.shape[:1], dtype=torch.int32,
                                     device=dev)

                def call():
                    return one(obs.data_ptr(), 1, obs.stride(0),
                               bits.data_ptr(), metric.data_ptr(),
                               obs.shape[0], obs.shape[1], blocked, exp0,
                               exp1, _stream())

                rc = call()
                torch.cuda.synchronize()
                exact = (exact and rc == 0 and torch.equal(bits, want[0])
                         and torch.equal(metric, want[1]))
                if label in timed:
                    ms[label] = _device_ms(call, "viterbi_kernel<16>")
            # a YSF step's launch: two batches of 512 x 100
            fields, outs = [], []
            for label in ("512 x 100", "512 x 100 noise"):
                obs, blocked, want = cases[label]
                bits = torch.empty(obs.shape, dtype=torch.int32, device=dev)
                metric = torch.empty(obs.shape[:1], dtype=torch.int32,
                                     device=dev)
                fields += (obs.data_ptr(), bits.data_ptr(),
                           metric.data_ptr(), obs.stride(0), 1, obs.shape[0],
                           obs.shape[1], blocked)
                outs.append((bits, metric, want))
            packed = (_L * len(fields))(*fields)

            def call():
                return many(packed, 2, exp0, exp1, _stream())

            rc = call()
            torch.cuda.synchronize()
            exact = exact and rc == 0 and all(
                torch.equal(b, w[0]) and torch.equal(m, w[1])
                for b, m, w in outs)
            ms["2 x (512 x 100), one launch"] = _device_ms(
                call, "viterbi_kernel<16>")
            print(json.dumps({"kernel": "K5", "round": rnd, "variant": name,
                              "exact": exact, "device_ms": ms,
                              "registers": ptxas, "card": card}), flush=True)


# --- K6: the split design's constants, and the earlier serial design -------

_HELPER_WARPS = "constexpr int HELPER_WARPS = 3;"
_TILE = "constexpr int TILE = 32 * ORDER;"
_SLOTS = "constexpr int SLOTS = 3;"
_AHEAD = "constexpr int AHEAD = 2;"

_IIR_TURN = "constexpr int IIR_TURN = 4 * ORDER;"
_DC_TURN = "constexpr int DC_TURN = 8 * ORDER;"
# name -> (text replacements, the channels a block takes: None is the
# wrapper's choice, recurrence.block_rows)
K6_VARIANTS = {
    "as committed: the wrapper's channels a block, 3 helper warps, "
    "320-sample tiles, 3 slots, raw copies 2 tiles ahead, chain turns of "
    "40 samples (IIR) and 80 (DC blocker)": ([], None),
    "16 channels a block": ([], 16),
    "8 channels a block": ([], 8),
    "4 channels a block": ([], 4),
    "16 channels a block, 7 helper warps": (
        [(_HELPER_WARPS, "constexpr int HELPER_WARPS = 7;")], 16),
    "2 helper warps": (
        [(_HELPER_WARPS, "constexpr int HELPER_WARPS = 2;")], None),
    "160-sample tiles": ([(_TILE, "constexpr int TILE = 16 * ORDER;")], None),
    "2 slots": ([(_SLOTS, "constexpr int SLOTS = 2;")], None),
    "raw copies 1 tile ahead": (
        [(_AHEAD, "constexpr int AHEAD = 1;")], None),
    "chain turns of 10 samples (IIR) and 10 (DC blocker)": (
        [(_IIR_TURN, "constexpr int IIR_TURN = ORDER;"),
         (_DC_TURN, "constexpr int DC_TURN = ORDER;")], None),
    "chain turns of 20 samples (IIR) and 40 (DC blocker)": (
        [(_IIR_TURN, "constexpr int IIR_TURN = 2 * ORDER;"),
         (_DC_TURN, "constexpr int DC_TURN = 4 * ORDER;")], None),
    "chain turns of 80 samples (IIR) and 160 (DC blocker)": (
        [(_IIR_TURN, "constexpr int IIR_TURN = 8 * ORDER;"),
         (_DC_TURN, "constexpr int DC_TURN = 16 * ORDER;")], None),
    # one part switched off at a time (inexact): which side holds it back
    "chain off (inexact)": (
        [("    if (live) {\n      float* row = ring",
          "    if (false) {\n      float* row = ring")], None),
    "forward sums and differences off (inexact)": (
        [("      forward_sums(x, ring",
          "      if (false) forward_sums(x, ring"),
         ("      differences(ring", "      if (false) differences(ring")],
        None),
    "scaled inputs off (inexact)": (
        [("      scaled_inputs(x, raws",
          "      if (false) scaled_inputs(x, raws")], None),
    "drain off (inexact)": (
        [("      drain(ring", "      if (false) drain(ring")], None),
    "raw copies off (inexact)": (
        [("if (w * PER_WORD < off + n) cp_async4", "if (false) cp_async4")],
        None),
}
K6_SERIAL = "the earlier one-warp design (csrc/recurrence_serial.cu)"
# label -> (entry, channels, samples): the bank's voice post-filter (4 s of
# 8 kHz voice, and the dmr_bank fixture's), a digitalvoice_filter chunk,
# the DC blocker at a bank's 1 s of 48 kHz and at one channel
K6_SHAPES = {
    "iir 256 x 32000": ("iir", 256, 32000),
    "iir 1 x 32768": ("iir", 1, 32768),
    "iir 256 x 783": ("iir", 256, 783),
    "dc_block 256 x 48000": ("dc_block", 256, 48000),
    "dc_block 1 x 32768": ("dc_block", 1, 32768),
}
# each kernel's name in a trace: the split design's, the serial one's
K6_KERNELS = {"iir": ("iir_split_kernel", "digitalvoice_kernel"),
              "dc_block": ("dc_split_kernel", "dc_block_kernel")}


def k6_inputs(dev, entry: str, channels: int, length: int, seed: int,
              pcm_dtype=torch.int16):
    """Seeded inputs made on the device: for the IIR, PCM from speech level
    to far past full scale (a gain drawn per channel; int16 clamped, int32
    three times as loud and not clamped) and random carries; for the DC
    blocker, unit-variance floats and carries."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if entry == "dc_block":
        return [torch.randn(s, generator=g, device=dev)
                for s in ((channels, length), (channels,), (channels,))]
    gain = 300 + 12000 * torch.rand((channels, 1), generator=g, device=dev)
    pcm = gain * torch.randn((channels, length), generator=g, device=dev)
    if pcm_dtype == torch.int16:
        pcm = pcm.clamp(-32768, 32767).to(torch.int16)
    else:
        pcm = (3 * pcm).round().to(pcm_dtype)
    return [pcm, 0.05 * torch.randn((channels, 10), generator=g, device=dev),
            0.2 * torch.randn((channels, 10), generator=g, device=dev)]


def k6_call(lib, entry: str, args, rows: int | None):
    """One launch of ``lib``'s K6 entry on ``args`` (uncounted); ``rows``
    channels a block, None for the serial design."""
    if entry == "dc_block":
        return recurrence.dc_launch(lib, *args, 0.999, rows)
    from ..dsp.audio import _FEEDBACK, _FORWARD, GAIN, SHRT_MAX

    return recurrence.iir_launch(lib, *args, _FORWARD, _FEEDBACK, SHRT_MAX,
                                 GAIN, rows)


def k6_plain(entry: str, args):
    if entry == "dc_block":
        return recurrence.dc_block_plain(*args, 0.999)
    from ..dsp.audio import _FEEDBACK, _FORWARD, GAIN, SHRT_MAX

    return recurrence.digitalvoice_iir_plain(*args, _FORWARD, _FEEDBACK,
                                             SHRT_MAX, GAIN)


def run_k6(dev, card: str) -> None:
    data = {label: (entry, args, k6_plain(entry, args))
            for i, (label, (entry, channels, length)) in
            enumerate(K6_SHAPES.items())
            for args in [k6_inputs(dev, entry, channels, length, 90 + i)]}
    source = (build.CSRC / recurrence.SOURCE).read_text()
    texts = []
    for name, (replacements, _) in K6_VARIANTS.items():
        text = source
        for old, new in replacements:
            if old not in text:
                raise RuntimeError(f"K6 variant '{name}': '{old}' not found")
            text = text.replace(old, new)
        texts.append(text)
    texts.append((build.CSRC / recurrence.SERIAL_SOURCE).read_text())
    names = [*K6_VARIANTS, K6_SERIAL]
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda a: _compile("recurrence", *a),
                              enumerate(texts)))
    sms = recurrence.sm_count(torch.cuda.current_device())
    for rnd in range(2):
        for name, (lib, ptxas) in zip(names, built):
            serial = name == K6_SERIAL
            for fn, argtypes in (recurrence.SERIAL_SIGNATURES if serial
                                 else recurrence._SIGNATURES).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            fixed = None if serial else K6_VARIANTS[name][1]
            exact, ms = True, {}
            for label, (entry, args, want) in data.items():
                rows = None if serial else (
                    fixed or recurrence.block_rows(args[0].shape[0], sms))
                try:
                    got = k6_call(lib, entry, args, rows)
                except RuntimeError as e:  # a variant the card refuses
                    exact, ms[label] = False, str(e)
                    continue
                torch.cuda.synchronize()
                exact = exact and all(torch.equal(g, w)
                                      for g, w in zip(got, want))
                ms[label] = _device_ms(lambda: k6_call(lib, entry, args, rows),
                                       K6_KERNELS[entry][serial], runs=5)
            print(json.dumps({"kernel": "K6", "round": rnd, "variant": name,
                              "exact": exact, "device_ms": ms,
                              "registers": ptxas, "card": card}), flush=True)


def run_host(dev, card: str) -> None:
    """What a wrapper call costs the host, part by part."""
    rng = np.random.default_rng(6)
    obs = [torch.from_numpy(rng.integers(0, 4, (256, 2, 100))
                            .astype(np.uint8)).to(dev) for _ in range(2)]
    shapes = [(256, 2, 100), (256, 2)] * 2
    sizes = [int(np.prod(s)) for s in shapes]

    def four_allocations():
        return [torch.empty(s, dtype=torch.int32, device=dev) for s in shapes]

    def one_allocation():
        whole = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
        return [part.view(s) for part, s in
                zip(whole.split_with_sizes(sizes), shapes)]

    one, _, exp0, exp1 = viterbi._entries(16)
    bits, metric = viterbi.viterbi16(obs[0])
    stream = _stream()
    flat = obs[0].view(-1, 100)
    parts = {
        "viterbi16 (512 x 100)": lambda: viterbi.viterbi16(obs[0]),
        "viterbi16_many (2 x 512 x 100)": lambda: viterbi.viterbi16_many(
            [(obs[0], 0), (obs[1], 0)]),
        "4 x torch.empty": four_allocations,
        "torch.empty + split_with_sizes + 4 views": one_allocation,
        "one torch.empty": lambda: torch.empty(100, dtype=torch.int32,
                                               device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "build.stream_pointer(dev)": lambda: build.stream_pointer(dev),
        "with torch.cuda.device(dev)": lambda: torch.cuda.device(
            dev).__enter__(),
        "build.on_device(dev)": lambda: build.on_device(dev),
        "ops.viterbi._rows": lambda: viterbi._rows(obs[0], 0),
        "the bare ctypes launch": lambda: one(
            flat.data_ptr(), 1, 100, bits.data_ptr(), metric.data_ptr(), 512,
            100, 0, exp0, exp1, stream),
    }
    for rnd in range(2):
        print(json.dumps({"host_us_per_call": {
            name: round(_host_us(fn), 2) for name, fn in parts.items()},
            "round": rnd, "card": card}), flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = {"K3": run_k3, "K4": run_k4, "K5": run_k5, "K6": run_k6,
            "host": run_host}
    for name in (sys.argv[1:] if argv is None else argv) or runs:
        runs[name](dev, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
