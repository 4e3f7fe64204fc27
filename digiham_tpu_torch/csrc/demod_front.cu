// K1, K2, K3: the century demodulator for Hopper (sm_90a) behind one of
// three fronts, one source and one kernel template.
//
//   FRONT fm_rrc (K1) replaces digiham_tpu/ops/demod_pallas.py::
//     pallas_demod_fm_front_block: raw I/Q planes in.
//   FRONT rrc    (K2) replaces ...::pallas_demod_front_block: FM audio in.
//   FRONT none   (K3) replaces ...::pallas_demod_block: filtered samples in.
//
// Per channel the kernel computes
//   1. (fm_rrc) the FM quadrature discriminator
//      atan2(x * conj(x_prev)) / pi * fm_scale; (rrc) the samples as they
//      are; both behind the carried RRC history, and the new history (the
//      last ntaps-1 values of that row);
//   2. (fm_rrc, rrc) the RRC FIR y[t] = sum_j taps[j] * ext[t + j] over
//      ext = [hist | row], at the samples a century can read and no others;
//   3. the serial century loop: per 100 symbols the volume and mid-third
//      means, the per-column timing variance and the +-1 slew decision;
//   4. the 100-wide sliding min/max AGC and the 4- or 2-level slicer.
// Semantics: digiham_tpu/dsp/demod.py (_century), dsp/rrc.py and dsp/fm.py;
// the op order is that of the plain versions in
// digiham_tpu_torch/ops/demod_front.py (FM step, tap-by-tap FIR, pairwise
// fold sums), every rounding explicit (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn never contract into FMA), so kernel and plain version agree bit
// for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32). Per sample K1
// moves 8 B and does one atan2f plus ntaps multiply-adds, K2 moves 4 B for
// the same FIR: both are bound by operations. K3 moves 4 B for a handful
// of adds: bytes. The card's fp32 rate counts a fused multiply-add as two
// operations issued as one. The bit-exact contract forbids fusing, so the
// FIR issues a multiply and an add for every tap: half the operations
// bound is this design's ceiling. Under that ceiling a channel is one
// serial chain of centuries (century c+1 reads where century c's timing
// decision sends it), so the kernel takes as long as one chain once every
// channel is resident, and a chain is short only if its filter does not
// wait for its statistics.
//
// The design, one block of 384 threads per channel:
//   - Windows, not rows. Century c of a block that entered at pos_0 reads
//     the filtered row only inside [pos_0 + c*n - c - 1, pos_0 + (c+1)*n +
//     c + 1] (n = 100*sps; each slew is -1, 0 or +1), known before the loop
//     starts: window_start / window_len below, century_window() in
//     ops/demod_front.py. Shared memory is a few windows, the taps and 200
//     floats a century, whatever the block length: 47 KB at 16 centuries x
//     sps 10 x 81 taps, so two blocks and more share an SM and 256 channels
//     are resident at once on 132 SMs. Samples no century can read are
//     never filtered.
//   - The filter runs one century ahead of the statistics, in other warps.
//     While warps 0-4 take century c's statistics from one slot of
//     filtered samples, warps 5-11 discriminate (K1) and filter the window
//     of century c+1 into the other slot, and start the cp.async copies of
//     century c+2's inputs into the input slot that fell free. Nothing
//     they do depends on century c's decision, so one block barrier per
//     century orders it all (K1 adds a barrier among the filter warps,
//     between discriminator and FIR).
//   - The FIR (fir_span.cuh, which K4 runs too) gives each thread 5
//     consecutive outputs and a sliding register window of inputs: per 8
//     taps 8 conflict-free input loads (the lane stride 5 is odd) and two
//     16-byte broadcast loads of taps for 80 multiplies and adds, against 2
//     loads per pair before. The rounding order is untouched: acc =
//     taps[0]*x[t], then acc + taps[j]*x[t+j] for j = 1.., each product and
//     sum rounded on its own.
//   - The symbol matrix is read once. For the timing a warp holds 4 rows a
//     lane of two columns in registers (100 -> 50 -> 25 in the lane,
//     25 -> 13 -> 7 -> 4 -> 2 -> 1 by shuffles, the same pairwise tree as
//     fold_sum) for the mean and then the variance. For the volumes a
//     thread per symbol folds its row in registers at the sps the protocols
//     use (10, 20, 40), else in a private strided scratch. After the
//     barrier the statistics warps take the first-minimum argmin of the sps
//     variances with two warp reductions (lowest index on ties) and keep
//     pos and offset in registers.
//   - The AGC's sliding minimum and maximum over [ring | volumes] are a
//     suffix scan of one century's volumes and a prefix scan of the next,
//     a warp per century, in registers (exact in any order).
//   - K3 has no row to filter: the slots hold its filtered input, and all
//     its warps take the statistics.
// Tensor cores are not used: a TF32 product would break the f32 decision
// contract, and a split-precision product is another rounding order.
// None of the TPU workarounds is carried over: no lane shifter, no 128-lane
// padding, no selection matmuls, no polynomial atan2, no banded-matmul RRC,
// no resident/staged twins.
//
// Contract: pos >= 0, offset in {-1, 0, 1} (anything else is taken as 0)
// and L >= max(pos) + n_centuries * (100 * sps + 1) + 1. Reads of the
// (filtered) row outside [0, L) give 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "fir_span.cuh"  // fir_span: the register-window FIR, shared with K4

namespace {

constexpr int CENTURY = 100;
constexpr int THREADS = 384;
constexpr int WARPS = THREADS / 32;
// K1, K2: warps 0-4 take the statistics (two columns each at sps 10); the
// other 7 filter: 7 x 32 x FIR_OUTPUTS covers a window at sps 10 in one pass
constexpr int STATS_WARPS = 5;
constexpr int FIR_THREADS = THREADS - 32 * STATS_WARPS;
// columns a warp folds side by side, so that their shuffle chains overlap
constexpr int COLUMNS_AT_ONCE = 2;
constexpr int FIR_BARRIER = 1;  // named barrier of the filter warps (0: block)
constexpr int MIN_BLOCKS = 2;   // per SM: 256 channels on 132 SMs at once
// the widest symbol the argmin below reads: 4 column variances a lane (the
// JAX kernel's limit, digiham_tpu/ops/demod_pallas.py:85; POCSAG at 512
// baud and 48 kS/s is sps 94)
constexpr int MAX_SPS = 128;
constexpr int COLV_PER_LANE = MAX_SPS / 32;
constexpr int FIR_OUTPUTS = 5;  // per thread, consecutive; odd: no bank conflicts
constexpr int SLACK = 8;        // floats past a window that the FIR may read
constexpr float VMIN_GUARD = 5000000.0f;
// float32(pi), the divisor of the JAX package and of the plain version
constexpr float PI_F = 3.14159265358979323846f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(CENTURY == 100, "the column fold is written for 100 rows");
static_assert(FIR_OUTPUTS % 2 == 1 && FIR_OUTPUTS - 1 <= SLACK, "FIR tiling");
static_assert(32 * STATS_WARPS >= CENTURY, "a statistics thread per symbol");
static_assert(MAX_SPS % 32 == 0, "the argmin reads whole lanes of variances");

enum Front { FRONT_FM_RRC = 0, FRONT_RRC = 1, FRONT_NONE = 2 };

struct Args {
  const float* in0;      // fm_rrc: the I plane; rrc, none: the samples [C, L]
  const float* in1;      // fm_rrc: the Q plane
  const float* last_re;  // fm_rrc: [C] carry
  const float* last_im;
  const float* hist;     // fm_rrc, rrc: [C, ntaps-1] RRC history
  const float* taps;     // fm_rrc, rrc: [ntaps]
  const int* pos_in;
  const int* off_in;
  const float* ring_in;
  uint8_t* dib;
  int* pos_out;
  int* off_out;
  float* ring_out;
  float* hist_out;       // fm_rrc, rrc: [C, ntaps-1]
  int L, ntaps, sps, lo, hi, nc;
  float fm_scale;
};

// The filtered samples century c can read, relative to the block's entry
// pos: [window_start, window_start + window_len). century_window() in
// ops/demod_front.py is the same arithmetic.
__host__ __device__ inline int window_start(int c, int sps) {
  return c * CENTURY * sps - c - 1;
}
__host__ __device__ inline int window_len(int c, int sps) {
  return CENTURY * sps + 2 * c + 3;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of one block, in floats per part; the kernel's
// pointers and smem_bytes() in ops/demod_front.py follow it. No part
// depends on the block length L.
struct Carve {
  int slot;   // one plane of one input slot: widest window + history + lead
  int slots;  // 2 slots x planes
  int ext;    // fm_rrc: one discriminated window with its history
  int filt;   // fm_rrc, rrc: one slot of the filtered widest window
  int taps;   // fm_rrc, rrc: tap j at [j + 3], so taps 1.. are 16-byte aligned
  int scr;    // row-fold scratch, [ceil(sps/2)][100]
  int vols;   // [(nc + 1) * 100] ring, then every century's volumes
  int mids;   // [nc * 100] mid-third means
  int colv;   // [2][sps] column variances of even and odd centuries
  __host__ __device__ size_t total() const {
    return (size_t)slots + ext + 2 * filt + taps + scr + vols + mids + colv;
  }
};

__host__ __device__ inline Carve carve(int front, int ntaps, int sps, int nc) {
  const int halo = front == FRONT_NONE ? 0 : ntaps - 1;
  const int lead = front == FRONT_FM_RRC ? 1 : 0;
  const int widest = window_len(nc - 1, sps);
  Carve k;
  k.slot = round4(widest + halo + lead + SLACK);
  k.slots = 2 * (front == FRONT_FM_RRC ? 2 : 1) * k.slot;
  k.ext = front == FRONT_FM_RRC ? round4(widest + halo + SLACK) : 0;
  k.filt = front == FRONT_NONE ? 0 : round4(widest);
  k.taps = front == FRONT_NONE ? 0 : fir_tap_floats(ntaps);
  k.scr = CENTURY * ((sps + 1) / 2);
  k.vols = (nc + 1) * CENTURY;
  k.mids = nc * CENTURY;
  k.colv = 2 * sps;  // sized by the launch's sps, not the cap
  return k;
}

// The end of fold_sum over 100 rows, for N columns side by side (their
// chains of shuffles overlap): lanes 0..24 hold the sums after 100 -> 50 ->
// 25; 25 -> 13 -> 7 -> 4 -> 2 -> 1 by shuffles (h = ceil(w/2), x[i] +=
// x[i+h] for i < w-h). The sums are lane 0's.
template <int N>
__device__ __forceinline__ void fold25(float (&v)[N], int lane) {
#pragma unroll
  for (int w = 25; w > 1;) {
    const int h = (w + 1) >> 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float other = __shfl_down_sync(FULL, v[j], h);
      if (lane < w - h) v[j] = __fadd_rn(v[j], other);
    }
    w = h;
  }
}

// fold_sum of x[0..W) in registers, in place, in the same pairwise order.
template <int W, int N>
__device__ __forceinline__ float fold_regs(float (&x)[N]) {
  if constexpr (W == 1) {
    return x[0];
  } else {
    constexpr int H = (W + 1) / 2;
#pragma unroll
    for (int i = 0; i < W - H; ++i) x[i] = __fadd_rn(x[i], x[i + H]);
    return fold_regs<H, N>(x);
  }
}

// The middle third of a symbol, round(sps/3) .. round(2*sps/3), where
// neither is a tie (sps 10, 20, 40).
template <int SPS> struct Mid {
  static constexpr int LO = (2 * SPS + 3) / 6, HI = (4 * SPS + 3) / 6;
};

// One symbol's volume and mid-third sums with the symbol in registers:
// the sps the protocols use are folded here, any other by fold_row.
template <int SPS>
__device__ __forceinline__ void row_sums(const float* sym, float& vol,
                                         float& mid) {
  constexpr int LO = Mid<SPS>::LO, M = Mid<SPS>::HI - Mid<SPS>::LO;
  float x[SPS], y[M];
#pragma unroll
  for (int k = 0; k < SPS; ++k) x[k] = sym[k];
#pragma unroll
  for (int k = 0; k < M; ++k) y[k] = x[LO + k];
  vol = fold_regs<SPS, SPS>(x);
  mid = fold_regs<M, M>(y);
}

// fold_sum of src[0..w) by one thread, in the same pairwise order, through
// a private scratch of ceil(w/2) floats at stride CENTURY (thread i owns
// scr[i + k*CENTURY]: no bank conflicts between the threads of a warp).
__device__ __forceinline__ float fold_row(const float* src, int w, float* scr) {
  if (w == 1) return src[0];
  int h = (w + 1) >> 1;
  for (int k = 0; k < w - h; ++k)
    scr[k * CENTURY] = __fadd_rn(src[k], src[k + h]);
  if (w & 1) scr[(h - 1) * CENTURY] = src[h - 1];
  for (w = h; w > 1; w = h) {
    h = (w + 1) >> 1;
    for (int k = 0; k < w - h; ++k)
      scr[k * CENTURY] = __fadd_rn(scr[k * CENTURY], scr[(k + h) * CENTURY]);
  }
  return scr[0];
}

// The FM discriminator's value of sample (xr, xi) after (yr, yi): the op
// sequence of dsp/fm.py and the plain version.
__device__ __forceinline__ float fm_step(float xr, float xi, float yr,
                                         float yi, float fm_scale) {
  const float prod_re = __fadd_rn(__fmul_rn(xr, yr), __fmul_rn(xi, yi));
  const float prod_im = __fsub_rn(__fmul_rn(xi, yr), __fmul_rn(xr, yi));
  return __fmul_rn(__fdiv_rn(atan2f(prod_im, prod_re), PI_F), fm_scale);
}

// Inclusive running minimum and maximum of the 100 values a warp holds as
// lane l < 25 -> elements 4l..4l+3 (lanes 25.. hold +-infinity), from the
// first element on (FORWARD) or from the last back.
template <bool FORWARD>
__device__ __forceinline__ void scan100(float (&mn)[4], float (&mx)[4],
                                        int lane) {
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const int at = FORWARD ? q : 3 - q, from = FORWARD ? q - 1 : 4 - q;
    mn[at] = fminf(mn[at], mn[from]);
    mx[at] = fmaxf(mx[at], mx[from]);
  }
  // the lanes before (FORWARD) or after this one, all their elements
  float lo = mn[FORWARD ? 3 : 0], hi = mx[FORWARD ? 3 : 0];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float a = FORWARD ? __shfl_up_sync(FULL, lo, d)
                            : __shfl_down_sync(FULL, lo, d);
    const float b = FORWARD ? __shfl_up_sync(FULL, hi, d)
                            : __shfl_down_sync(FULL, hi, d);
    if (FORWARD ? lane >= d : lane + d < 32) {
      lo = fminf(lo, a);
      hi = fmaxf(hi, b);
    }
  }
  const float a = FORWARD ? __shfl_up_sync(FULL, lo, 1)
                          : __shfl_down_sync(FULL, lo, 1);
  const float b = FORWARD ? __shfl_up_sync(FULL, hi, 1)
                          : __shfl_down_sync(FULL, hi, 1);
  if (FORWARD ? lane >= 1 : lane + 1 < 32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mn[q] = fminf(mn[q], a);
      mx[q] = fmaxf(mx[q], b);
    }
  }
}

// MODE 0: gfsk 4-level; 1: fsk; 2: fsk inverted
template <int FRONT, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
demod_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LEAD = FRONT == FRONT_FM_RRC ? 1 : 0;  // the sample before
  constexpr int PLANES = FRONT == FRONT_FM_RRC ? 2 : 1;
  // warps that take the statistics; the others filter one century ahead
  constexpr int SW = FRONT == FRONT_NONE ? WARPS : STATS_WARPS;
  const int L = a.L, ntaps = a.ntaps, sps = a.sps, lo = a.lo, hi = a.hi;
  const int nc = a.nc;
  const int halo = FRONT == FRONT_NONE ? 0 : ntaps - 1;
  const int n = CENTURY * sps;
  const int m = hi - lo;
  const int nsym = nc * CENTURY;
  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // this warp's part: the statistics, or the filter one century ahead
  const bool stats = warp < SW;
  const int ft = tid - 32 * SW;  // this thread among the filter threads
  // carve-up; keep in step with carve()
  const Carve k = carve(FRONT, ntaps, sps, nc);
  float* slots = smem;            // [2][PLANES][k.slot] window inputs
  float* ext = slots + k.slots;   // K1: [history | audio] of one window
  float* filts = ext + k.ext;     // K1, K2: [2][k.filt] filtered windows
  float* tap_s = filts + 2 * k.filt;
  float* scr = tap_s + k.taps;
  float* vols = scr + k.scr;
  float* mids = vols + k.vols;
  float* colv = mids + k.mids;    // [2][sps]

  const float* row0 = a.in0 + (size_t)ch * L;
  const float* row1 = FRONT == FRONT_FM_RRC ? a.in1 + (size_t)ch * L : nullptr;
  const float* hist =
      FRONT == FRONT_NONE ? nullptr : a.hist + (size_t)ch * halo;
  int pos = a.pos_in[ch], off = a.off_in[ch];
  if (off < -1 || off > 1) off = 0;
  const int pos0 = pos;

  // Start the copy of century c's inputs into input slot c & 1, by threads
  // t of nt: slot[i] is row sample pos0 + window_start(c) - halo - LEAD + i.
  // Outside the row it is the carried history (K2; K1 reads it in its FM
  // pass) or 0.
  auto load_window = [&](int c, int t, int nt) {
    float* dst = slots + (c & 1) * PLANES * k.slot;
    const int first = pos0 + window_start(c, sps) - halo - LEAD;
    const int len = window_len(c, sps) + halo + LEAD;
    for (int i = t; i < len; i += nt) {
      const int r = first + i;
      if (r >= 0 && r < L) {
        __pipeline_memcpy_async(dst + i, row0 + r, sizeof(float));
        if (PLANES == 2)
          __pipeline_memcpy_async(dst + k.slot + i, row1 + r, sizeof(float));
      } else {
        dst[i] = (FRONT == FRONT_RRC && r < 0 && r >= -halo) ? hist[halo + r]
                                                            : 0.0f;
        if (PLANES == 2) dst[k.slot + i] = 0.0f;
      }
    }
    __pipeline_commit();
  };

  // Discriminate (K1) and filter century c's whole window from input slot
  // c & 1 into filtered slot c & 1, by threads t of nt (the whole block
  // before the loop, the filter warps inside it): filtered sample ws + i,
  // 0 outside [0, L), at index i.
  auto filter_window = [&](int c, int t, int nt) {
    const float* slot = slots + (c & 1) * PLANES * k.slot;
    float* out = filts + (c & 1) * k.filt;
    const int ws = pos0 + window_start(c, sps);
    const int count = window_len(c, sps);
    const float* x = slot;  // x[i]: [hist | row] sample ws + i, row ws - halo + i
    if (FRONT == FRONT_FM_RRC) {
      for (int i = t; i < count + halo; i += nt) {
        const int r = ws - halo + i;
        float v = 0.0f;
        if (r < 0) {
          if (r >= -halo) v = hist[halo + r];
        } else if (r < L) {
          const float* s = slot + LEAD + i;
          v = fm_step(s[0], s[k.slot], r ? s[-1] : a.last_re[ch],
                      r ? s[k.slot - 1] : a.last_im[ch], a.fm_scale);
        }
        ext[i] = v;
      }
      if (nt == THREADS) __syncthreads();
      else asm volatile("bar.sync %0, %1;" ::"n"(FIR_BARRIER), "n"(FIR_THREADS)
                        : "memory");
      x = ext;
    }
    for (int t0 = t * FIR_OUTPUTS; t0 < count; t0 += nt * FIR_OUTPUTS) {
      float acc[FIR_OUTPUTS];
      fir_span<FIR_OUTPUTS>(x + t0, tap_s, ntaps, acc);
#pragma unroll
      for (int r = 0; r < FIR_OUTPUTS; ++r) {
        const int idx = ws + t0 + r;
        if (t0 + r < count) out[t0 + r] = (idx >= 0 && idx < L) ? acc[r] : 0.0f;
      }
    }
  };

  // prologue: first window, ring, taps, and the new history (the row's
  // tail, whether a century reads it or not; L > ntaps, so it is in the row)
  load_window(0, tid, THREADS);
  for (int t = tid; t < CENTURY; t += THREADS)
    vols[t] = a.ring_in[(size_t)ch * CENTURY + t];
  if (FRONT != FRONT_NONE) {
    for (int t = tid; t < ntaps; t += THREADS) tap_s[t + 3] = a.taps[t];
    for (int t = tid; t < halo; t += THREADS) {
      const int r = L - halo + t;
      a.hist_out[(size_t)ch * halo + t] =
          FRONT == FRONT_FM_RRC
              ? fm_step(row0[r], row1[r], row0[r - 1], row1[r - 1], a.fm_scale)
              : row0[r];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (FRONT != FRONT_NONE) {
    if (nc > 1) load_window(1, tid, THREADS);
    filter_window(0, tid, THREADS);
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  for (int c = 0; c < nc; ++c) {
    if (FRONT == FRONT_NONE) {
      if (c + 1 < nc) load_window(c + 1, tid, THREADS);
    } else if (!stats) {
      // the filter warps, one century ahead; nothing here reads pos
      if (c + 2 < nc) load_window(c + 2, ft, FIR_THREADS);
      if (c + 1 < nc) filter_window(c + 1, ft, FIR_THREADS);
    }
    if (stats) {
      // filt[i]: filtered sample pos + below + i, 0 outside [0, L)
      const int below = off < 0 ? off : 0;
      const int rel = pos + below - (pos0 + window_start(c, sps));
      const float* filt =
          (FRONT == FRONT_NONE ? slots + (c & 1) * k.slot
                               : filts + (c & 1) * k.filt) + rel;
      // Symbol i, column kc is filt[i*sps + kc + (i ? off : 0) - below]:
      // symbol 0 reads the unshifted view, symbols 1..99 the view shifted
      // by the pending slew.
      // timing: a warp per group of columns, rows lane, lane + 25, + 50,
      // + 75 of each
      for (int kc0 = SW - 1 - warp; kc0 < sps; kc0 += COLUMNS_AT_ONCE * SW) {
        float x[COLUMNS_AT_ONCE][4], s[COLUMNS_AT_ONCE];
#pragma unroll
        for (int j = 0; j < COLUMNS_AT_ONCE; ++j) {
          const int kc = kc0 + j * SW;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = lane + 25 * q;
            x[j][q] = (lane < 25 && kc < sps)
                          ? filt[i * sps + kc + (i ? off : 0) - below]
                          : 0.0f;
          }
          s[j] = __fadd_rn(__fadd_rn(x[j][0], x[j][2]),
                           __fadd_rn(x[j][1], x[j][3]));
        }
        fold25(s, lane);
#pragma unroll
        for (int j = 0; j < COLUMNS_AT_ONCE; ++j) {
          const float mean =
              __fdiv_rn(__shfl_sync(FULL, s[j], 0), (float)CENTURY);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float d = __fsub_rn(mean, x[j][q]);
            x[j][q] = __fmul_rn(d, d);
          }
          s[j] = __fadd_rn(__fadd_rn(x[j][0], x[j][2]),
                           __fadd_rn(x[j][1], x[j][3]));
        }
        fold25(s, lane);
#pragma unroll
        for (int j = 0; j < COLUMNS_AT_ONCE; ++j) {
          const int kc = kc0 + j * SW;
          if (lane == 0 && kc < sps)
            colv[(c & 1) * sps + kc] = __fdiv_rn(s[j], (float)CENTURY);
        }
      }
      // volume and mid-third means: a thread per symbol
      for (int i = tid; i < CENTURY; i += 32 * SW) {
        const float* sym = filt + i * sps + (i ? off : 0) - below;
        float vol, mid;
        if (sps == 10 && lo == Mid<10>::LO && hi == Mid<10>::HI) {
          row_sums<10>(sym, vol, mid);
        } else if (sps == 20 && lo == Mid<20>::LO && hi == Mid<20>::HI) {
          row_sums<20>(sym, vol, mid);
        } else if (sps == 40 && lo == Mid<40>::LO && hi == Mid<40>::HI) {
          row_sums<40>(sym, vol, mid);
        } else {
          vol = fold_row(sym, sps, scr + i);
          mid = fold_row(sym + lo, m, scr + i);
        }
        vols[(c + 1) * CENTURY + i] = __fdiv_rn(vol, (float)sps);
        mids[c * CENTURY + i] = __fdiv_rn(mid, (float)m);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    if (stats) {
      // the first minimum of the column variances (lowest index on ties),
      // in every statistics warp alike, by two warp reductions over
      // columns lane, lane + 32, + 64, + 96 (a variance is a sum of
      // squares: never negative, so its bits order as an unsigned integer
      // does; columns past sps count as infinity)
      const float* cv = colv + (c & 1) * sps;
      const unsigned inf = __float_as_uint(INFINITY);
      unsigned v[COLV_PER_LANE], lo = inf, hi = 0;
#pragma unroll
      for (int q = 0; q < COLV_PER_LANE; ++q) {
        v[q] = lane + 32 * q < sps ? __float_as_uint(cv[lane + 32 * q]) : inf;
        lo = min(lo, v[q]);
        hi = max(hi, v[q]);
      }
      const unsigned least = __reduce_min_sync(FULL, lo);
      int first = MAX_SPS;  // this lane's lowest column holding the minimum
#pragma unroll
      for (int q = COLV_PER_LANE - 1; q >= 0; --q)
        if (v[q] == least) first = lane + 32 * q;
      const int vmin_pos = (int)__reduce_min_sync(FULL, (unsigned)first);
      // a NaN variance (its bits lie above infinity's) makes the minimum
      // NaN, as in the plain version: no slew
      const bool nan = __reduce_max_sync(FULL, hi) > inf;
      const float vmin = nan ? NAN : __uint_as_float(least);
      int new_off = 0;
      if (vmin > 0.0f && vmin <= VMIN_GUARD) {
        if (vmin_pos > 0 && vmin_pos < sps / 2) new_off = 1;
        else if (vmin_pos >= sps / 2 && vmin_pos < sps - 1) new_off = -1;
      }
      pos = pos + n + off;
      off = new_off;
    }
  }

  // AGC and slicer, a warp per century: symbol i's window [i+1, i+101) of
  // [ring | volumes] is the last 99-i volumes of the century before and
  // the first i+1 of its own: a suffix and a prefix scan
  for (int c = warp; c < nc; c += WARPS) {
    float bmn[4], bmx[4], omn[4], omx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float b = lane < 25 ? vols[c * CENTURY + 4 * lane + q] : 0.0f;
      const float o = lane < 25 ? vols[(c + 1) * CENTURY + 4 * lane + q] : 0.0f;
      bmn[q] = lane < 25 ? b : INFINITY;
      bmx[q] = lane < 25 ? b : -INFINITY;
      omn[q] = lane < 25 ? o : INFINITY;
      omx[q] = lane < 25 ? o : -INFINITY;
    }
    scan100<false>(bmn, bmx, lane);  // bmn[q]: the century before, from 4l+q on
    scan100<true>(omn, omx, lane);   // omn[q]: its own, up to 4l+q
    // symbol 4l+q joins the suffix from 4l+q+1 on: the next lane's first
    const float nmn = __shfl_down_sync(FULL, bmn[0], 1);
    const float nmx = __shfl_down_sync(FULL, bmx[0], 1);
    if (lane < 25) {
      uint8_t d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wmin = fminf(omn[q], q < 3 ? bmn[q + 1] : nmn);
        const float wmax = fmaxf(omx[q], q < 3 ? bmx[q + 1] : nmx);
        const float vmax = fmaxf(wmax, FLT_MIN);
        const float center = __fdiv_rn(__fadd_rn(vmax, wmin), 2.0f);
        const float x = mids[c * CENTURY + 4 * lane + q];
        if (MODE == 0) {
          const float umid = __fadd_rn(__fmul_rn(__fsub_rn(vmax, center), 0.625f), center);
          const float lmid = __fadd_rn(__fmul_rn(__fsub_rn(wmin, center), 0.625f), center);
          d[q] = x > center ? (x > umid ? 1 : 0) : (x < lmid ? 3 : 2);
        } else {
          const uint8_t one = MODE == 2 ? 0 : 1;
          d[q] = x > center ? one : (uint8_t)(1 - one);
        }
      }
      // ch * nsym + c * 100 + 4 * lane is a multiple of 4
      *reinterpret_cast<uchar4*>(a.dib + (size_t)ch * nsym + c * CENTURY +
                                 4 * lane) = make_uchar4(d[0], d[1], d[2], d[3]);
    }
  }
  for (int i = tid; i < CENTURY; i += THREADS)
    a.ring_out[(size_t)ch * CENTURY + i] = vols[nc * CENTURY + i];
  if (tid == 0) {
    a.pos_out[ch] = pos;
    a.off_out[ch] = off;
  }
}

typedef void (*Kernel)(const Args);

template <int FRONT>
Kernel kernel_of_mode(int mode) {
  switch (mode) {
    case 0: return demod_kernel<FRONT, 0>;
    case 1: return demod_kernel<FRONT, 1>;
    case 2: return demod_kernel<FRONT, 2>;
    default: return nullptr;
  }
}

Kernel kernel_of(int front, int mode) {
  switch (front) {
    case FRONT_FM_RRC: return kernel_of_mode<FRONT_FM_RRC>(mode);
    case FRONT_RRC: return kernel_of_mode<FRONT_RRC>(mode);
    case FRONT_NONE: return kernel_of_mode<FRONT_NONE>(mode);
    default: return nullptr;
  }
}

// The kernel of (front, mode) with its dynamic shared memory allowed.
cudaError_t prepare(int front, int mode, int ntaps, int sps, int nc,
                    Kernel* fn, size_t* smem) {
  *fn = kernel_of(front, mode);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = carve(front, ntaps, sps, nc).total() * sizeof(float);
  return cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

int launch(int front, const Args& a, int channels, int mode, void* stream) {
  Kernel fn;
  size_t smem;
  const cudaError_t err = prepare(front, mode, a.ntaps, a.sps, a.nc, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<channels, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes, one per front. Each returns the
// launch's cudaError_t (0 on success); a fault during the run shows at the
// next synchronisation.

// K1: raw I/Q planes.
extern "C" int digiham_demod_fm_front(
    const float* re, const float* im, const float* last_re,
    const float* last_im, const float* hist, const float* taps,
    const int* pos_in, const int* off_in, const float* ring_in,
    unsigned char* dib, int* pos_out, int* off_out, float* ring_out,
    float* hist_out, int channels, int L, int ntaps, int sps, int lo, int hi,
    int nc, int mode, float fm_scale, void* stream) {
  const Args a = {re,      im,     last_re, last_im,  hist,     taps, pos_in,
                  off_in,  ring_in, dib,    pos_out,  off_out,  ring_out,
                  hist_out, L,     ntaps,   sps,      lo,       hi,   nc,
                  fm_scale};
  return launch(FRONT_FM_RRC, a, channels, mode, stream);
}

// K2: FM audio (unfiltered samples) and the RRC history.
extern "C" int digiham_demod_front(
    const float* samples, const float* hist, const float* taps,
    const int* pos_in, const int* off_in, const float* ring_in,
    unsigned char* dib, int* pos_out, int* off_out, float* ring_out,
    float* hist_out, int channels, int L, int ntaps, int sps, int lo, int hi,
    int nc, int mode, void* stream) {
  const Args a = {samples, nullptr, nullptr, nullptr, hist,     taps, pos_in,
                  off_in,  ring_in, dib,     pos_out, off_out,  ring_out,
                  hist_out, L,      ntaps,   sps,     lo,       hi,   nc,
                  0.0f};
  return launch(FRONT_RRC, a, channels, mode, stream);
}

// K3: samples that are filtered already.
extern "C" int digiham_demod(
    const float* samples, const int* pos_in, const int* off_in,
    const float* ring_in, unsigned char* dib, int* pos_out, int* off_out,
    float* ring_out, int channels, int L, int sps, int lo, int hi, int nc,
    int mode, void* stream) {
  const Args a = {samples, nullptr, nullptr, nullptr, nullptr,  nullptr, pos_in,
                  off_in,  ring_in, dib,     pos_out, off_out,  ring_out,
                  nullptr, L,       1,       sps,     lo,       hi,      nc,
                  0.0f};
  return launch(FRONT_NONE, a, channels, mode, stream);
}

// Blocks of one front's kernel (front 0 fm_rrc, 1 rrc, 2 none) that the
// runtime keeps resident on one SM at this carve-up, and the device's SM
// count: their product is the channels that run at once.
extern "C" int digiham_demod_occupancy(int front, int mode, int ntaps, int sps,
                                       int nc, int* blocks_per_sm,
                                       int* sm_count) {
  Kernel fn;
  size_t smem;
  cudaError_t err = prepare(front, mode, ntaps, sps, nc, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     device);
}
