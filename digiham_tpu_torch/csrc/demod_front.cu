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
//      atan2(x * conj(x_prev)) / pi * fm_scale; (rrc) a copy of the samples;
//      both behind the carried RRC history, and the new history (the last
//      ntaps-1 values of that row);
//   2. (fm_rrc, rrc) the RRC FIR y[t] = sum_j taps[j] * ext[t + j] over
//      ext = [hist | row];
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
// Bounds on an H100 (3.35 TB/s, 67 TFLOP/s fp32), per sample: K1 moves 8 B
// and does one atan2f plus 81 multiply-adds (256 channels x 16,128 samples:
// ~34 MB, ~10 us of traffic against ~13 us of fp32 arithmetic: operations); K2
// moves 4 B for the same FIR (operations, more so with 161 taps); K3 moves
// 4 B for a handful of adds (bytes). This simple design is far from those
// bounds and leaves on the table:
//   - K1 and K2 run one block per channel holding the whole row twice in
//     shared memory (history + row, filtered row), so one block per SM, a
//     second partial wave at 256 channels, and a block length capped by the
//     227 KB a block may use (filtering per century window would lift it);
//   - the century loop is serial with ~25 block barriers per century and
//     little work between them (latency-bound, most threads idle);
//   - the FIR reads every tap and sample from shared memory with no
//     register tiling, and uses separate multiply and add, not FMA;
//   - the symbol matrix is gathered three times per century (from shared
//     memory in K1 and K2, from global memory through L2 in K3).
// K3 keeps no row in shared memory at all: it has no filtered row to make,
// so its shared memory does not grow with the block length (2FSK rows at
// sps 40 reach 64,000 samples, 256 KB).
// None of the TPU workarounds is carried over: no lane shifter, no 128-lane
// padding, no selection matmuls, no polynomial atan2, no banded-matmul RRC,
// no DMA double buffer, no resident/staged twins.
//
// Contract: pos >= 0 and L >= max(pos) + n_centuries * (100 * sps + 1) + 1.
// Reads of the (filtered) row outside [0, L) give 0.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int CENTURY = 100;
constexpr int THREADS = 256;
constexpr float VMIN_GUARD = 5000000.0f;
// float32(pi), the divisor of the JAX package and of the plain version
constexpr float PI_F = 3.14159265358979323846f;

// In-place pairwise fold of `rows` rows of `width` floats (row-major) to
// their sums in column 0: while w > 1, h = ceil(w/2), x[i] += x[i+h] for
// i < w-h. The same order as fold_sum(x, -1) in dsp/demod.py.
__device__ void fold_rows(float* buf, int rows, int width) {
  for (int w = width; w > 1;) {
    const int h = (w + 1) >> 1, pairs = w - h;
    for (int e = threadIdx.x; e < rows * pairs; e += THREADS) {
      const int r = e / pairs, i = e - r * pairs;
      buf[r * width + i] = __fadd_rn(buf[r * width + i], buf[r * width + i + h]);
    }
    __syncthreads();
    w = h;
  }
}

// Fold a [CENTURY][width] row-major matrix along its rows, leaving the
// column sums in row 0: fold_sum(x, -2).
__device__ void fold_columns(float* buf, int width) {
  for (int r = CENTURY; r > 1;) {
    const int h = (r + 1) >> 1, pairs = r - h;
    for (int e = threadIdx.x; e < pairs * width; e += THREADS) {
      buf[e] = __fadd_rn(buf[e], buf[e + h * width]);
    }
    __syncthreads();
    r = h;
  }
}

// Century symbol matrix element e = i*sps + k (symbol i, column k): symbol
// 0 reads the unshifted view, symbols 1..99 the view shifted by the
// pending slew; outside [0, L) reads 0.
__device__ __forceinline__ float sym_at(const float* filt, int L, int pos,
                                        int off, int sps, int e) {
  const int idx = pos + e + (e >= sps ? off : 0);
  return (idx >= 0 && idx < L) ? filt[idx] : 0.0f;
}

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

// Dynamic shared memory of one block, in floats; the carve-up at the top of
// the kernel and smem_bytes() in ops/demod_front.py follow it.
__host__ __device__ inline size_t smem_floats(int front, int L, int ntaps,
                                              int sps, int lo, int hi, int nc) {
  size_t f = (size_t)CENTURY * sps + (size_t)CENTURY * (hi - lo) +
             (size_t)(nc + 1) * CENTURY + (size_t)nc * CENTURY + sps;
  if (front != FRONT_NONE) f += (size_t)(ntaps - 1 + L) + L + ntaps;
  return f;
}

// MODE 0: gfsk 4-level; 1: fsk; 2: fsk inverted
template <int FRONT, int MODE>
__global__ void __launch_bounds__(THREADS) demod_kernel(const Args a) {
  extern __shared__ float smem[];
  __shared__ int s_pos, s_off;
  const int L = a.L, ntaps = a.ntaps, sps = a.sps, lo = a.lo, hi = a.hi;
  const int nc = a.nc;
  const int halo = ntaps - 1;
  const int n = CENTURY * sps;
  const int m = hi - lo;
  const int nsym = nc * CENTURY;
  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  // carve-up; keep in step with smem_floats()
  float* p = smem;
  float* ext = nullptr;    // [halo + L] RRC history, then the row
  float* filt_s = nullptr; // [L] filtered row
  float* tap_s = nullptr;  // [ntaps]
  if (FRONT != FRONT_NONE) {
    ext = p;
    filt_s = ext + halo + L;
    tap_s = filt_s + L;
    p = tap_s + ntaps;
  }
  float* mat = p;                          // [100 * sps] century scratch
  float* mid = mat + n;                    // [100 * m] mid-third scratch
  float* vols = mid + CENTURY * m;         // [(nc + 1) * 100] ring, volumes
  float* mids = vols + (nc + 1) * CENTURY; // [nsym] mid-third means
  float* colm = mids + nsym;               // [sps] column means
  // the row the century loop reads: K3 reads its input where it lies
  const float* filt =
      FRONT == FRONT_NONE ? a.in0 + (size_t)ch * L : filt_s;

  // phase 1: ring, then history, taps and the row behind the history
  for (int t = tid; t < CENTURY; t += THREADS)
    vols[t] = a.ring_in[(size_t)ch * CENTURY + t];
  if (FRONT != FRONT_NONE) {
    for (int t = tid; t < halo; t += THREADS)
      ext[t] = a.hist[(size_t)ch * halo + t];
    for (int t = tid; t < ntaps; t += THREADS) tap_s[t] = a.taps[t];
  }
  if (FRONT == FRONT_FM_RRC) {
    const float* rre = a.in0 + (size_t)ch * L;
    const float* rim = a.in1 + (size_t)ch * L;
    for (int t = tid; t < L; t += THREADS) {
      const float xr = rre[t], xi = rim[t];
      const float yr = t ? rre[t - 1] : a.last_re[ch];  // previous sample
      const float yi = t ? rim[t - 1] : a.last_im[ch];
      const float prod_re = __fadd_rn(__fmul_rn(xr, yr), __fmul_rn(xi, yi));
      const float prod_im = __fsub_rn(__fmul_rn(xi, yr), __fmul_rn(xr, yi));
      const float v =
          __fmul_rn(__fdiv_rn(atan2f(prod_im, prod_re), PI_F), a.fm_scale);
      ext[halo + t] = v;
      if (t >= L - halo) a.hist_out[(size_t)ch * halo + t - (L - halo)] = v;
    }
  } else if (FRONT == FRONT_RRC) {
    // the new history is the raw input tail (L > ntaps, so it lies in the row)
    const float* row = a.in0 + (size_t)ch * L;
    for (int t = tid; t < L; t += THREADS) {
      const float v = row[t];
      ext[halo + t] = v;
      if (t >= L - halo) a.hist_out[(size_t)ch * halo + t - (L - halo)] = v;
    }
  }
  if (tid == 0) {
    s_pos = a.pos_in[ch];
    s_off = a.off_in[ch];
  }
  __syncthreads();

  // phase 2: the RRC, tap by tap in order, each product and sum rounded
  if (FRONT != FRONT_NONE) {
    for (int t = tid; t < L; t += THREADS) {
      float acc = __fmul_rn(tap_s[0], ext[t]);
      for (int j = 1; j < ntaps; ++j)
        acc = __fadd_rn(acc, __fmul_rn(tap_s[j], ext[t + j]));
      filt_s[t] = acc;
    }
    __syncthreads();
  }

  // phase 3: the serial century loop
  for (int c = 0; c < nc; ++c) {
    const int pos = s_pos, off = s_off;
    for (int e = tid; e < n; e += THREADS) {
      const float v = sym_at(filt, L, pos, off, sps, e);
      mat[e] = v;
      const int i = e / sps, k = e - i * sps;
      if (k >= lo && k < hi) mid[i * m + k - lo] = v;
    }
    __syncthreads();
    fold_rows(mat, CENTURY, sps);
    fold_rows(mid, CENTURY, m);
    for (int i = tid; i < CENTURY; i += THREADS) {
      vols[(c + 1) * CENTURY + i] = __fdiv_rn(mat[i * sps], (float)sps);
      mids[c * CENTURY + i] = __fdiv_rn(mid[i * m], (float)m);
    }
    __syncthreads();

    // timing: per-column mean, then per-column variance
    for (int e = tid; e < n; e += THREADS) mat[e] = sym_at(filt, L, pos, off, sps, e);
    __syncthreads();
    fold_columns(mat, sps);
    for (int k = tid; k < sps; k += THREADS)
      colm[k] = __fdiv_rn(mat[k], (float)CENTURY);
    __syncthreads();
    for (int e = tid; e < n; e += THREADS) {
      const float d = __fsub_rn(colm[e % sps], sym_at(filt, L, pos, off, sps, e));
      mat[e] = __fmul_rn(d, d);
    }
    __syncthreads();
    fold_columns(mat, sps);
    if (tid == 0) {
      // first minimum wins (strict <)
      float vmin = __fdiv_rn(mat[0], (float)CENTURY);
      int vmin_pos = 0;
      for (int k = 1; k < sps; ++k) {
        const float v = __fdiv_rn(mat[k], (float)CENTURY);
        if (v < vmin) {
          vmin = v;
          vmin_pos = k;
        }
      }
      int new_off = 0;
      if (vmin > 0.0f && vmin <= VMIN_GUARD) {
        if (vmin_pos > 0 && vmin_pos < sps / 2) new_off = 1;
        else if (vmin_pos >= sps / 2 && vmin_pos < sps - 1) new_off = -1;
      }
      s_pos = pos + n + off;
      s_off = new_off;
    }
    __syncthreads();
  }

  // phase 4: AGC over the windows [t+1, t+101) of [ring | volumes], slicer
  for (int t = tid; t < nsym; t += THREADS) {
    float wmin = vols[t + 1], wmax = vols[t + 1];
    for (int u = t + 2; u < t + 1 + CENTURY; ++u) {
      wmin = fminf(wmin, vols[u]);
      wmax = fmaxf(wmax, vols[u]);
    }
    const float vmax = fmaxf(wmax, FLT_MIN);
    const float center = __fdiv_rn(__fadd_rn(vmax, wmin), 2.0f);
    const float x = mids[t];
    uint8_t d;
    if (MODE == 0) {
      const float umid = __fadd_rn(__fmul_rn(__fsub_rn(vmax, center), 0.625f), center);
      const float lmid = __fadd_rn(__fmul_rn(__fsub_rn(wmin, center), 0.625f), center);
      d = x > center ? (x > umid ? 1 : 0) : (x < lmid ? 3 : 2);
    } else {
      const uint8_t one = MODE == 2 ? 0 : 1;
      d = x > center ? one : (uint8_t)(1 - one);
    }
    a.dib[(size_t)ch * nsym + t] = d;
  }
  for (int i = tid; i < CENTURY; i += THREADS)
    a.ring_out[(size_t)ch * CENTURY + i] = vols[nc * CENTURY + i];
  if (tid == 0) {
    a.pos_out[ch] = s_pos;
    a.off_out[ch] = s_off;
  }
}

template <int FRONT, int MODE>
cudaError_t launch(const Args& a, int channels, cudaStream_t stream) {
  const size_t smem =
      smem_floats(FRONT, a.L, a.ntaps, a.sps, a.lo, a.hi, a.nc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      demod_kernel<FRONT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  demod_kernel<FRONT, MODE><<<channels, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int FRONT>
int dispatch(const Args& a, int channels, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch<FRONT, 0>(a, channels, s);
    case 1: return (int)launch<FRONT, 1>(a, channels, s);
    case 2: return (int)launch<FRONT, 2>(a, channels, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  return dispatch<FRONT_FM_RRC>(a, channels, mode, stream);
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
  return dispatch<FRONT_RRC>(a, channels, mode, stream);
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
  return dispatch<FRONT_NONE>(a, channels, mode, stream);
}
