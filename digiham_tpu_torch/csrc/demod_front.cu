// K1: the fused raw-IQ DMR front for Hopper (sm_90a).
//
// Replaces digiham_tpu/ops/demod_pallas.py::pallas_demod_fm_front_block
// (Pallas body _make_kernel(front="fm_rrc")). Per channel it computes
//   1. the FM quadrature discriminator atan2(x * conj(x_prev)) / pi * fm_scale,
//   2. the RRC FIR y[t] = sum_j taps[j] * ext[t + j] over ext = [hist | audio],
//   3. the serial century loop: per 100 symbols the volume and mid-third
//      means, the per-column timing variance and the +-1 slew decision,
//   4. the 100-wide sliding min/max AGC and the 4- or 2-level slicer.
// Semantics: digiham_tpu/dsp/demod.py (_century) and dsp/fm.py; the op
// order is that of the plain version in digiham_tpu_torch/ops/demod_front.py
// (FM step, tap-by-tap FIR, pairwise fold sums), every rounding explicit
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn never contract into FMA),
// so kernel and plain version agree bit for bit.
//
// Bound on an H100: the essential traffic is the 8 B of I/Q per sample
// (256 channels x 16,128 samples: about 33 MB per step, ~10 us at
// 3.35 TB/s); compute is one atan2f plus 81 multiply-adds per sample
// (~0.7 GFLOP per step, ~10 us of fp32 issue). This simple design is far
// from that bound and leaves on the table:
//   - one block per channel holding ~150 KB of shared memory, so one block
//     per SM and a second, partial wave at 256 channels;
//   - the century loop is serial with ~25 block barriers per century and
//     little work between them (latency-bound, most threads idle);
//   - the FIR reads every tap and sample from shared memory with no
//     register tiling, and uses separate multiply and add, not FMA;
//   - the symbol matrix is gathered from shared memory three times per
//     century.
// None of the TPU workarounds is carried over: no lane shifter, no 128-lane
// padding, no selection matmuls, no polynomial atan2, no banded-matmul RRC,
// no DMA double buffer.
//
// Contract: pos >= 0 and L >= max(pos) + n_centuries * (100 * sps + 1) + 1.
// Reads of the filtered row outside [0, L) give 0.

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

template <int MODE>  // 0: gfsk 4-level; 1: fsk; 2: fsk inverted
__global__ void __launch_bounds__(THREADS)
demod_fm_front_kernel(const float* __restrict__ re, const float* __restrict__ im,
                      const float* __restrict__ last_re,
                      const float* __restrict__ last_im,
                      const float* __restrict__ hist,
                      const float* __restrict__ taps,
                      const int* __restrict__ pos_in,
                      const int* __restrict__ off_in,
                      const float* __restrict__ ring_in,
                      uint8_t* __restrict__ dib, int* __restrict__ pos_out,
                      int* __restrict__ off_out, float* __restrict__ ring_out,
                      float* __restrict__ hist_out, int L, int ntaps, int sps,
                      int lo, int hi, int nc, float fm_scale) {
  extern __shared__ float smem[];
  __shared__ int s_pos, s_off;
  const int halo = ntaps - 1;
  const int n = CENTURY * sps;
  const int m = hi - lo;
  const int nsym = nc * CENTURY;
  // carve-up; keep in step with smem_bytes() in ops/demod_front.py
  float* ext = smem;                       // [halo + L] RRC history, then audio
  float* filt = ext + halo + L;            // [L] filtered row
  float* tap_s = filt + L;                 // [ntaps]
  float* mat = tap_s + ntaps;              // [100 * sps] century scratch
  float* mid = mat + n;                    // [100 * m] mid-third scratch
  float* vols = mid + CENTURY * m;         // [(nc + 1) * 100] ring, volumes
  float* mids = vols + (nc + 1) * CENTURY; // [nsym] mid-third means
  float* colm = mids + nsym;               // [sps] column means

  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const float* rre = re + (size_t)ch * L;
  const float* rim = im + (size_t)ch * L;

  // phase 1: history, taps, ring, then the FM discriminator of the row
  for (int t = tid; t < halo; t += THREADS) ext[t] = hist[(size_t)ch * halo + t];
  for (int t = tid; t < ntaps; t += THREADS) tap_s[t] = taps[t];
  for (int t = tid; t < CENTURY; t += THREADS)
    vols[t] = ring_in[(size_t)ch * CENTURY + t];
  for (int t = tid; t < L; t += THREADS) {
    const float xr = rre[t], xi = rim[t];
    const float pr = t ? rre[t - 1] : last_re[ch];
    const float pi = t ? rim[t - 1] : last_im[ch];
    const float prod_re = __fadd_rn(__fmul_rn(xr, pr), __fmul_rn(xi, pi));
    const float prod_im = __fsub_rn(__fmul_rn(xi, pr), __fmul_rn(xr, pi));
    const float a = __fmul_rn(__fdiv_rn(atan2f(prod_im, prod_re), PI_F), fm_scale);
    ext[halo + t] = a;
    if (t >= L - halo) hist_out[(size_t)ch * halo + t - (L - halo)] = a;
  }
  if (tid == 0) {
    s_pos = pos_in[ch];
    s_off = off_in[ch];
  }
  __syncthreads();

  // phase 2: the RRC, tap by tap in order, each product and sum rounded
  for (int t = tid; t < L; t += THREADS) {
    float acc = __fmul_rn(tap_s[0], ext[t]);
    for (int j = 1; j < ntaps; ++j)
      acc = __fadd_rn(acc, __fmul_rn(tap_s[j], ext[t + j]));
    filt[t] = acc;
  }
  __syncthreads();

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
    dib[(size_t)ch * nsym + t] = d;
  }
  for (int i = tid; i < CENTURY; i += THREADS)
    ring_out[(size_t)ch * CENTURY + i] = vols[nc * CENTURY + i];
  if (tid == 0) {
    pos_out[ch] = s_pos;
    off_out[ch] = s_off;
  }
}

template <int MODE>
cudaError_t launch(const float* re, const float* im, const float* last_re,
                   const float* last_im, const float* hist, const float* taps,
                   const int* pos_in, const int* off_in, const float* ring_in,
                   uint8_t* dib, int* pos_out, int* off_out, float* ring_out,
                   float* hist_out, int channels, int L, int ntaps, int sps,
                   int lo, int hi, int nc, float fm_scale, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      demod_fm_front_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  demod_fm_front_kernel<MODE><<<channels, THREADS, smem, stream>>>(
      re, im, last_re, last_im, hist, taps, pos_in, off_in, ring_in, dib,
      pos_out, off_out, ring_out, hist_out, L, ntaps, sps, lo, hi, nc,
      fm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t (0 on
// success); a fault during the run shows at the next synchronisation.
extern "C" int digiham_demod_fm_front(
    const float* re, const float* im, const float* last_re,
    const float* last_im, const float* hist, const float* taps,
    const int* pos_in, const int* off_in, const float* ring_in,
    unsigned char* dib, int* pos_out, int* off_out, float* ring_out,
    float* hist_out, int channels, int L, int ntaps, int sps, int lo, int hi,
    int nc, int mode, float fm_scale, void* stream) {
  const size_t floats = (size_t)(ntaps - 1 + L) + L + ntaps + CENTURY * sps +
                        CENTURY * (hi - lo) + (size_t)(nc + 1) * CENTURY +
                        (size_t)nc * CENTURY + sps;
  const size_t smem = floats * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return (int)launch<0>(re, im, last_re, last_im, hist, taps, pos_in, off_in,
                            ring_in, dib, pos_out, off_out, ring_out, hist_out,
                            channels, L, ntaps, sps, lo, hi, nc, fm_scale, smem, s);
    case 1:
      return (int)launch<1>(re, im, last_re, last_im, hist, taps, pos_in, off_in,
                            ring_in, dib, pos_out, off_out, ring_out, hist_out,
                            channels, L, ntaps, sps, lo, hi, nc, fm_scale, smem, s);
    case 2:
      return (int)launch<2>(re, im, last_re, last_im, hist, taps, pos_in, off_in,
                            ring_in, dib, pos_out, off_out, ring_out, hist_out,
                            channels, L, ntaps, sps, lo, hi, nc, fm_scale, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
