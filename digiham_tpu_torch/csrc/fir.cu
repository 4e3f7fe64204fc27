// K4: the many-channel FIR (the standalone RRC filter) for Hopper (sm_90a).
//
// Replaces digiham_tpu/ops/fir.py::pallas_fir_cmajor (entered through
// rrc_filter_block_pallas). Semantics: for every channel c and output t,
//   y[c, t] = sum_j taps[j] * x[c, t + j],  x = [history | samples],
// a cross-correlation with the taps unreversed: the newest sample meets
// taps[ntaps-1]. ntaps is a run-time argument (81 and 161 for the stock
// designs, anything for a custom one). The plain version is fir_cmajor_plain
// in digiham_tpu_torch/ops/fir.py.
//
// One rounding order, bit for bit: acc = taps[0] * x[t], then
// acc = acc + taps[j] * x[t + j] for j = 1 .. ntaps-1, every product and
// every sum rounded to float32 on its own (__fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA). That is the plain version's order,
// the Pallas kernel's, and the order of the FIR inside K1/K2
// (demod_front.cu), so K4's filtered row equals what K2 consumes.
//
// Design: grid (channel, time tile), so channels ride gridDim.x (no 65,535
// limit) and a 64,000-sample row is 63 tiles. A block of 256 threads stages
// the tile's TILE + ntaps-1 inputs and the taps in shared memory, then each
// thread produces OUT outputs THREADS apart (neighbouring threads read
// neighbouring shared words: no bank conflicts; stores coalesce), loading
// each tap once for its OUT outputs. The row is given as two pointers,
// history [C, ntaps-1] and samples [C, T], each with its own row stride, so
// the caller never has to concatenate them in device memory; fir_cmajor's
// single [C, T + ntaps-1] array is the same call with both pointers into it.
//
// Bound on an H100: 256 channels x 16,128 samples x 81 taps read 16.6 MB and
// write 16.5 MB (about 10 us at 3.35 TB/s) and do 0.67 GFLOP, which as
// separate multiplies and adds is also about 10 us at 67 TFLOP/s: bytes and
// operations nearly tie. What this simple design leaves on the table: one
// shared-memory load per multiply-add pair (5 loads per 8 operations), so
// the shared-memory pipe and not the FP32 pipe sets its time; a register
// window sliding over consecutive outputs, or the tensor cores on a banded
// tap matrix (with the rounding order given up), would come closer.
// None of the TPU workarounds is carried over: no 128-lane padding, no
// 512-lane chunks, no lane rolls, no channel-tile search.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OUT = 4;              // outputs per thread
constexpr int TILE = THREADS * OUT; // outputs per block

__global__ void __launch_bounds__(THREADS)
fir_kernel(const float* __restrict__ hist, long long hist_stride,
           const float* __restrict__ samples, long long samples_stride,
           const float* __restrict__ taps, float* __restrict__ y,
           int T, int ntaps) {
  extern __shared__ float smem[];
  const int halo = ntaps - 1;
  float* win = smem;                 // [TILE + halo] inputs of this tile
  float* tap_s = smem + TILE + halo; // [ntaps]
  const int c = blockIdx.x;
  const int t0 = blockIdx.y * TILE;
  const int n_out = min(TILE, T - t0);
  const int tid = threadIdx.x;

  const float* h = hist + (size_t)c * hist_stride;
  const float* s = samples + (size_t)c * samples_stride;
  // x[i] over [history | samples]: i < halo is history, else samples
  for (int i = tid; i < n_out + halo; i += THREADS) {
    const int g = t0 + i;
    win[i] = g < halo ? h[g] : s[g - halo];
  }
  for (int j = tid; j < ntaps; j += THREADS) tap_s[j] = taps[j];
  __syncthreads();

  float acc[OUT];
  const float tap0 = tap_s[0];
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    const int t = tid + k * THREADS;
    acc[k] = t < n_out ? __fmul_rn(tap0, win[t]) : 0.0f;
  }
  for (int j = 1; j < ntaps; ++j) {
    const float tap = tap_s[j];
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
      const int t = tid + k * THREADS;
      if (t < n_out) acc[k] = __fadd_rn(acc[k], __fmul_rn(tap, win[t + j]));
    }
  }
  float* out = y + (size_t)c * T + t0;
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    const int t = tid + k * THREADS;
    if (t < n_out) out[t] = acc[k];
  }
}

}  // namespace

// hist: [C, ntaps-1] with row stride hist_stride (floats); samples: [C, T]
// with row stride samples_stride; taps: [ntaps]; y: [C, T] contiguous.
// Requires C >= 1, T >= 1, ntaps >= 1. Returns the launch's cudaError_t.
extern "C" int digiham_fir(const float* hist, long long hist_stride,
                           const float* samples, long long samples_stride,
                           const float* taps, float* y, int C, int T,
                           int ntaps, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(TILE + 2 * ntaps - 1);
  cudaError_t err = cudaFuncSetAttribute(
      fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C, (T + TILE - 1) / TILE);
  fir_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      hist, hist_stride, samples, samples_stride, taps, y, T, ntaps);
  return (int)cudaGetLastError();
}
