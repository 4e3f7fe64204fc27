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
// (demod_front.cu): all three run fir_span of fir_span.cuh, so K4's filtered
// row equals what K2 consumes.
//
// What bounds it on an H100: 256 channels x 16,128 samples x 81 taps read
// 16.6 MB and write 16.5 MB (about 10 us at 3.35 TB/s) and do 0.67 GFLOP,
// about 10 us at 67 TFLOP/s: bytes and operations nearly tie. The card's
// float32 rate counts a fused multiply-add as two operations in one
// instruction; this rounding order forbids fusing, so every tap costs a
// multiply and an add instruction and half the operations bound is the
// design's ceiling.
//
// Design: grid (channel, time tile of TILE = 1,792 outputs), so channels
// ride gridDim.x (no 65,535 limit) and a 64,000-sample row is 36 tiles; a
// block is 256 threads and takes 15 KB of shared memory, so several blocks
// share an SM and one block's staging overlaps another's arithmetic.
//   - Staging. The tile's TILE + ntaps-1 inputs go to shared memory in
//     16-byte cp.async copies wherever source and destination are both
//     16-byte aligned, which the block arranges by shifting its window by
//     the 0-3 words its first sample lies past a 16-byte boundary: any row
//     stride, any ntaps and a view into a wider array keep the wide copies.
//     The 4-byte path takes the carried history (another pointer, another
//     alignment) and the ragged first and last words.
//   - Arithmetic. Each thread takes FIR_OUTPUTS = 7 consecutive outputs
//     through fir_span: per 8 taps 8 input loads (lane stride 7 is odd: no
//     bank conflicts) and two 16-byte broadcast loads of taps for 112
//     multiplies and adds, where one load per multiply-add pair was the
//     limit before.
//   - Stores. A warp's 224 outputs go through its own slice of shared memory
//     (one __syncwarp) and leave as seven stores with neighbouring lanes on
//     neighbouring addresses.
// The row is given as two pointers, history [C, ntaps-1] and samples [C, T],
// each with its own row stride, so the caller never has to concatenate them
// in device memory; fir_cmajor's single [C, T + ntaps-1] array is the same
// call with both pointers into it. Tensor cores are not used: a TF32
// product is another rounding order.
// None of the TPU workarounds is carried over: no 128-lane padding, no
// 512-lane chunks, no lane rolls, no channel-tile search.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_span.cuh"

namespace {

constexpr int THREADS = 256;
// per thread, consecutive; odd: no bank conflicts
constexpr int FIR_OUTPUTS = 7;
constexpr int TILE = THREADS * FIR_OUTPUTS;  // outputs per block
constexpr int WARP_SPAN = 32 * FIR_OUTPUTS;  // outputs per warp
constexpr int MIN_BLOCKS = 4;   // per SM: staging overlaps arithmetic

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of one block, in floats: the staged taps, the
// window (shifted by up to 3 words) and the outputs on their way out.
// smem_bytes() in ops/fir.py is the same arithmetic.
__host__ __device__ inline int window_floats(int ntaps) {
  return round4(TILE + ntaps - 1 + 3);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fir_kernel(const float* __restrict__ hist, long long hist_stride,
           const float* __restrict__ samples, long long samples_stride,
           const float* __restrict__ taps, float* __restrict__ y,
           int T, int ntaps) {
  extern __shared__ __align__(16) float smem[];
  const int halo = ntaps - 1;
  float* tap_s = smem;                          // tap j at [j + 3]
  float* win_base = tap_s + fir_tap_floats(ntaps);
  float* out_s = win_base + window_floats(ntaps);  // [TILE]
  const int c = blockIdx.x;
  const int t0 = blockIdx.y * TILE;
  const int n_out = min(TILE, T - t0);
  const int n_in = n_out + halo;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // x[i] of this tile is [history | samples] element t0 + i: history below
  // i0, sample t0 + i - halo from there on
  const float* h = hist + (size_t)c * hist_stride + t0;
  const int i0 = max(0, halo - t0);
  const uintptr_t src_addr = (uintptr_t)(samples + (size_t)c * samples_stride) +
                             sizeof(float) * ((long long)t0 - halo);
  const float* src = reinterpret_cast<const float*>(src_addr);
  // &win[i] is 16-byte aligned exactly where &src[i] is
  const int shift = (int)(src_addr >> 2) & 3;
  float* win = win_base + shift;
  for (int q = tid; 4 * q < shift + n_in; q += THREADS) {
    const int i = 4 * q - shift;
    if (i >= i0 && i + 4 <= n_in) {
      __pipeline_memcpy_async(win + i, src + i, 16);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ii = i + k;
        if (ii >= 0 && ii < n_in) win[ii] = ii < i0 ? h[ii] : src[ii];
      }
    }
  }
  __pipeline_commit();
  for (int j = tid; j < ntaps; j += THREADS) tap_s[j + 3] = taps[j];
  __pipeline_wait_prior(0);
  __syncthreads();

  // a thread's outputs into its warp's slice of out_s; spans that start
  // past the tile's end have nothing to compute, a span that straddles it
  // reads staged or stale words and its surplus is never stored
  const int first = tid * FIR_OUTPUTS;
  if (first < n_out) {
    float acc[FIR_OUTPUTS];
    fir_span<FIR_OUTPUTS>(win + first, tap_s, ntaps, acc);
#pragma unroll
    for (int r = 0; r < FIR_OUTPUTS; ++r) out_s[first + r] = acc[r];
  }
  __syncwarp();
  float* out = y + (size_t)c * T + t0;
#pragma unroll
  for (int k = 0; k < FIR_OUTPUTS; ++k) {
    const int t = warp * WARP_SPAN + k * 32 + lane;
    if (t < n_out) out[t] = out_s[t];
  }
}

size_t smem_of(int ntaps) {
  return sizeof(float) *
         (size_t)(fir_tap_floats(ntaps) + window_floats(ntaps) + TILE);
}

}  // namespace

// hist: [C, ntaps-1] with row stride hist_stride (floats); samples: [C, T]
// with row stride samples_stride; taps: [ntaps]; y: [C, T] contiguous. The
// pointers need float alignment only. Requires C >= 1, T >= 1, ntaps >= 1.
// Returns the launch's cudaError_t.
extern "C" int digiham_fir(const float* hist, long long hist_stride,
                           const float* samples, long long samples_stride,
                           const float* taps, float* y, int C, int T,
                           int ntaps, void* stream) {
  const size_t smem = smem_of(ntaps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(C, (T + TILE - 1) / TILE);
  fir_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      hist, hist_stride, samples, samples_stride, taps, y, T, ntaps);
  return (int)cudaGetLastError();
}

// Blocks of fir_kernel the runtime keeps resident on one SM at this tap
// count, and the card's SM count: *blocks_per_sm, *sms. Returns a
// cudaError_t.
extern "C" int digiham_fir_occupancy(int ntaps, int* blocks_per_sm, int* sms) {
  const size_t smem = smem_of(ntaps);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                        fir_kernel, THREADS,
                                                        smem);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}
