// K6's earlier design, kept only to be timed beside the split design of
// recurrence.cu (digiham_tpu_torch/ops/variants.py builds it, and
// chip_smoke.py times it); no entry point of the package launches it.
// It takes int16 PCM only.
//
// Two entries in one source, each with its plain version in
// digiham_tpu_torch/ops/recurrence.py:
//   digiham_digitalvoice_iir replaces digiham_tpu/dsp/audio.py::
//     digitalvoice_filter (:62), the order-10 IIR bandpass on s16 PCM
//     (digitalvoice_iir_plain);
//   digiham_dc_block replaces digiham_tpu/dsp/fm.py::dc_block (:56), the
//     first-order DC blocker y[n] = (x[n] - x[n-1]) + alpha * y[n-1]
//     (dc_block_plain).
// The JAX package runs both as XLA scans (lax.scan, lax.associative_scan):
// neither has a Pallas counterpart. Written as tensor ops, the card would
// take about ten launches per sample; here one launch takes a whole block.
//
// One rounding order, bit for bit with the plain versions, every product,
// quotient and sum rounded to float32 on its own (__fmul_rn, __fdiv_rn,
// __fadd_rn, __fsub_rn: never contracted into an FMA):
//   IIR: xin = (x / scale) / gain; f = fw[0]*x[0] + fw[1]*x[1] + ... +
//        fw[10]*xin, summed left to right (x oldest first); b = fb[0]*y[0]
//        + ... + fb[9]*y[9], left to right (y oldest first); y = f + b; the
//        output is y * scale clamped to [-32768, 32767] and truncated
//        toward zero, as XLA's float -> int16 conversion saturates (a plain
//        cast would wrap).
//   DC blocker: y = (x - x1) + (alpha * y1), with (x1, y1) carried.
//
// What bounds it on an H100: not bytes (256 channels x 32,000 samples of
// s16 in and out are 33 MB, 10 us at 3.35 TB/s) but the chain each sample
// waits on: the newest output enters the next sample's feedback sum as its
// last term, so one sample costs a dependent multiply and two dependent
// adds (the DC blocker: a multiply and an add), T times in a row.
//
// Design: one thread per channel, 32 channels a block (one warp), every
// block independent. The delay lines x[10] and y[10] live in registers as
// rotating windows: the time loop is unrolled by ten, so step s of a turn
// finds the oldest value at index s and overwrites it with the newest, and
// no value moves (the last ragged samples shift the window instead). Input
// and output pass through a tile of 32 channels x TILE samples in shared
// memory: the warp stages a row at a time with neighbouring lanes on
// neighbouring samples (coalesced; eight loads a lane in flight), then each
// lane walks its own row (the pitch is odd, so the 32 rows start in 32
// banks), then the warp writes the tile back as it read it. Staging is not
// overlapped with the recurrence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;         // channels of a block, one a thread
constexpr int ORDER = 10;         // delay line of the IIR
constexpr int TILE = 16 * ORDER;  // samples a turn stages; a multiple of ORDER
constexpr int PITCH = TILE + 1;   // words a staged row
constexpr int STAGE = 8;          // loads a lane has in flight when staging

struct Iir {
  float fw[ORDER + 1];  // forward taps, oldest input first
  float fb[ORDER];      // feedback taps, oldest output first
  float scale;          // SHRT_MAX
  float gain;           // GAIN
};

// Rows [c0, c0 + rows) x samples [t0, t0 + n) of a [C, T] array (unit
// stride along time) into the tile, as floats. A lane takes STAGE elements
// a turn, all loads issued before any store, so the turn waits on memory
// once and not STAGE times.
template <typename In>
__device__ inline void stage_in(float* tile, const In* __restrict__ src,
                                long long stride, int c0, int rows,
                                long long t0, int n) {
  for (int base = 0; base < rows * TILE; base += STAGE * LANES) {
    float v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * LANES + threadIdx.x;
      const int r = i / TILE, t = i - r * TILE;
      v[u] = (r < rows && t < n)
                 ? static_cast<float>(src[(c0 + r) * stride + t0 + t])
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = base + u * LANES + threadIdx.x;
      if (i < rows * TILE) tile[(i / TILE) * PITCH + i % TILE] = v[u];
    }
  }
}

// The tile back to rows [c0, c0 + rows) of a contiguous [C, T] output.
template <typename Out>
__device__ inline void stage_out(const float* tile, Out* __restrict__ dst,
                                 long long T, int c0, int rows, long long t0,
                                 int n) {
  for (int i = threadIdx.x; i < rows * TILE; i += LANES) {
    const int r = i / TILE, t = i - r * TILE;
    if (t < n) {
      const float v = tile[r * PITCH + t];
      if constexpr (sizeof(Out) == 2) {
        dst[(c0 + r) * T + t0 + t] = static_cast<Out>(__float2int_rz(v));
      } else {
        dst[(c0 + r) * T + t0 + t] = v;
      }
    }
  }
}

// The scaled input of one PCM sample.
__device__ __forceinline__ float iir_input(float v, const Iir& k) {
  return __fdiv_rn(__fdiv_rn(v, k.scale), k.gain);
}

// One IIR output from windows whose oldest values sit at index s (known at
// compile time once the caller's loop is unrolled) and the newest input.
__device__ __forceinline__ float iir_output(const float (&x)[ORDER],
                                            const float (&y)[ORDER],
                                            const Iir& k, int s, float xin) {
  float f = __fmul_rn(k.fw[0], x[s % ORDER]);
#pragma unroll
  for (int j = 1; j < ORDER; ++j) {
    f = __fadd_rn(f, __fmul_rn(k.fw[j], x[(s + j) % ORDER]));
  }
  f = __fadd_rn(f, __fmul_rn(k.fw[ORDER], xin));
  float b = __fmul_rn(k.fb[0], y[s % ORDER]);
#pragma unroll
  for (int j = 1; j < ORDER; ++j) {
    b = __fadd_rn(b, __fmul_rn(k.fb[j], y[(s + j) % ORDER]));
  }
  return __fadd_rn(f, b);
}

// y * scale, clamped to the int16 range and truncated toward zero.
__device__ __forceinline__ float to_s16(float y, float scale) {
  return truncf(fminf(fmaxf(__fmul_rn(y, scale), -32768.0f), 32767.0f));
}

__global__ void __launch_bounds__(LANES)
digitalvoice_kernel(const int16_t* __restrict__ pcm, long long pcm_stride,
                    const float* __restrict__ xv, const float* __restrict__ yv,
                    int16_t* __restrict__ out, float* __restrict__ xv_out,
                    float* __restrict__ yv_out, int C, long long T, Iir k) {
  __shared__ float tile[LANES * PITCH];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int rows = min(LANES, C - c0);
  const bool live = lane < rows;
  const long long c = c0 + lane;
  float x[ORDER], y[ORDER];
#pragma unroll
  for (int j = 0; j < ORDER; ++j) {
    x[j] = live ? xv[c * ORDER + j] : 0.0f;
    y[j] = live ? yv[c * ORDER + j] : 0.0f;
  }
  float* row = tile + lane * PITCH;
  for (long long t0 = 0; t0 < T; t0 += TILE) {
    const int n = static_cast<int>(min(static_cast<long long>(TILE), T - t0));
    stage_in(tile, pcm, pcm_stride, c0, rows, t0, n);
    __syncwarp();
    if (live) {
      int t = 0;
      for (; t + ORDER <= n; t += ORDER) {
#pragma unroll
        for (int s = 0; s < ORDER; ++s) {  // the oldest values sit at s
          const float xin = iir_input(row[t + s], k);
          const float out_t = iir_output(x, y, k, s, xin);
          x[s] = xin;
          y[s] = out_t;
          row[t + s] = to_s16(out_t, k.scale);
        }
      }
      for (; t < n; ++t) {  // the stream's last ragged samples: shift
        const float xin = iir_input(row[t], k);
        const float out_t = iir_output(x, y, k, 0, xin);
#pragma unroll
        for (int j = 0; j < ORDER - 1; ++j) {
          x[j] = x[j + 1];
          y[j] = y[j + 1];
        }
        x[ORDER - 1] = xin;
        y[ORDER - 1] = out_t;
        row[t] = to_s16(out_t, k.scale);
      }
    }
    __syncwarp();
    stage_out(tile, out, T, c0, rows, t0, n);
    __syncwarp();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < ORDER; ++j) {
      xv_out[c * ORDER + j] = x[j];
      yv_out[c * ORDER + j] = y[j];
    }
  }
}

__global__ void __launch_bounds__(LANES)
dc_block_kernel(const float* __restrict__ x, long long x_stride,
                const float* __restrict__ x1, const float* __restrict__ y1,
                float* __restrict__ y, float* __restrict__ x1_out,
                float* __restrict__ y1_out, int C, long long T, float alpha) {
  __shared__ float tile[LANES * PITCH];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int rows = min(LANES, C - c0);
  const bool live = lane < rows;
  const long long c = c0 + lane;
  float xp = live ? x1[c] : 0.0f;
  float yp = live ? y1[c] : 0.0f;
  float* row = tile + lane * PITCH;
  for (long long t0 = 0; t0 < T; t0 += TILE) {
    const int n = static_cast<int>(min(static_cast<long long>(TILE), T - t0));
    stage_in(tile, x, x_stride, c0, rows, t0, n);
    __syncwarp();
    if (live) {
      for (int t = 0; t < n; ++t) {
        const float v = row[t];
        yp = __fadd_rn(__fsub_rn(v, xp), __fmul_rn(alpha, yp));
        xp = v;
        row[t] = yp;
      }
    }
    __syncwarp();
    stage_out(tile, y, T, c0, rows, t0, n);
    __syncwarp();
  }
  if (live) {
    x1_out[c] = xp;
    y1_out[c] = yp;
  }
}

}  // namespace

extern "C" {

// pcm [C, T] int16 with unit stride along time and row stride pcm_stride;
// xv, yv [C, 10] float32 contiguous (oldest first); coeffs: host memory,
// the 11 forward taps, the 10 feedback taps, then scale and gain; out
// [C, T] int16, xv_out, yv_out [C, 10] float32, all contiguous. T >= 1.
int digiham_digitalvoice_iir(const int16_t* pcm, long long pcm_stride,
                             const float* xv, const float* yv,
                             const float* coeffs, int16_t* out,
                             float* xv_out, float* yv_out, int C, long long T,
                             cudaStream_t stream) {
  Iir k;
  for (int j = 0; j <= ORDER; ++j) k.fw[j] = coeffs[j];
  for (int j = 0; j < ORDER; ++j) k.fb[j] = coeffs[ORDER + 1 + j];
  k.scale = coeffs[2 * ORDER + 1];
  k.gain = coeffs[2 * ORDER + 2];
  const int blocks = (C + LANES - 1) / LANES;
  digitalvoice_kernel<<<blocks, LANES, 0, stream>>>(
      pcm, pcm_stride, xv, yv, out, xv_out, yv_out, C, T, k);
  return static_cast<int>(cudaGetLastError());
}

// x [C, T] float32 with unit stride along time and row stride x_stride;
// x1, y1 [C] float32; y [C, T], x1_out, y1_out [C] float32, contiguous.
int digiham_dc_block(const float* x, long long x_stride, const float* x1,
                     const float* y1, float* y, float* x1_out, float* y1_out,
                     int C, long long T, float alpha, cudaStream_t stream) {
  const int blocks = (C + LANES - 1) / LANES;
  dc_block_kernel<<<blocks, LANES, 0, stream>>>(x, x_stride, x1, y1, y,
                                                x1_out, y1_out, C, T, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
