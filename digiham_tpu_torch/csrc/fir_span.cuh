// The register-window FIR shared by K1/K2 (demod_front.cu) and K4 (fir.cu),
// so that the rounding order has one home.
//
//   acc[r] = taps[0] * x[r], then acc[r] = acc[r] + taps[j] * x[r + j] for
//   j = 1 .. ntaps-1, every product and every sum rounded to float32 on its
//   own (__fmul_rn / __fadd_rn never contract into an FMA).
//
// A thread takes R consecutive outputs and slides its inputs through a
// register window: a step of FIR_UNROLL = 8 taps reads 8 new inputs and two
// 16-byte words of taps from shared memory for 8 * R multiplies and as many
// adds (R = 5: 10 loads per 80 operations). With R odd, threads R words
// apart never meet on a shared-memory bank. The taps are staged with tap j
// at tap_s[j + 3] (tap_s 16-byte aligned), so that taps 1, 5, 9, .. start
// 16-byte words.

#pragma once

constexpr int FIR_UNROLL = 8;  // taps per step of the register window

// floats of shared memory the staged taps take: tap j at [j + 3]
__host__ __device__ inline int fir_tap_floats(int ntaps) {
  return (ntaps + 3 + 3) & ~3;
}

// U taps (FIR_UNROLL, or 1 for what is left of ntaps - 1), from tap j on,
// into R consecutive outputs. On entry w[0..R-2] = x[j..j+R-2]; on exit the
// same for j + U. Tap j is tap_s[j + 3], and j is 1 modulo 4 when U is a
// multiple of 4 (16-byte loads of taps).
template <int R, int U>
__device__ __forceinline__ void fir_step(const float* x, const float* tap_s,
                                         int j, float (&w)[R - 1 + FIR_UNROLL],
                                         float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < U; ++i) w[R - 1 + i] = x[j + R - 1 + i];
  float tj[U];
  if (U % 4 == 0) {
#pragma unroll
    for (int q = 0; q < U / 4; ++q) {
      const float4 tp =
          *reinterpret_cast<const float4*>(tap_s + 3 + j + 4 * q);
      tj[4 * q] = tp.x;
      tj[4 * q + 1] = tp.y;
      tj[4 * q + 2] = tp.z;
      tj[4 * q + 3] = tp.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) tj[i] = tap_s[3 + j + i];
  }
#pragma unroll
  for (int jj = 0; jj < U; ++jj) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = __fadd_rn(acc[r], __fmul_rn(tj[jj], w[r + jj]));
  }
#pragma unroll
  for (int i = 0; i < R - 1; ++i) w[i] = w[i + U];
}

// R consecutive FIR outputs acc[r] = sum_j taps[j] * x[r + j], tap by tap
// in order, each product and sum rounded on its own. x is in shared memory
// and readable up to x[R - 1 + ntaps - 1]. The inputs slide through a
// register window: U taps take U new inputs.
template <int R>
__device__ __forceinline__ void fir_span(const float* x, const float* tap_s,
                                         int ntaps, float (&acc)[R]) {
  float w[R - 1 + FIR_UNROLL];
#pragma unroll
  for (int i = 0; i < R; ++i) w[i] = x[i];
  const float first = tap_s[3];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = __fmul_rn(first, w[r]);
#pragma unroll
  for (int i = 0; i < R - 1; ++i) w[i] = w[i + 1];
  int j = 1;
  for (; j + FIR_UNROLL <= ntaps; j += FIR_UNROLL)
    fir_step<R, FIR_UNROLL>(x, tap_s, j, w, acc);
  for (; j < ntaps; ++j) fir_step<R, 1>(x, tap_s, j, w, acc);
}
