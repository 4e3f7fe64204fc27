// K5: the 16-state K=5 rate-1/2 Viterbi decoder for Hopper (sm_90a),
// forward metrics and traceback in one kernel.
//
// Replaces digiham_tpu/ops/viterbi_pallas.py::viterbi_decode_pallas. Users:
// YSF FICH and DCH (T = 100), NXDN SACCH (T = 36) and FACCH1 (T = 96) with
// the blocked start of 4 steps. Semantics: digiham_tpu/fec/viterbi.py, and
// the plain version viterbi_decode_plain in digiham_tpu_torch/fec/viterbi.py;
// all arithmetic is int32, so kernel and plain version agree exactly.
//
// Per trellis step, new state i takes the better of its two predecessors
// p(i, k) = ((i << 1) & 14) | k, k = 0 or 1, at the cost of the 2-bit
// distance between the observed dibit and the dibit expected on that
// branch. The tie rules are the reference's: a strict cand1 < cand0, so
// k = 0 wins equal metrics, and the lowest-numbered minimal final state
// starts the traceback. The NXDN blocked start adds no bias array: at step
// t < blocked_steps, state i may take k = 1 only if i & ((15 << t) & 15) == 0.
//
// Design: one thread per sequence. The 16 path metrics live in registers
// (the trellis loops are fully unrolled, so every index is static); each
// step's 16 decisions are one 16-bit mask in shared memory, [T][THREADS];
// the same thread walks them back. The expected dibits arrive as two packed
// 32-bit words (2 bits per state, for k = 0 and k = 1), built by the
// wrapper from the transition table, so the table has one home.
//
// Bound on an H100: 512 sequences of 100 steps move ~0.4 MB and need
// ~10 M integer operations, far below a microsecond either way, so the
// bound lies below one launch's latency and the kernel is launch-latency
// bound. What this simple design leaves on the table: 512 sequences fill 4
// blocks of 128 threads, on 4 of the 132 SMs; the observed dibits are read
// as int32 rows with a stride of T between neighbouring threads
// (uncoalesced); and the three launches of a step could be one.
// None of the TPU workarounds is carried over: no permutation matmuls, no
// one-hot traceback selects, no float metrics, no 128-lane padding, no
// bias input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STATES = 16;
constexpr int BIG = 1 << 28;

__global__ void __launch_bounds__(THREADS)
viterbi16_kernel(const int* __restrict__ obs, int* __restrict__ bits,
                 int* __restrict__ metric, int batch, int T, int blocked,
                 uint32_t exp0, uint32_t exp1) {
  extern __shared__ uint16_t dec[];  // [T][THREADS] decision masks
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= batch) return;
  const int* row = obs + (size_t)b * T;

  int m[STATES];
#pragma unroll
  for (int i = 0; i < STATES; ++i) m[i] = 0;

  for (int t = 0; t < T; ++t) {
    // every 2-bit field of x0 / x1: observed ^ expected for that state
    const uint32_t spread = (uint32_t)(row[t] & 3) * 0x55555555u;
    const uint32_t x0 = exp0 ^ spread, x1 = exp1 ^ spread;
    const int block_mask = t < blocked ? (15 << t) & 15 : 0;
    int nm[STATES];
    uint32_t mask = 0;
#pragma unroll
    for (int i = 0; i < STATES; ++i) {
      const int p = (i << 1) & (STATES - 2);
      const int d0 = ((x0 >> (2 * i)) & 1) + ((x0 >> (2 * i + 1)) & 1);
      const int d1 = ((x1 >> (2 * i)) & 1) + ((x1 >> (2 * i + 1)) & 1);
      const int cand0 = m[p] + d0;
      const int cand1 = (i & block_mask) ? BIG : m[p | 1] + d1;
      const bool take1 = cand1 < cand0;  // strict: k = 0 wins ties
      nm[i] = take1 ? cand1 : cand0;
      mask |= (uint32_t)take1 << i;
    }
#pragma unroll
    for (int i = 0; i < STATES; ++i) m[i] = nm[i];
    dec[t * THREADS + threadIdx.x] = (uint16_t)mask;
  }

  // the lowest-numbered minimal final state
  int best = m[0], state = 0;
#pragma unroll
  for (int i = 1; i < STATES; ++i) {
    if (m[i] < best) {
      best = m[i];
      state = i;
    }
  }
  metric[b] = best;

  int* out = bits + (size_t)b * T;
  for (int t = T - 1; t >= 0; --t) {
    out[t] = state >> 3;
    const int k = (dec[t * THREADS + threadIdx.x] >> state) & 1;
    state = ((state << 1) & (STATES - 2)) | k;
  }
}

}  // namespace

// C entry point bound with ctypes. obs: [batch, T] int32 dibits; bits:
// [batch, T] int32; metric: [batch] int32; exp0 / exp1: the expected dibit
// of state i on its k = 0 / k = 1 branch in bits [2i, 2i+2). Returns the
// launch's cudaError_t (0 on success).
extern "C" int digiham_viterbi16(const int* obs, int* bits, int* metric,
                                 int batch, int T, int blocked_steps,
                                 unsigned int exp0, unsigned int exp1,
                                 void* stream) {
  const size_t smem = (size_t)T * THREADS * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + THREADS - 1) / THREADS;
  viterbi16_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, bits, metric, batch, T, blocked_steps, exp0, exp1);
  return (int)cudaGetLastError();
}
