// K5: the Viterbi decoder of the rate-1/2 convolutional codes for Hopper
// (sm_90a), 16 states (K=5) and 4 states (K=3), forward metrics and
// traceback in one kernel, any number of batches ("segments") of sequences
// in one launch.
//
// Replaces digiham_tpu/ops/viterbi_pallas.py::viterbi_decode_pallas (16
// states) and, at 4 states, the XLA scan of digiham_tpu/fec/viterbi.py that
// the JAX package runs for them. Users: YSF FICH and DCH (T = 100), NXDN
// SACCH (T = 36) and FACCH1 (T = 96) with the blocked start of 4 steps; at 4
// states the D-Star header code (T = 330). Semantics:
// digiham_tpu/fec/viterbi.py, and the plain version viterbi_decode_plain in
// digiham_tpu_torch/fec/viterbi.py; all arithmetic is int32, so kernel and
// plain version agree exactly.
//
// With S states and B = log2(S), per trellis step new state i takes the
// better of its two predecessors p(i, k) = ((i << 1) & (S - 2)) | k, k = 0
// or 1, at the cost of the 2-bit distance between the observed dibit and the
// dibit expected on that branch. The tie rules are the reference's: a strict
// cand1 < cand0, so k = 0 wins equal metrics, and the lowest-numbered
// minimal final state starts the traceback. The blocked start (NXDN's B = 4
// steps, or B = 2 at 4 states) adds no bias array: at step t < B, state i
// may take k = 1 only if i & (((S - 1) << t) & (S - 1)) == 0; the mask is 0
// from step B on by itself.
//
// What bounds it on an H100: 512 sequences of 100 steps move 0.4 MB and need
// about 10 M integer operations, far below a microsecond either way, so the
// bound lies below one launch's latency. What the kernel's time comes to is
// one sequence's chain of dependent steps, so the design makes that chain
// short and runs every sequence's chain at once:
//   - A trellis state per lane. A sequence rides S lanes, 32 / S sequences
//     a warp (two at 16 states, eight at 4). Lane i holds m[i]; its two
//     predecessors' metrics come by two __shfl_sync of width S; its two
//     expected dibits are constants cut once from the packed words exp0 /
//     exp1; the S decisions of a step are a field of S bits of one
//     __ballot_sync (the warp's sequence g in bits [S g, S g + S)), one
//     32-bit word per step and warp in shared memory.
//   - The lowest-numbered minimal final state is a minimum over the key
//     (metric << B) | state by B shuffles (metrics stay below 2 * T).
//   - The traceback is one lane per sequence walking the ballot words; it
//     leaves the bits in shared memory over the sequence's dibits.
//   - Four steps a turn of either loop, unrolled: four dibits (forward) or
//     four decoded bits (backward) are one 32-bit word of shared memory, and
//     the next turn's word is loaded before this turn's stores.
//   - Coalesced both ways: a block stages its sequences' dibits into shared
//     memory with neighbouring threads on neighbouring addresses, whatever
//     the element size (1, 4 or 8 bytes) and row stride, and writes its bits
//     out the same way.
//   - Blocks of 2 warps (4 sequences at 16 states, 16 at 4): 512 sequences
//     of 16 states are 128 blocks on as many SMs.
//   - One launch for all of a step's decodes: the grid covers up to
//     MAX_SEGMENTS batches, each with its own input, T and blocked start
//     (one number of states a launch).
// The expected dibits arrive as two packed 32-bit words (2 bits per state,
// for k = 0 and k = 1), built by the wrapper from the transition table, so
// the table has one home.
// None of the TPU workarounds is carried over: no permutation matmuls, no
// one-hot traceback selects, no float metrics, no 128-lane padding, no
// bias input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SEGMENTS = 4;
constexpr int GROUP = 4;  // steps whose dibits are one 32-bit shared word
constexpr int BIG = 1 << 28;
constexpr unsigned FULL = 0xffffffffu;

static_assert(GROUP == 4, "round4, and the blocked start is one group");

// what the number of states S fixes
template <int S>
struct States {
  static_assert(S == 4 || S == 16, "the 4- and 16-state codes");
  static constexpr int BITS = S == 16 ? 4 : 2;  // log2 S: the state's bits
  static constexpr int PER_WARP = 32 / S;       // sequences of one warp
  static constexpr int SEQS = PER_WARP * WARPS; // sequences of one block
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

}  // namespace

// One batch of sequences of one length.
struct Segment {
  const void* obs;        // [batch, steps] dibits, elem_size bytes each
  int* bits;              // [batch, steps] contiguous
  int* metric;            // [batch]
  long long row_stride;   // of obs, in elements
  int elem_size;          // 1 (uint8), 4 (int32) or 8 (int64)
  int batch;
  int steps;
  int blocked;            // 0, or log2 S: the blocked start
  int first_block;        // its first block of the grid
};

struct Segments {
  Segment seg[MAX_SEGMENTS];
  int count;
  // the expected dibit of state i on branch k = 0 / 1 in bits [2i, 2i+2)
  unsigned exp0, exp1;
};

namespace {

__device__ __forceinline__ int load_dibit(const void* base, int elem_size,
                                          long long at) {
  if (elem_size == 1) return static_cast<const uint8_t*>(base)[at];
  if (elem_size == 4) return static_cast<const int*>(base)[at];
  return (int)static_cast<const long long*>(base)[at];
}

// One trellis step of the lane's state: m <- the better candidate; returns
// the decision (true: k = 1).
template <int S, bool BLOCKED>
__device__ __forceinline__ bool trellis_step(int& m, int d, int t, int i,
                                             int p, int e0, int e1) {
  const int m0 = __shfl_sync(FULL, m, p, S);
  const int m1 = __shfl_sync(FULL, m, p | 1, S);
  const int cand0 = m0 + __popc(e0 ^ d);
  int cand1 = m1 + __popc(e1 ^ d);
  if (BLOCKED && (i & ((S - 1) << t) & (S - 1))) cand1 = BIG;
  const bool take1 = cand1 < cand0;  // strict: k = 0 wins ties
  m = take1 ? cand1 : cand0;
  return take1;
}

// N <= GROUP steps from t0 on, their dibits in the bytes of cur; each
// step's ballot goes to words[t].
template <int S, bool BLOCKED, int N>
__device__ __forceinline__ void trellis_group(int& m, uint32_t cur, int t0,
                                              int i, int p, int e0, int e1,
                                              int lane, uint32_t* words) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const bool take1 = trellis_step<S, BLOCKED>(m, (cur >> (8 * q)) & 3,
                                                t0 + q, i, p, e0, e1);
    const unsigned word = __ballot_sync(FULL, take1);
    if (lane == 0) words[t0 + q] = word;
  }
}

// The n <= GROUP steps of one word of dibits: a full group unrolled, the
// ragged last one step by step.
template <int S, bool BLOCKED>
__device__ __forceinline__ void trellis_group_of(int n, int& m, uint32_t cur,
                                                 int t0, int i, int p, int e0,
                                                 int e1, int lane,
                                                 uint32_t* words) {
  if (n == GROUP) {
    trellis_group<S, BLOCKED, GROUP>(m, cur, t0, i, p, e0, e1, lane, words);
  } else {
    for (int q = 0; q < n; ++q)
      trellis_group<S, BLOCKED, 1>(m, cur >> (8 * q), t0 + q, i, p, e0, e1,
                                   lane, words);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
viterbi_kernel(const __grid_constant__ Segments a) {
  using St = States<S>;
  extern __shared__ __align__(16) uint32_t smem[];
  // this block's segment: the last one that starts at or before it
  Segment s = a.seg[0];
#pragma unroll
  for (int k = 1; k < MAX_SEGMENTS; ++k)
    if (k < a.count && (int)blockIdx.x >= a.seg[k].first_block) s = a.seg[k];
  const int T = s.steps;
  const int row_bytes = round4(T);
  const int seq0 = ((int)blockIdx.x - s.first_block) * St::SEQS;
  const int nseq = min(St::SEQS, s.batch - seq0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane / S, i = lane % S;  // the warp's sequence g, state i

  uint32_t* words = smem + warp * T;  // [WARPS][T] ballots of this warp
  // [SEQS][row_bytes] dibits, then the decoded bits, a byte each
  uint8_t* sym = reinterpret_cast<uint8_t*>(smem + WARPS * T);

  for (int at = tid; at < St::SEQS * T; at += THREADS) {
    const int r = at / T, t = at - r * T;
    sym[r * row_bytes + t] =
        r < nseq ? load_dibit(s.obs, s.elem_size,
                              (long long)(seq0 + r) * s.row_stride + t) & 3
                 : 0;
  }
  __syncthreads();

  // Forward, GROUP = 4 steps to one 32-bit word of dibits. The next word
  // (and, on the way back, the next ballot word) is read one turn early,
  // before the turn's own stores: shared memory written in between could
  // alias it for all the compiler knows, so it would not move the load up
  // by itself, and the load would lengthen the chain.
  const int p = (i << 1) & (S - 2);
  const int e0 = (a.exp0 >> (2 * i)) & 3, e1 = (a.exp1 >> (2 * i)) & 3;
  const int row = St::PER_WARP * warp + g;  // this lane's sequence
  uint32_t* mine = reinterpret_cast<uint32_t*>(sym + row * row_bytes);
  const int groups = row_bytes / GROUP;
  int m = 0;
  uint32_t cur = mine[0];
  for (int q = 0; q < groups; ++q) {
    const uint32_t next = mine[q + 1 < groups ? q + 1 : q];
    const int t0 = GROUP * q, n = min(GROUP, T - t0);
    // blocked_steps is 0 or log2 S <= GROUP: the blocked start lies in the
    // first group
    if (q == 0 && s.blocked)
      trellis_group_of<S, true>(n, m, cur, t0, i, p, e0, e1, lane, words);
    else
      trellis_group_of<S, false>(n, m, cur, t0, i, p, e0, e1, lane, words);
    cur = next;
  }

  // the lowest-numbered minimal final state: the least (metric, state)
  int key = (m << St::BITS) | i;
#pragma unroll
  for (int x = S / 2; x; x >>= 1)
    key = min(key, __shfl_xor_sync(FULL, key, x, S));
  __syncwarp();  // the ballot words are lane 0's stores
  if (i == 0 && row < nseq) {
    s.metric[seq0 + row] = key >> St::BITS;
    int state = key & (S - 1);
    const int low = S * g;  // this sequence's field of a ballot word
    unsigned word = words[T - 1] >> low;
    uint32_t bytes = 0;  // the decoded bits of one group, a byte each
#pragma unroll 4
    for (int u = T - 1; u >= 0; --u) {
      const unsigned word_next = words[u ? u - 1 : 0] >> low;
      bytes = (bytes << 8) | (uint32_t)(state >> (St::BITS - 1));
      state = ((state << 1) & (S - 2)) | ((word >> state) & 1);
      word = word_next;
      if (u % GROUP == 0) {
        mine[u / GROUP] = bytes;
        bytes = 0;
      }
    }
  }
  __syncthreads();

  int* out = s.bits + (size_t)seq0 * T;
  for (int at = tid; at < nseq * T; at += THREADS) {
    const int r = at / T;
    out[at] = sym[r * row_bytes + (at - r * T)];
  }
}

// dynamic shared memory of a block whose sequences have this many steps;
// max_steps in ops/viterbi.py follows it
template <int S>
size_t smem_of(int steps) {
  return (size_t)steps * WARPS * sizeof(uint32_t) +
         (size_t)States<S>::SEQS * round4(steps);
}

template <int S>
int launch(Segments& a, cudaStream_t stream) {
  int blocks = 0, longest = 0;
  for (int k = 0; k < a.count; ++k) {
    a.seg[k].first_block = blocks;
    blocks += (a.seg[k].batch + States<S>::SEQS - 1) / States<S>::SEQS;
    if (a.seg[k].steps > longest) longest = a.seg[k].steps;
  }
  const size_t smem = smem_of<S>(longest);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_kernel<S><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int one_batch(const void* obs, int elem_size, long long row_stride,
              int* bits, int* metric, int batch, int T, int blocked_steps,
              unsigned int exp0, unsigned int exp1, void* stream) {
  Segments a = {};
  a.seg[0].obs = obs;
  a.seg[0].bits = bits;
  a.seg[0].metric = metric;
  a.seg[0].row_stride = row_stride;
  a.seg[0].elem_size = elem_size;
  a.seg[0].batch = batch;
  a.seg[0].steps = T;
  a.seg[0].blocked = blocked_steps;
  a.count = 1;
  a.exp0 = exp0;
  a.exp1 = exp1;
  return launch<S>(a, static_cast<cudaStream_t>(stream));
}

template <int S>
int many_batches(const long long* fields, int count, unsigned int exp0,
                 unsigned int exp1, void* stream) {
  if (count < 1 || count > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  Segments a = {};
  for (int k = 0; k < count; ++k) {
    const long long* f = fields + 8 * k;
    Segment& s = a.seg[k];
    s.obs = reinterpret_cast<const void*>(f[0]);
    s.bits = reinterpret_cast<int*>(f[1]);
    s.metric = reinterpret_cast<int*>(f[2]);
    s.row_stride = f[3];
    s.elem_size = (int)f[4];
    s.batch = (int)f[5];
    s.steps = (int)f[6];
    s.blocked = (int)f[7];
  }
  a.count = count;
  a.exp0 = exp0;
  a.exp1 = exp1;
  return launch<S>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points bound with ctypes, one pair per number of states
// (digiham_viterbi16*, digiham_viterbi4*); each returns the launch's
// cudaError_t (0 on success).
//
// One batch. obs: [batch, T] dibits of elem_size bytes (1, 4 or 8) with
// row stride row_stride elements and unit stride along T; bits: [batch, T]
// int32; metric: [batch] int32; exp0 / exp1: the expected dibit of state i
// on its k = 0 / k = 1 branch in bits [2i, 2i+2). batch >= 1, T >= 1.
extern "C" int digiham_viterbi16(const void* obs, int elem_size,
                                 long long row_stride, int* bits, int* metric,
                                 int batch, int T, int blocked_steps,
                                 unsigned int exp0, unsigned int exp1,
                                 void* stream) {
  return one_batch<16>(obs, elem_size, row_stride, bits, metric, batch, T,
                       blocked_steps, exp0, exp1, stream);
}

extern "C" int digiham_viterbi4(const void* obs, int elem_size,
                                long long row_stride, int* bits, int* metric,
                                int batch, int T, int blocked_steps,
                                unsigned int exp0, unsigned int exp1,
                                void* stream) {
  return one_batch<4>(obs, elem_size, row_stride, bits, metric, batch, T,
                      blocked_steps, exp0, exp1, stream);
}

// 1 .. MAX_SEGMENTS batches in one launch. fields: per segment 8 64-bit
// integers, in this order: the addresses of obs, bits and metric, the row
// stride, the element size, batch, T and blocked_steps, each as the one-batch
// entry takes it (read at fields + 8 * k); every segment has batch >= 1 and
// T >= 1.
extern "C" int digiham_viterbi16_many(const long long* fields, int count,
                                      unsigned int exp0, unsigned int exp1,
                                      void* stream) {
  return many_batches<16>(fields, count, exp0, exp1, stream);
}

extern "C" int digiham_viterbi4_many(const long long* fields, int count,
                                     unsigned int exp0, unsigned int exp1,
                                     void* stream) {
  return many_batches<4>(fields, count, exp0, exp1, stream);
}
