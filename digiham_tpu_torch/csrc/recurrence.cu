// K6: the serial recurrences of the audio path for Hopper (sm_90a).
//
// Two entries in one source, each with its plain version in
// digiham_tpu_torch/ops/recurrence.py:
//   digiham_digitalvoice_iir (int16 PCM) and digiham_digitalvoice_iir32
//     (int32 PCM) replace digiham_tpu/dsp/audio.py::digitalvoice_filter
//     (:62), the order-10 IIR bandpass on PCM (digitalvoice_iir_plain);
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
//        fw[10]*xin, summed left to right (x oldest first, the zero taps
//        included: dropping a 0*x term can change the sign of a zero);
//        b = fb[0]*y[0] + ... + fb[9]*y[9], left to right (y oldest first);
//        y = f + b; the output is y * scale clamped to [-32768, 32767] and
//        truncated toward zero, as XLA's float -> int16 conversion
//        saturates (a plain cast would wrap). int32 PCM converts to float
//        as the plain version's cast does (exactly below 2^24).
//   DC blocker: d = x - x1; y = d + (alpha * y1), with (x1, y1) carried.
//
// What bounds it on an H100: not bytes (256 channels x 32,000 samples of
// s16 in and out are 33 MB, 10 us at 3.35 TB/s) but the chain each sample
// waits on: the newest output enters the next sample's feedback sum as its
// last term, so one sample costs a dependent multiply and two dependent
// adds (the DC blocker: a multiply and an add), T times in a row.
//
// Design: split what depends on the inputs alone from what lies on the
// chain. A block holds up to ROWS channels (the caller spreads the
// channels over the SMs, one block an SM while they last: a chain warp
// takes as long for one channel as for 32, while the helpers' work grows
// with the channels, and a helper warp alone on its scheduler hides little
// latency, so at 16 channels a block the helpers, not the chain, set the
// pace) and 1 + HELPER_WARPS warps, each on its own scheduler (warp id
// mod 4):
// - warp 0 is the chain: one lane a channel. It loads f[t] (or d[t]) from
//   shared memory, forms the feedback sum from a rotating register window
//   (the time loop is unrolled by a multiple of ORDER, so step s of a turn
//   finds the oldest output at index s % ORDER and no value moves; the
//   last ragged samples shift the window instead), adds, and stores y[t]
//   as a float in place of f[t]. A turn's f values are loaded at its start
//   and four turns of ten samples are unrolled into one (the DC blocker:
//   80 samples), so the compiler interleaves the sums of neighbouring
//   samples across what would be turn boundaries. That is about 22
//   instructions a sample for the IIR and 4 for the DC blocker, issued in
//   order against a 12-cycle (8-cycle) chain: the chain lane's issue, not
//   the chain, is what holds the IIR back.
// - the helper warps work parallel over time, a thread per (channel,
//   sample): they copy each tile of TILE samples from device memory into a
//   raw ring in shared memory with cp.async, two tiles ahead of the tile
//   they work on (a copy is 4 bytes: any row stride works, and an int16
//   row is taken as the aligned words that hold it), so no helper waits
//   on device memory. From the raw tile they compute the scaled inputs xin
//   with two divides into a row that starts with the last ORDER inputs of
//   the tile before (or the carried xv), then the forward sums RUN outputs
//   a thread at a time (the DC blocker: d = x[t] - x[t-1]). A tile behind
//   the chain, they convert its outputs and write them out, coalesced.
// - SLOTS tile buffers form a ring: while the chain walks tile k, the
//   helpers fill tile k + 1 (and k + 2) and drain tile k - 1. Producers and
//   consumer meet at named barriers, a pair for each slot (bar.arrive by
//   the side that hands a slot over, bar.sync by the side that takes it),
//   once a tile, never once a sample; the helpers also sync among
//   themselves once a tile.
// Rows have an odd pitch, so the chain lanes' rows start in distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ORDER = 10;          // delay line of the IIR
constexpr int ROWS = 16;           // most channels a block, a chain lane each
constexpr int HELPER_WARPS = 3;    // warps that stage, pre-compute, drain
constexpr int HELPERS = 32 * HELPER_WARPS;
constexpr int THREADS = 32 + HELPERS;
constexpr int TILE = 32 * ORDER;   // samples a tile; a multiple of ORDER
constexpr int PITCH = TILE + ORDER + 1;  // words a row: room for the halo
constexpr int SLOTS = 3;           // tile buffers in the ring
constexpr int IIR_TURN = 4 * ORDER;  // samples a chain turn takes, unrolled
constexpr int DC_TURN = 8 * ORDER;
constexpr int RUN = 4;             // forward sums a helper thread takes
constexpr int BATCH = 4;           // samples a helper thread loads at once
constexpr int AHEAD = 2;           // tiles the raw copies run ahead
constexpr int RAW_PITCH = TILE + 1;  // 32-bit words a raw row
// named barriers (0 is __syncthreads): a slot's tile is ready for the
// chain; the chain is done with a slot; the helpers among themselves
constexpr int BAR_FULL = 1;
constexpr int BAR_EMPTY = BAR_FULL + SLOTS;
constexpr int BAR_HELPERS = BAR_EMPTY + SLOTS;
static_assert(ROWS <= 32, "one chain lane a channel");
static_assert(TILE % IIR_TURN == 0 && TILE % DC_TURN == 0 &&
                  IIR_TURN % ORDER == 0 && TILE % RUN == 0,
              "tile length");
static_assert(BAR_HELPERS < 16, "16 named barriers");

constexpr size_t RING_FLOATS = static_cast<size_t>(SLOTS) * ROWS * PITCH;
// raw tiles: AHEAD in flight and the one being read; the DC blocker also
// reads the last sample of the tile before
constexpr int IIR_RAW = AHEAD + 1;
constexpr int DC_RAW = AHEAD + 2;
constexpr size_t RAW_WORDS = static_cast<size_t>(ROWS) * RAW_PITCH;
// the IIR also keeps two rows of inputs a channel (tile k and k - 1)
constexpr size_t IIR_SMEM =
    sizeof(float) * (RING_FLOATS + 2 * ROWS * PITCH + IIR_RAW * RAW_WORDS);
constexpr size_t DC_SMEM = sizeof(float) * (RING_FLOATS + DC_RAW * RAW_WORDS);

struct Iir {
  float fw[ORDER + 1];  // forward taps, oldest input first
  float fb[ORDER];      // feedback taps, oldest output first
  float scale;          // SHRT_MAX
  float gain;           // GAIN
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Samples of tile `tile` (the last one may be short).
__device__ __forceinline__ int tile_len(long long tile, long long T) {
  return static_cast<int>(min(static_cast<long long>(TILE), T - tile * TILE));
}

// --- the chain warp ---------------------------------------------------------

// The feedback sum from a window whose oldest output sits at index s
// (known at compile time once the caller's loop is unrolled).
__device__ __forceinline__ float feedback(const float (&y)[ORDER],
                                          const Iir& k, int s) {
  float b = __fmul_rn(k.fb[0], y[s % ORDER]);
#pragma unroll
  for (int j = 1; j < ORDER; ++j) {
    b = __fadd_rn(b, __fmul_rn(k.fb[j], y[(s + j) % ORDER]));
  }
  return b;
}

// One chain lane per channel walks each tile's forward sums into outputs,
// in place, a turn of IIR_TURN samples at a time (a multiple of ORDER, so
// the window keeps rotating); only the stream's last tile can end in
// ragged samples.
__device__ void iir_chain(float* ring, const float* __restrict__ yv,
                          float* __restrict__ yv_out, long long c0, int rows,
                          long long T, long long tiles, const Iir& k) {
  const int lane = threadIdx.x;
  const bool live = lane < rows;
  const long long c = c0 + lane;
  float y[ORDER];
#pragma unroll
  for (int j = 0; j < ORDER; ++j) y[j] = live ? yv[c * ORDER + j] : 0.0f;
  for (long long i = 0; i < tiles; ++i) {
    const int slot = static_cast<int>(i % SLOTS);
    const int n = tile_len(i, T);
    bar_sync(BAR_FULL + slot, THREADS);
    if (live) {
      float* row = ring + (slot * ROWS + lane) * PITCH;
      int t = 0;
      for (; t + IIR_TURN <= n; t += IIR_TURN) {
        float f[IIR_TURN];
#pragma unroll
        for (int s = 0; s < IIR_TURN; ++s) f[s] = row[t + s];
#pragma unroll
        for (int s = 0; s < IIR_TURN; ++s) {  // the oldest at s % ORDER
          const float out_t = __fadd_rn(f[s], feedback(y, k, s));
          y[s % ORDER] = out_t;
          row[t + s] = out_t;
        }
      }
      for (; t < n; ++t) {  // the stream's last ragged samples: shift
        const float out_t = __fadd_rn(row[t], feedback(y, k, 0));
#pragma unroll
        for (int j = 0; j < ORDER - 1; ++j) y[j] = y[j + 1];
        y[ORDER - 1] = out_t;
        row[t] = out_t;
      }
    }
    __syncwarp();
    bar_arrive(BAR_EMPTY + slot, THREADS);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < ORDER; ++j) yv_out[c * ORDER + j] = y[j];
  }
}

__device__ void dc_chain(float* ring, const float* __restrict__ y1,
                         float* __restrict__ y1_out, long long c0, int rows,
                         long long T, long long tiles, float alpha) {
  const int lane = threadIdx.x;
  const bool live = lane < rows;
  float yp = live ? y1[c0 + lane] : 0.0f;
  for (long long i = 0; i < tiles; ++i) {
    const int slot = static_cast<int>(i % SLOTS);
    const int n = tile_len(i, T);
    bar_sync(BAR_FULL + slot, THREADS);
    if (live) {
      float* row = ring + (slot * ROWS + lane) * PITCH;
      int t = 0;
      for (; t + DC_TURN <= n; t += DC_TURN) {
        float d[DC_TURN];
#pragma unroll
        for (int s = 0; s < DC_TURN; ++s) d[s] = row[t + s];
#pragma unroll
        for (int s = 0; s < DC_TURN; ++s) {
          yp = __fadd_rn(d[s], __fmul_rn(alpha, yp));
          row[t + s] = yp;
        }
      }
      for (; t < n; ++t) {
        yp = __fadd_rn(row[t], __fmul_rn(alpha, yp));
        row[t] = yp;
      }
    }
    __syncwarp();
    bar_arrive(BAR_EMPTY + slot, THREADS);
  }
  if (live) y1_out[c0 + lane] = yp;
}

// --- the helper warps -------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until this thread's copies of tile i have landed: of its groups,
// tiles 0 .. i + AHEAD - 1 are committed, and the last AHEAD - 1 may still
// be in flight
__device__ __forceinline__ void cp_async_wait_tile() {
  asm volatile("cp.async.wait_group %0;" ::"n"(AHEAD - 1) : "memory");
}

// Where sample 0 of a raw row sits, in elements of In: an int16 row is
// copied from the aligned word that holds its first sample.
template <typename In>
__device__ __forceinline__ int raw_offset(const In* first) {
  if constexpr (sizeof(In) == 4) {
    return 0;
  } else {
    return static_cast<int>((reinterpret_cast<uintptr_t>(first) >> 1) & 1);
  }
}

// Start the copies of samples [t0, t0 + n) of rows [c0, c0 + rows) into a
// raw tile (a row every RAW_PITCH words) and commit them as one group;
// n <= 0 commits an empty group, so the count of groups stays one a tile.
// Neighbouring threads take neighbouring words of a row.
template <typename In>
__device__ inline void fetch(float* raw, const In* __restrict__ src,
                             long long stride, long long c0, int rows,
                             long long t0, int n, int h) {
  constexpr int PER_WORD = 4 / sizeof(In);
  constexpr int WORDS = TILE / PER_WORD + PER_WORD - 1;
  for (int i = h; n > 0 && i < rows * WORDS; i += HELPERS) {
    const int r = i / WORDS, w = i - r * WORDS;
    const In* first = src + (c0 + r) * stride + t0;
    const int off = raw_offset(first);
    // the aligned word that holds sample 0 (an int16 row may start in the
    // middle of one; the other half is never read)
    const uint32_t* words = reinterpret_cast<const uint32_t*>(first - off);
    if (w * PER_WORD < off + n) cp_async4(raw + r * RAW_PITCH + w, words + w);
  }
  cp_async_commit();
}

// Sample t of raw row r.
template <typename In>
__device__ __forceinline__ float raw_sample(const float* raw, int r, int off,
                                            int t) {
  const In* row = reinterpret_cast<const In*>(raw + r * RAW_PITCH);
  return static_cast<float>(row[off + t]);
}

// The scaled inputs of a raw tile into x[r * PITCH + ORDER + t].
template <typename In>
__device__ inline void scaled_inputs(float* x, const float* raw,
                                     const In* __restrict__ pcm,
                                     long long stride, long long c0, int rows,
                                     long long t0, int n, const Iir& k,
                                     int h) {
  for (int base = h; base < rows * TILE; base += BATCH * HELPERS) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      v[u] = i < rows * TILE && t < n
                 ? raw_sample<In>(raw, r,
                                  raw_offset(pcm + (c0 + r) * stride + t0), t)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      if (i < rows * TILE && t < n) {
        x[r * PITCH + ORDER + t] =
            __fdiv_rn(__fdiv_rn(v[u], k.scale), k.gain);
      }
    }
  }
}

// The forward sums of a tile from its inputs (x: ORDER carried inputs, then
// the tile's) into the ring slot, RUN outputs a thread (four independent
// sums); neighbouring threads take neighbouring rows.
__device__ inline void forward_sums(const float* x, float* f, int rows,
                                    int n, const Iir& k, int h) {
  for (int i = h; i < rows * (TILE / RUN); i += HELPERS) {
    const int r = i % rows, t = (i / rows) * RUN;
    if (t >= n) continue;
    const float* src = x + r * PITCH + t;
    float w[RUN + ORDER];
#pragma unroll
    for (int j = 0; j < RUN + ORDER; ++j) w[j] = src[j];
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      float s = __fmul_rn(k.fw[0], w[u]);
#pragma unroll
      for (int j = 1; j <= ORDER; ++j) {
        s = __fadd_rn(s, __fmul_rn(k.fw[j], w[u + j]));
      }
      if (t + u < n) f[r * PITCH + t + u] = s;
    }
  }
}

// The DC blocker's differences d = x[t] - x[t-1] of a raw tile into its
// slot: before sample 0, the last of the tile before (raw ring ``prev``),
// or x1 at the stream's start.
__device__ inline void differences(float* d, const float* raw,
                                   const float* prev,
                                   const float* __restrict__ x1, long long c0,
                                   int rows, long long t0, int n, int h) {
  for (int base = h; base < rows * TILE; base += BATCH * HELPERS) {
    float v[BATCH], p[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      const bool in = i < rows * TILE && t < n;
      const float* row = raw + r * RAW_PITCH;
      v[u] = in ? row[t] : 0.0f;
      p[u] = !in     ? 0.0f
             : t > 0  ? row[t - 1]
             : t0 > 0 ? prev[r * RAW_PITCH + TILE - 1]
                      : x1[c0 + r];
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      if (i < rows * TILE && t < n) d[r * PITCH + t] = __fsub_rn(v[u], p[u]);
    }
  }
}

// A walked tile to rows [c0, c0 + rows) of the contiguous [C, T] output:
// int16 (y * scale, clamped, truncated toward zero) or the floats as they
// are.
template <typename Out>
__device__ inline void drain(const float* y, Out* __restrict__ out,
                             long long T, long long c0, int rows,
                             long long t0, int n, float scale, int h) {
  for (int base = h; base < rows * TILE; base += BATCH * HELPERS) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      v[u] = i < rows * TILE && t < n ? y[r * PITCH + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * HELPERS;
      const int r = i / TILE, t = i - r * TILE;
      if (i >= rows * TILE || t >= n) continue;
      if constexpr (sizeof(Out) == 2) {
        const float s =
            fminf(fmaxf(__fmul_rn(v[u], scale), -32768.0f), 32767.0f);
        out[(c0 + r) * T + t0 + t] = static_cast<Out>(__float2int_rz(s));
      } else {
        out[(c0 + r) * T + t0 + t] = v[u];
      }
    }
  }
}

// --- the kernels ------------------------------------------------------------

template <typename In>
__global__ void __launch_bounds__(THREADS, 1)
iir_split_kernel(const In* __restrict__ pcm, long long pcm_stride,
                 const float* __restrict__ xv, const float* __restrict__ yv,
                 int16_t* __restrict__ out, float* __restrict__ xv_out,
                 float* __restrict__ yv_out, int C, long long T,
                 int block_rows, Iir k) {
  extern __shared__ float smem[];
  float* ring = smem;                  // [SLOTS][ROWS][PITCH]
  float* inputs = smem + RING_FLOATS;  // [2][ROWS][PITCH], by tile parity
  float* raws = inputs + 2 * ROWS * PITCH;  // [IIR_RAW][ROWS][RAW_PITCH]
  const long long c0 = static_cast<long long>(blockIdx.x) * block_rows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(block_rows), C - c0));
  const long long tiles = (T + TILE - 1) / TILE;
  if (threadIdx.x < 32) {
    iir_chain(ring, yv, yv_out, c0, rows, T, tiles, k);
    return;
  }
  const int h = threadIdx.x - 32;
  for (int a = 0; a < AHEAD; ++a) {
    fetch(raws + a * RAW_WORDS, pcm, pcm_stride, c0, rows, a * TILE,
          a < tiles ? tile_len(a, T) : 0, h);
  }
  for (int j = h; j < rows * ORDER; j += HELPERS) {  // the carried inputs
    const int r = j / ORDER, u = j - r * ORDER;
    inputs[r * PITCH + u] = xv[(c0 + r) * ORDER + u];
  }
  for (long long i = 0; i < tiles + SLOTS - 1; ++i) {
    if (i < tiles) {  // tile i into its slot
      const int slot = static_cast<int>(i % SLOTS);
      const int n = tile_len(i, T);
      cp_async_wait_tile();
      // tile i's raw copies have landed, and every helper is done with tile
      // i - 1: its raw tile, its inputs, and draining tile i - SLOTS out of
      // this slot
      bar_sync(BAR_HELPERS, HELPERS);
      const long long ahead = i + AHEAD;
      fetch(raws + (ahead % IIR_RAW) * RAW_WORDS, pcm, pcm_stride, c0, rows,
            ahead * TILE, ahead < tiles ? tile_len(ahead, T) : 0, h);
      float* x = inputs + (i & 1) * ROWS * PITCH;
      if (i > 0) {  // the halo: the last ORDER inputs of tile i - 1 (full)
        const float* prev = inputs + ((i - 1) & 1) * ROWS * PITCH;
        for (int j = h; j < rows * ORDER; j += HELPERS) {
          const int r = j / ORDER, u = j - r * ORDER;
          x[r * PITCH + u] = prev[r * PITCH + TILE + u];
        }
      }
      scaled_inputs(x, raws + (i % IIR_RAW) * RAW_WORDS, pcm, pcm_stride, c0,
                    rows, i * TILE, n, k, h);
      bar_sync(BAR_HELPERS, HELPERS);  // every input of the tile is in x
      forward_sums(x, ring + slot * ROWS * PITCH, rows, n, k, h);
      bar_arrive(BAR_FULL + slot, THREADS);
    }
    if (i >= SLOTS - 1) {  // tile i - SLOTS + 1 out, once walked
      const long long j = i - (SLOTS - 1);
      const int slot = static_cast<int>(j % SLOTS);
      bar_sync(BAR_EMPTY + slot, THREADS);
      drain(ring + slot * ROWS * PITCH, out, T, c0, rows, j * TILE,
            tile_len(j, T), k.scale, h);
    }
  }
  // the carried inputs: the last ORDER of the last tile's row, halo first
  const float* x = inputs + ((tiles - 1) & 1) * ROWS * PITCH;
  const int n = tile_len(tiles - 1, T);
  for (int j = h; j < rows * ORDER; j += HELPERS) {
    const int r = j / ORDER, u = j - r * ORDER;
    xv_out[(c0 + r) * ORDER + u] = x[r * PITCH + n + u];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dc_split_kernel(const float* __restrict__ x, long long x_stride,
                const float* __restrict__ x1, const float* __restrict__ y1,
                float* __restrict__ y, float* __restrict__ x1_out,
                float* __restrict__ y1_out, int C, long long T,
                int block_rows, float alpha) {
  extern __shared__ float smem[];
  float* ring = smem;                 // [SLOTS][ROWS][PITCH]
  float* raws = smem + RING_FLOATS;   // [DC_RAW][ROWS][RAW_PITCH]
  const long long c0 = static_cast<long long>(blockIdx.x) * block_rows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(block_rows), C - c0));
  const long long tiles = (T + TILE - 1) / TILE;
  if (threadIdx.x < 32) {
    dc_chain(ring, y1, y1_out, c0, rows, T, tiles, alpha);
    return;
  }
  const int h = threadIdx.x - 32;
  for (int a = 0; a < AHEAD; ++a) {
    fetch(raws + a * RAW_WORDS, x, x_stride, c0, rows, a * TILE,
          a < tiles ? tile_len(a, T) : 0, h);
  }
  for (long long i = 0; i < tiles + SLOTS - 1; ++i) {
    if (i < tiles) {
      const int slot = static_cast<int>(i % SLOTS);
      cp_async_wait_tile();
      // tile i's raw copies have landed, and every helper is done with tile
      // i - 1 (its raw tile and the one before, read for its first
      // difference) and with draining tile i - SLOTS out of this slot
      bar_sync(BAR_HELPERS, HELPERS);
      const long long ahead = i + AHEAD;
      fetch(raws + (ahead % DC_RAW) * RAW_WORDS, x, x_stride, c0, rows,
            ahead * TILE, ahead < tiles ? tile_len(ahead, T) : 0, h);
      differences(ring + slot * ROWS * PITCH, raws + (i % DC_RAW) * RAW_WORDS,
                  raws + ((i + DC_RAW - 1) % DC_RAW) * RAW_WORDS, x1, c0,
                  rows, i * TILE, tile_len(i, T), h);
      bar_arrive(BAR_FULL + slot, THREADS);
    }
    if (i >= SLOTS - 1) {
      const long long j = i - (SLOTS - 1);
      const int slot = static_cast<int>(j % SLOTS);
      bar_sync(BAR_EMPTY + slot, THREADS);
      drain(ring + slot * ROWS * PITCH, y, T, c0, rows, j * TILE,
            tile_len(j, T), 1.0f, h);
    }
  }
  for (int r = h; r < rows; r += HELPERS) {
    x1_out[c0 + r] = x[(c0 + r) * x_stride + T - 1];
  }
}

template <typename In>
int launch_iir(const In* pcm, long long pcm_stride, const float* xv,
               const float* yv, const float* coeffs, int16_t* out,
               float* xv_out, float* yv_out, int C, long long T,
               int block_rows, cudaStream_t stream) {
  if (block_rows < 1 || block_rows > ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Iir k;
  for (int j = 0; j <= ORDER; ++j) k.fw[j] = coeffs[j];
  for (int j = 0; j < ORDER; ++j) k.fb[j] = coeffs[ORDER + 1 + j];
  k.scale = coeffs[2 * ORDER + 1];
  k.gain = coeffs[2 * ORDER + 2];
  const cudaError_t e = cudaFuncSetAttribute(
      iir_split_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(IIR_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (C + block_rows - 1) / block_rows;
  iir_split_kernel<In><<<blocks, THREADS, IIR_SMEM, stream>>>(
      pcm, pcm_stride, xv, yv, out, xv_out, yv_out, C, T, block_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pcm [C, T] int16 (int32 for digiham_digitalvoice_iir32) with unit stride
// along time and row stride pcm_stride; xv, yv [C, 10] float32 contiguous
// (oldest first); coeffs: host memory, the 11 forward taps, the 10
// feedback taps, then scale and gain; out [C, T] int16, xv_out, yv_out
// [C, 10] float32, all contiguous. C, T >= 1; block_rows, the channels a
// block takes, 1 to 16.
int digiham_digitalvoice_iir(const int16_t* pcm, long long pcm_stride,
                             const float* xv, const float* yv,
                             const float* coeffs, int16_t* out,
                             float* xv_out, float* yv_out, int C, long long T,
                             int block_rows, cudaStream_t stream) {
  return launch_iir(pcm, pcm_stride, xv, yv, coeffs, out, xv_out, yv_out, C,
                    T, block_rows, stream);
}

int digiham_digitalvoice_iir32(const int32_t* pcm, long long pcm_stride,
                               const float* xv, const float* yv,
                               const float* coeffs, int16_t* out,
                               float* xv_out, float* yv_out, int C,
                               long long T, int block_rows,
                               cudaStream_t stream) {
  return launch_iir(pcm, pcm_stride, xv, yv, coeffs, out, xv_out, yv_out, C,
                    T, block_rows, stream);
}

// x [C, T] float32 with unit stride along time and row stride x_stride;
// x1, y1 [C] float32; y [C, T], x1_out, y1_out [C] float32, contiguous.
// C, T >= 1; block_rows as above.
int digiham_dc_block(const float* x, long long x_stride, const float* x1,
                     const float* y1, float* y, float* x1_out, float* y1_out,
                     int C, long long T, float alpha, int block_rows,
                     cudaStream_t stream) {
  if (block_rows < 1 || block_rows > ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      dc_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DC_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (C + block_rows - 1) / block_rows;
  dc_split_kernel<<<blocks, THREADS, DC_SMEM, stream>>>(
      x, x_stride, x1, y1, y, x1_out, y1_out, C, T, block_rows, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
