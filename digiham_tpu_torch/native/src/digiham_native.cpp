// Native host-side runtime for digiham_tpu_torch (a copy of the JAX
// package's digiham_tpu/native/src/digiham_native.cpp; the same C functions,
// the same semantics).
//
// The reference's runtime substrate is csdr's C++ ring buffers plus
// per-sample C loops (src/lib/). The framework keeps the hot *compute* on
// the device; this library provides the native equivalents of the host-side
// stream plumbing that sits around the device:
//
//  - a single-producer/single-consumer byte ring buffer (the transport
//    between ingest threads and the device dispatch loop)
//  - symbol/bit packing kernels (payload byte packing on the egress path)
//  - pattern correlation (sync hunting in the host control plane)
//  - the control plane's per-frame Viterbi decode (YSF header DCH, NXDN,
//    the D-Star header)
//
// Exposed as a plain C ABI consumed via ctypes (no Python headers needed);
// the public header keeps signature drift a compile error (the relative
// include works for both the CMake build and the on-demand ctypes g++ build).
#include "../include/digiham_native.h"

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- popcount
static inline int popcount8(uint8_t v) {
#if defined(__GNUC__)
    return __builtin_popcount(v);
#else
    int c = 0;
    while (v) { c += v & 1; v >>= 1; }
    return c;
#endif
}

// Hamming distance between two symbol arrays (bytewise popcount of XOR,
// same contract as the reference's hamming_distance.c).
int32_t dh_hamming_distance(const uint8_t* a, const uint8_t* b, size_t n) {
    int32_t d = 0;
    for (size_t i = 0; i < n; i++) d += popcount8(a[i] ^ b[i]);
    return d;
}

// Scan for the first offset where the pattern matches with distance
// <= max_dist. Returns the offset or -1. Checks offsets [0, n - plen].
int64_t dh_sync_scan(const uint8_t* data, size_t n, const uint8_t* pattern,
                     size_t plen, int32_t max_dist) {
    if (n < plen) return -1;
    for (size_t off = 0; off + plen <= n; off++) {
        int32_t d = 0;
        for (size_t i = 0; i < plen && d <= max_dist; i++) {
            d += popcount8(data[off + i] ^ pattern[i]);
        }
        if (d <= max_dist) return (int64_t) off;
    }
    return -1;
}

// Dense distances at every offset (for acquisition diagnostics).
void dh_sync_distances(const uint8_t* data, size_t n, const uint8_t* pattern,
                       size_t plen, int32_t* out) {
    if (n < plen) return;
    for (size_t off = 0; off + plen <= n; off++) {
        int32_t d = 0;
        for (size_t i = 0; i < plen; i++) {
            d += popcount8(data[off + i] ^ pattern[i]);
        }
        out[off] = d;
    }
}

// ------------------------------------------------------------------ packing
// Pack dibits 4-per-byte MSB-first (dmr_phase.cpp:216-225 convention).
void dh_pack_dibits(const uint8_t* in, size_t n, uint8_t* out) {
    size_t nbytes = (n + 3) / 4;
    memset(out, 0, nbytes);
    for (size_t i = 0; i < n; i++) {
        out[i / 4] |= (uint8_t) ((in[i] & 3) << (6 - 2 * (i % 4)));
    }
}

// Pack bits 8-per-byte, MSB first.
void dh_pack_bits_msb(const uint8_t* in, size_t n, uint8_t* out) {
    size_t nbytes = (n + 7) / 8;
    memset(out, 0, nbytes);
    for (size_t i = 0; i < n; i++) {
        out[i / 8] |= (uint8_t) ((in[i] & 1) << (7 - i % 8));
    }
}

// Pack bits LSB-first per byte (D-Star voice convention,
// dstar_phase.cpp:81-85).
void dh_pack_bits_lsb(const uint8_t* in, size_t n, uint8_t* out) {
    size_t nbytes = (n + 7) / 8;
    memset(out, 0, nbytes);
    for (size_t i = 0; i < n; i++) {
        out[i / 8] |= (uint8_t) ((in[i] & 1) << (i % 8));
    }
}

// Unpack dibits from MSB-first packed bytes.
void dh_unpack_dibits(const uint8_t* in, size_t n_dibits, uint8_t* out) {
    for (size_t i = 0; i < n_dibits; i++) {
        out[i] = (uint8_t) ((in[i / 4] >> (6 - 2 * (i % 4))) & 3);
    }
}

// ---------------------------------------------------------------- viterbi
// 16-state rate-1/2 Viterbi (K=5) with the protocol family's exact
// semantics: state = last 4 decoded bits (newest in MSB), branch metric =
// popcount of dibit XOR, k=0 predecessor wins metric ties, lowest final
// state wins the final selection, optional NXDN blocked start states
// (rotating mask over the first 4 steps). Mirrors fec/viterbi.py; the
// Python layer (fec/viterbi.py::viterbi_decode_np) dispatches 1-D decodes
// here.
static const uint8_t vit_transitions16[16][2] = {
    {0, 3}, {3, 0}, {2, 1}, {1, 2}, {1, 2}, {2, 1}, {3, 0}, {0, 3},
    {1, 2}, {2, 1}, {3, 0}, {0, 3}, {0, 3}, {3, 0}, {2, 1}, {1, 2},
};

int64_t dh_viterbi(const uint8_t* dibits, int64_t T, int32_t num_states,
                   int32_t blocked_steps, uint8_t* out_bits) {
    const int S = num_states;            // 4 or 16
    const int bits_per_state = (S == 16) ? 4 : 2;
    int32_t metrics[16];
    int32_t next_metrics[16];
    // decisions packed: one byte per (t, state)
    uint8_t* decisions = (uint8_t*) malloc((size_t) T * S);
    if (!decisions) return -1;
    for (int i = 0; i < S; i++) metrics[i] = 0;
    int blocked = blocked_steps ? (S - 1) : 0;
    for (int64_t t = 0; t < T; t++) {
        const int ob = dibits[t] & 3;
        for (int i = 0; i < S; i++) {
            const int outbit = (i >> (bits_per_state - 1)) & 1;
            const int p0 = (i << 1) & (S - 2);
            const int p1 = p0 | 1;
            const int d0 = popcount8((uint8_t) (ob ^ vit_transitions16[p0][outbit]));
            const int32_t m0 = metrics[p0] + d0;
            int take1 = 0;
            int32_t best = m0;
            if (!(blocked_steps && (i & blocked))) {
                const int d1 = popcount8((uint8_t) (ob ^ vit_transitions16[p1][outbit]));
                const int32_t m1 = metrics[p1] + d1;
                if (m1 < m0) { best = m1; take1 = 1; }
            }
            next_metrics[i] = best;
            decisions[t * S + i] = (uint8_t) take1;
        }
        for (int i = 0; i < S; i++) metrics[i] = next_metrics[i];
        blocked = (blocked << 1) & (S - 1);
    }
    int state = 0;
    int32_t best_metric = metrics[0];
    for (int i = 1; i < S; i++) {
        if (metrics[i] < best_metric) { best_metric = metrics[i]; state = i; }
    }
    for (int64_t t = T - 1; t >= 0; t--) {
        out_bits[t] = (uint8_t) ((state >> (bits_per_state - 1)) & 1);
        state = ((state << 1) & (S - 2)) | decisions[t * S + state];
    }
    free(decisions);
    return best_metric;
}

// -------------------------------------------------------------- ringbuffer
// SPSC byte ring buffer: one ingest thread writes, one dispatch thread
// reads. Capacity must be a power of two.
// named to match the opaque forward declaration in include/digiham_native.h
typedef struct dh_ringbuffer {
    uint8_t* data;
    size_t capacity;   // power of 2
    size_t mask;
    std::atomic<uint64_t> head;  // write position (total bytes written)
    std::atomic<uint64_t> tail;  // read position (total bytes consumed)
} dh_ringbuffer;

dh_ringbuffer* dh_rb_create(size_t capacity) {
    // round up to power of 2
    size_t cap = 1;
    while (cap < capacity) cap <<= 1;
    dh_ringbuffer* rb = new dh_ringbuffer();
    rb->data = (uint8_t*) malloc(cap);
    if (!rb->data) { delete rb; return nullptr; }
    rb->capacity = cap;
    rb->mask = cap - 1;
    rb->head.store(0);
    rb->tail.store(0);
    return rb;
}

void dh_rb_destroy(dh_ringbuffer* rb) {
    if (!rb) return;
    free(rb->data);
    delete rb;
}

uint64_t dh_rb_available(dh_ringbuffer* rb) {
    return rb->head.load(std::memory_order_acquire)
         - rb->tail.load(std::memory_order_acquire);
}

uint64_t dh_rb_writeable(dh_ringbuffer* rb) {
    return rb->capacity - dh_rb_available(rb);
}

// Returns bytes actually written (may be < n when full).
uint64_t dh_rb_write(dh_ringbuffer* rb, const uint8_t* src, uint64_t n) {
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    uint64_t tail = rb->tail.load(std::memory_order_acquire);
    uint64_t space = rb->capacity - (head - tail);
    if (n > space) n = space;
    for (uint64_t i = 0; i < n; ) {
        size_t pos = (size_t) ((head + i) & rb->mask);
        size_t run = rb->capacity - pos;
        if (run > n - i) run = (size_t) (n - i);
        memcpy(rb->data + pos, src + i, run);
        i += run;
    }
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

// Copy up to n available bytes into dst without consuming. Returns count.
uint64_t dh_rb_peek(dh_ringbuffer* rb, uint8_t* dst, uint64_t n) {
    uint64_t head = rb->head.load(std::memory_order_acquire);
    uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    uint64_t avail = head - tail;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; ) {
        size_t pos = (size_t) ((tail + i) & rb->mask);
        size_t run = rb->capacity - pos;
        if (run > n - i) run = (size_t) (n - i);
        memcpy(dst + i, rb->data + pos, run);
        i += run;
    }
    return n;
}

// Consume (discard) n bytes. Returns bytes actually consumed.
uint64_t dh_rb_consume(dh_ringbuffer* rb, uint64_t n) {
    uint64_t head = rb->head.load(std::memory_order_acquire);
    uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    uint64_t avail = head - tail;
    if (n > avail) n = avail;
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

// -------------------------------------------------- interleaved deframing
// Split an interleaved multi-channel float stream [n_frames x channels]
// into per-channel contiguous planes — the ingest transform in front of
// the [channels, block] device layout.
void dh_deinterleave_f32(const float* in, size_t n_frames, size_t channels,
                         float* out /* [channels][n_frames] */) {
    for (size_t c = 0; c < channels; c++) {
        const float* src = in + c;
        float* dst = out + c * n_frames;
        for (size_t t = 0; t < n_frames; t++) {
            dst[t] = src[t * channels];
        }
    }
}

}  // extern "C"
