/* Public C API of the digiham_tpu_torch native host runtime (a copy of the
 * JAX package's digiham_tpu/native/include/digiham_native.h).
 *
 * The distro-consumable surface (the equivalent of the reference's
 * libdigiham0 + libdigiham-dev split, reference debian/control:11-31):
 * a plain C ABI over the host-side stream plumbing that sits around the
 * device: SPSC ring buffer, packing kernels, sync correlation, the
 * 16- and 4-state control-plane Viterbi, and ingest deframing. The Python
 * package consumes the same ABI via ctypes (digiham_tpu_torch/native/
 * __init__.py, which builds it at first use and has no fallback); C/C++
 * consumers link the CMake package exported from
 * digiham_tpu_torch/native/CMakeLists.txt as
 * `DigihamTpuTorchNative::digiham_tpu_torch_native`.
 */
#ifndef DIGIHAM_NATIVE_H
#define DIGIHAM_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ----------------------------------------------------------- correlation */

/* Hamming distance between two symbol arrays (bytewise popcount of XOR;
 * contract of the reference's hamming_distance.c). */
int32_t dh_hamming_distance(const uint8_t* a, const uint8_t* b, size_t n);

/* First offset in [0, n-plen] where pattern matches with distance
 * <= max_dist, or -1. */
int64_t dh_sync_scan(const uint8_t* data, size_t n, const uint8_t* pattern,
                     size_t plen, int32_t max_dist);

/* Dense distances at every offset; out has n-plen+1 entries. */
void dh_sync_distances(const uint8_t* data, size_t n, const uint8_t* pattern,
                       size_t plen, int32_t* out);

/* --------------------------------------------------------------- packing */

/* Pack dibits 4-per-byte MSB-first (DMR payload convention). out needs
 * (n+3)/4 bytes. */
void dh_pack_dibits(const uint8_t* in, size_t n, uint8_t* out);

/* Pack bits 8-per-byte MSB-first. out needs (n+7)/8 bytes. */
void dh_pack_bits_msb(const uint8_t* in, size_t n, uint8_t* out);

/* Pack bits LSB-first per byte (D-Star voice convention). */
void dh_pack_bits_lsb(const uint8_t* in, size_t n, uint8_t* out);

/* Unpack MSB-first packed bytes to one dibit per output byte. */
void dh_unpack_dibits(const uint8_t* in, size_t n_dibits, uint8_t* out);

/* --------------------------------------------------------------- viterbi */

/* 16-state (or 4-state) rate-1/2 Viterbi with the protocol family's
 * exact tie-break semantics (k=0 predecessor wins ties, lowest final
 * state wins) and optional NXDN blocked start states. Writes T decoded
 * bits to out_bits; returns the best final path metric, or -1 on
 * allocation failure. */
int64_t dh_viterbi(const uint8_t* dibits, int64_t T, int32_t num_states,
                   int32_t blocked_steps, uint8_t* out_bits);

/* ------------------------------------------------------------ ringbuffer */

/* Single-producer/single-consumer byte ring buffer (ingest thread ->
 * dispatch thread). Opaque handle; capacity rounds up to a power of 2. */
typedef struct dh_ringbuffer dh_ringbuffer;

dh_ringbuffer* dh_rb_create(size_t capacity);
void dh_rb_destroy(dh_ringbuffer* rb);
uint64_t dh_rb_available(dh_ringbuffer* rb);
uint64_t dh_rb_writeable(dh_ringbuffer* rb);
/* Returns bytes actually written (may be < n when full). */
uint64_t dh_rb_write(dh_ringbuffer* rb, const uint8_t* src, uint64_t n);
/* Copy up to n available bytes without consuming; returns count. */
uint64_t dh_rb_peek(dh_ringbuffer* rb, uint8_t* dst, uint64_t n);
/* Discard n bytes; returns bytes actually consumed. */
uint64_t dh_rb_consume(dh_ringbuffer* rb, uint64_t n);

/* -------------------------------------------------------------- deframing */

/* Split an interleaved [n_frames x channels] float stream into
 * per-channel contiguous planes (the ingest transform in front of the
 * [channels, block] device layout). out is [channels][n_frames]. */
void dh_deinterleave_f32(const float* in, size_t n_frames, size_t channels,
                         float* out);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* DIGIHAM_NATIVE_H */
