"""Viterbi decode of the rate-1/2 convolutional codes (port of
``digiham_tpu/fec/viterbi.py``).

Three protocol variants share one engine (reference behaviour):
- YSF 16-state K=5 (src/ysf_decoder/trellis.c:8-109)
- NXDN 16-state K=5 with blocked start states exploiting 4 known leading
  zeros (src/nxdn_decoder/trellis.cpp:29-101)
- D-Star 4-state K=3 (src/dstar_decoder/header.cpp:76-146)

State = the last ``B`` decoded bits (B = 4 or 2), newest in the MSB. A
transition from previous state ``p`` with decoded bit ``b`` emits
``TRANSITIONS[p][b]`` and lands in state ``(b << (B - 1)) | (p >> 1)``.
The tie rules are the reference's: the predecessor with LSB 0 wins equal
metrics (a strict ``cand1 < cand0``), and the lowest-numbered final state
wins the final selection. Metrics are int32 (the reference YSF decoder's
uint8 can wrap on frames with more than 255 bit errors; such frames fail
the CRC either way).

:func:`viterbi_decode_plain` is the plain PyTorch version: a loop over T
batched over sequences. :func:`viterbi_decode` takes it for CPU tensors
and kernel K5 (ops/viterbi.py) for CUDA tensors; :func:`viterbi_decode_many`
decodes several batches of different length and start in one launch of K5
(a frame's FICH and DCH, or its SACCH and FACCH1 slots); all three take 16
or 4 states.

:func:`viterbi_decode_np` is the host decode the phase machines run on one
frame's field at a time (YSF, NXDN, and the 4-state D-Star header code,
``TRANSITIONS_4``): a 1-D sequence goes to the native library
(``native.viterbi``, C++ built at first use), a batch to
:func:`viterbi_decode_np_plain`, a copy of the JAX package's numpy path;
int64 metrics, the same tie rules either way.
"""
from __future__ import annotations

import numpy as np
import torch

# Expected dibit emitted when leaving ``previous state`` (row) with
# decoded bit 0 / 1 (column). Identical in the YSF spec Appendix B and
# NXDN (trellis.c:8-25, trellis.cpp:10-27).
TRANSITIONS_16 = np.array(
    [
        [0b00, 0b11], [0b11, 0b00], [0b10, 0b01], [0b01, 0b10],
        [0b01, 0b10], [0b10, 0b01], [0b11, 0b00], [0b00, 0b11],
        [0b01, 0b10], [0b10, 0b01], [0b11, 0b00], [0b00, 0b11],
        [0b00, 0b11], [0b11, 0b00], [0b10, 0b01], [0b01, 0b10],
    ],
    dtype=np.int32,
)

# D-Star 4-state table (header.cpp:76-81): the first 4 rows.
TRANSITIONS_4 = TRANSITIONS_16[:4].copy()

NUM_STATES = 16
BIG = 1 << 28  # a blocked k=1 candidate; far above any reachable metric


def _check_blocked_steps(num_states: int, blocked_steps: int) -> None:
    """The NXDN rotating start-state mask extinguishes itself after
    ``bits_per_state`` steps; accepting only 0 or ``bits_per_state`` keeps
    every decode path equal (nxdn trellis.cpp:34 always blocks the 4 known
    leading zeros)."""
    bits_per_state = num_states.bit_length() - 1
    if blocked_steps not in (0, bits_per_state):
        raise ValueError(
            f"blocked_steps must be 0 or {bits_per_state} for "
            f"{num_states}-state decode, got {blocked_steps}")


def _branch_tables(num_states: int, transitions: np.ndarray):
    """Per (new_state, k): the predecessor state and the expected dibit."""
    bits = num_states.bit_length() - 1
    prev = np.zeros((num_states, 2), dtype=np.int32)
    expected = np.zeros((num_states, 2), dtype=np.int32)
    for i in range(num_states):
        outbit = (i >> (bits - 1)) & 1
        for k in range(2):
            p = ((i << 1) & (num_states - 2)) | k
            prev[i, k] = p
            expected[i, k] = transitions[p][outbit]
    return prev, expected


def blocked_mask(t: int, blocked_steps: int,
                 num_states: int = NUM_STATES) -> int:
    """At step ``t`` new state ``i`` may take its k=1 predecessor iff
    ``i & blocked_mask(t) == 0``: the rotating mask of trellis.cpp:34,
    56-57, 84-85 (0 once ``t >= blocked_steps``)."""
    full = num_states - 1
    return (full << t) & full if t < blocked_steps else 0


def _transitions(num_states: int) -> np.ndarray:
    if num_states not in (4, 16):
        raise ValueError(f"num_states must be 4 or 16, got {num_states}")
    return TRANSITIONS_16 if num_states == 16 else TRANSITIONS_4


def conv_encode(bits, num_states: int = NUM_STATES) -> np.ndarray:
    """Encoder (numpy; test vectors and fixtures): bits [..., T] ->
    dibits [..., T], 16 or 4 states."""
    transitions = _transitions(num_states)
    bits_per_state = num_states.bit_length() - 1
    bits = np.asarray(bits, dtype=np.int64)
    out = np.zeros_like(bits)
    flat_b = bits.reshape(-1, bits.shape[-1])
    flat_o = out.reshape(-1, bits.shape[-1])
    for r in range(flat_b.shape[0]):
        state = 0
        for t in range(flat_b.shape[1]):
            b = int(flat_b[r, t])
            flat_o[r, t] = transitions[state][b]
            state = ((b << (bits_per_state - 1)) | (state >> 1)) \
                & (num_states - 1)
    return flat_o.reshape(bits.shape)


_POPCNT4 = np.array([0, 1, 1, 2], dtype=np.int64)


def viterbi_decode_np(observed, num_states: int = NUM_STATES,
                      blocked_steps: int = 0):
    """Host decode with the reference's exact tie rules (k=0 wins equal
    metrics, the lowest final state wins the final selection), 16 or 4
    states. observed: [..., T] dibits. Returns (bits [..., T] int64,
    metric [...] int64). A 1-D sequence runs the native library's decode
    (as the JAX package's does), a batch :func:`viterbi_decode_np_plain`;
    each checks the arguments."""
    obs = np.asarray(observed)
    if obs.ndim == 1:
        from .. import native

        bits, metric = native.viterbi(obs.astype(np.uint8), num_states,
                                      blocked_steps)
        return bits.astype(np.int64), np.int64(metric)
    return viterbi_decode_np_plain(obs, num_states, blocked_steps)


def viterbi_decode_np_plain(observed, num_states: int = NUM_STATES,
                            blocked_steps: int = 0):
    """The numpy decode, batched over the leading dimensions (the plain
    version of ``native.viterbi``); arguments and results as
    :func:`viterbi_decode_np`."""
    transitions = _transitions(num_states)
    _check_blocked_steps(num_states, blocked_steps)
    prev_tbl, exp_tbl = _branch_tables(num_states, transitions)
    obs = np.asarray(observed, dtype=np.int64)
    T = obs.shape[-1]
    flat = obs.reshape(-1, T)
    B = flat.shape[0]

    # per-step k=1 permission mask for blocked start states
    allow_k1 = np.ones((T, num_states), dtype=bool)
    if blocked_steps:
        blocked = num_states - 1
        for t in range(min(blocked_steps, T)):
            allow_k1[t] = (np.arange(num_states) & blocked) == 0
            blocked = (blocked << 1) & (num_states - 1)

    big = np.int64(1 << 40)  # a blocked candidate, in int64
    metrics = np.zeros((B, num_states), dtype=np.int64)
    decisions = np.zeros((T, B, num_states), dtype=np.int8)
    # dist[obs_val, state, k]
    dist_lut = _POPCNT4[np.arange(4)[:, None, None] ^ exp_tbl[None, :, :]]
    for t in range(T):
        dist = dist_lut[flat[:, t]]            # [B, S, 2]
        cand = metrics[:, prev_tbl.reshape(-1)].reshape(B, num_states, 2) \
            + dist
        cand1 = np.where(allow_k1[t], cand[:, :, 1], big)
        take1 = cand1 < cand[:, :, 0]          # strict: k=0 wins ties
        metrics = np.where(take1, cand1, cand[:, :, 0])
        decisions[t] = take1
    state = np.argmin(metrics, axis=-1)        # first index wins ties
    best_metric = metrics[np.arange(B), state]
    bits_per_state = num_states.bit_length() - 1
    out_bits = np.zeros((B, T), dtype=np.int64)
    rows = np.arange(B)
    for t in range(T - 1, -1, -1):
        out_bits[:, t] = state >> (bits_per_state - 1)
        k = decisions[t, rows, state]
        state = ((state << 1) & (num_states - 2)) | k
    return out_bits.reshape(obs.shape), best_metric.reshape(obs.shape[:-1])


def viterbi_decode_plain(observed: torch.Tensor, num_states: int = NUM_STATES,
                         blocked_steps: int = 0):
    """The plain version of K5. observed: [..., T] integer dibits (0-3)
    on any device, ``num_states`` 16 or 4. Returns (bits [..., T] int32,
    metric [...] int32)."""
    transitions = _transitions(num_states)
    _check_blocked_steps(num_states, blocked_steps)
    shift = num_states.bit_length() - 2  # the newest bit's place in a state
    dev = observed.device
    obs = observed.to(torch.int32)
    T = obs.shape[-1]
    flat = obs.reshape(-1, T)
    B = flat.shape[0]
    prev, expected = _branch_tables(num_states, transitions)
    prev = torch.as_tensor(prev, dtype=torch.int64, device=dev)
    expected = torch.as_tensor(expected, device=dev)
    states = torch.arange(num_states, device=dev)

    metrics = torch.zeros((B, num_states), dtype=torch.int32, device=dev)
    decisions = []
    for t in range(T):
        x = flat[:, t, None, None] ^ expected            # [B, S, 2]
        cand = metrics[:, prev] + (x & 1) + (x >> 1)      # 2-bit popcount
        cand0, cand1 = cand[..., 0], cand[..., 1]
        mask = blocked_mask(t, blocked_steps, num_states)
        if mask:
            cand1 = torch.where((states & mask) == 0, cand1, BIG)
        take1 = cand1 < cand0  # strict: k=0 wins ties
        metrics = torch.where(take1, cand1, cand0)
        decisions.append(take1)

    metric = metrics.amin(-1)
    # the lowest-numbered minimal final state
    state = (metrics == metric[:, None]).to(torch.int32).argmax(-1)
    bits = torch.empty((B, T), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = state >> shift
        k = decisions[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = ((state << 1) & (num_states - 2)) | k
    return bits.reshape(obs.shape), metric.reshape(obs.shape[:-1])


def viterbi_decode(observed: torch.Tensor, num_states: int = NUM_STATES,
                   blocked_steps: int = 0):
    """Decode a batch of rate-1/2 streams: observed [..., T] dibits ->
    (bits [..., T] int32, metric [...] int32), 16 or 4 states.
    ``blocked_steps=4`` is the NXDN prior-knowledge window (2 at 4 states).
    CPU tensors take the plain version; CUDA tensors launch kernel K5."""
    from ..ops.viterbi import viterbi16

    return viterbi16(observed, blocked_steps, num_states=num_states)


def viterbi_decode_many(segments, num_states: int = NUM_STATES):
    """Decode several batches at once: ``segments`` is a sequence of
    ``(observed [..., T] dibits, blocked_steps)``, each batch with its own
    shape, T and start; returns a list of ``(bits, metric)`` as
    :func:`viterbi_decode` gives them. CPU tensors take the plain version
    segment by segment; CUDA tensors launch kernel K5 once for all of
    them."""
    from ..ops.viterbi import viterbi16_many

    return viterbi16_many(segments, num_states=num_states)
