"""The port's 16-state Viterbi (``viterbi_decode_plain``, the plain
version of kernel K5) against the JAX package's three decoders: the XLA
scan, the Pallas kernel in interpret mode and the numpy oracle. The cases
are those of tests/test_viterbi_pallas.py. All arithmetic is integer, so
bits and metrics must be exactly equal, both tie rules included (k=0 wins
equal metrics; the lowest-numbered final state wins).

Also here: ``viterbi_decode_many`` (several batches, one launch of K5 on the
card; on the CPU the plain version per segment) against the same decoders
per segment, on int64, int32, uint8 and strided inputs; a numpy emulation of
the kernel's lane algorithm (a trellis state per lane, predecessors by
shuffles, a ballot word per step, the final state from the key ``(metric <<
4) | state``, the traceback from the ballot words) against the plain
version; and what the wrapper refuses before it would launch. Tolerance:
none, everything is integer (``array_equal`` / ``torch.equal``)."""
import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from digiham_tpu.fec import viterbi as j_viterbi
from digiham_tpu.ops.viterbi_pallas import viterbi_decode_pallas
from digiham_tpu_torch.fec import viterbi
from digiham_tpu_torch.ops import viterbi as k5

torch.set_num_threads(1)


def _noisy(rng, shape, rate, leading_zeros=0):
    bits = rng.integers(0, 2, shape)
    bits[..., :leading_zeros] = 0
    obs = viterbi.conv_encode(bits)
    flips = rng.random(obs.shape) < rate
    return np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs), bits


def _case(name):
    """-> (observed, blocked_steps, transmitted bits or None)."""
    kind, _, arg = name.partition(":")
    arg = int(arg or 0)
    rng = np.random.default_rng(1000 + arg)
    if kind == "clean":  # batches across the TPU kernel's padding edges
        obs, bits = _noisy(np.random.default_rng(arg), (arg, 100), 0.0)
        return obs, 0, bits
    if kind == "noisy":
        return _noisy(rng, (37, 100), 0.12)[0], 0, None
    if kind == "pure_noise":  # uniform dibits maximise metric ties
        return rng.integers(0, 4, (64, 100)), 0, None
    if kind == "constant":  # every path equal: the lowest state must win
        return np.full((4, 48), arg, np.int64), 0, None
    if kind == "blocked":  # NXDN's 4 known leading zeros
        return _noisy(rng, (30, 30), 0.1, leading_zeros=4)[0], 4, None
    if kind == "blocked_sacch_facch1":
        return _noisy(rng, (12, arg), 0.08, leading_zeros=4)[0], 4, None
    if kind == "multidim":
        return rng.integers(0, 4, (3, 4, 60)), 0, None
    if kind == "shorter_than_blocked_window":
        return rng.integers(0, 4, (5, arg)), 4, None
    raise AssertionError(name)


CASES = (["clean:1", "clean:5", "clean:128", "clean:129",
          "noisy:0", "noisy:1", "noisy:2", "pure_noise",
          "constant:0", "constant:3", "blocked:0", "blocked:1",
          "blocked_sacch_facch1:36", "blocked_sacch_facch1:96", "multidim"]
         + [f"shorter_than_blocked_window:{t}" for t in (1, 2, 3)])


@pytest.mark.parametrize("name", CASES)
def test_plain_viterbi_matches_jax(name):
    obs, blocked, sent = _case(name)
    got_b, got_m = viterbi.viterbi_decode_plain(torch.from_numpy(obs), 16,
                                                blocked)
    assert got_b.dtype == torch.int32 and got_m.dtype == torch.int32
    assert got_b.shape == obs.shape and got_m.shape == obs.shape[:-1]
    references = {
        "xla": j_viterbi.viterbi_decode(obs, 16, blocked, impl="xla"),
        "pallas_interpret": viterbi_decode_pallas(obs, 16, blocked,
                                                  interpret=True),
        "numpy": j_viterbi.viterbi_decode_np(obs, 16, blocked),
    }
    for ref, (want_b, want_m) in references.items():
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b), ref)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m), ref)
    if sent is not None:
        np.testing.assert_array_equal(got_b.numpy(), sent)
        assert not got_m.numpy().any()


def test_conv_encode_matches_jax():
    bits = np.random.default_rng(5).integers(0, 2, (3, 7, 40))
    np.testing.assert_array_equal(viterbi.conv_encode(bits),
                                  j_viterbi.conv_encode(bits, 16))


def test_wrapper_routes_cpu_to_plain_and_launches_nothing():
    obs = torch.from_numpy(np.random.default_rng(6).integers(0, 4, (9, 36)))
    before = k5.LAUNCHES
    got = viterbi.viterbi_decode(obs, 16, 4)
    want = viterbi.viterbi_decode_plain(obs, 16, 4)
    assert k5.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rejects_what_is_not_ported():
    """4 states are ported now (their parity: test_plain_viterbi_4_states_
    matches_jax); what stays refused: another number of states, a blocked
    start the reference never uses, a device with no kernel."""
    obs = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="num_states"):
        viterbi.viterbi_decode(obs, num_states=8)
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi_decode(obs, blocked_steps=2)
    with pytest.raises(ValueError, match="no K5 kernel"):
        viterbi.viterbi_decode(torch.zeros((2, 10), dtype=torch.int32,
                                           device="meta"))


def test_packed_expected_dibits_follow_the_branch_table():
    """The two words the wrapper hands kernel K5 hold the expected dibit
    of each (new state, k) branch, 2 bits per state."""
    _, expected = viterbi._branch_tables(16, viterbi.TRANSITIONS_16)
    e0, e1 = k5._packed_expected()
    assert 0 <= e0 < 1 << 32 and 0 <= e1 < 1 << 32
    for i in range(16):
        assert (e0 >> (2 * i)) & 3 == expected[i, 0]
        assert (e1 >> (2 * i)) & 3 == expected[i, 1]


@pytest.mark.parametrize("t", range(6))
def test_blocked_mask_is_the_reference_rotation(t):
    """blocked_mask(t, 4) reproduces the rotating mask the JAX package
    builds for its scan (fec/viterbi.py)."""
    blocked = 15
    for _ in range(t):
        blocked = (blocked << 1) & 15
    assert viterbi.blocked_mask(t, 4) == (blocked if t < 4 else 0)
    assert viterbi.blocked_mask(t, 0) == 0


# --- the fused entry ------------------------------------------------------

def _kind(rng, kind, batch, T, blocked):
    if kind == "noisy":
        return _noisy(rng, (batch, T), 0.12, leading_zeros=blocked)[0]
    if kind == "pure_noise":
        return rng.integers(0, 4, (batch, T))
    return np.full((batch, T), int(kind[-1]), np.int64)  # constant0/3


SEGMENTS = [(100, 0), (36, 4), (96, 4)]


@pytest.mark.parametrize("layout", ["int64", "int32", "uint8", "strided"])
@pytest.mark.parametrize("kind", ["noisy", "pure_noise", "constant0",
                                  "constant3"])
def test_decode_many_matches_jax_per_segment(kind, layout):
    """Three segments of different length and start in one call: each
    equals the JAX package's XLA scan and its Pallas kernel in interpret
    mode on that segment alone; nothing launches on the CPU."""
    rng = np.random.default_rng(len(kind) + len(layout))
    arrays = [_kind(rng, kind, 7 + 3 * n, T, blocked)
              for n, (T, blocked) in enumerate(SEGMENTS)]
    segments = []
    for obs, (T, blocked) in zip(arrays, SEGMENTS):
        if layout == "strided":  # rows of a wider uint8 array
            wide = np.concatenate([obs ^ 1, obs, obs ^ 2], axis=1)
            t = torch.from_numpy(wide.astype(np.uint8))[:, T:2 * T]
            assert not t.is_contiguous()
        else:
            t = torch.from_numpy(obs.astype(layout))
        segments.append((t, blocked))
    before = k5.LAUNCHES
    got = viterbi.viterbi_decode_many(segments)
    assert k5.LAUNCHES == before and len(got) == len(SEGMENTS)
    for obs, (T, blocked), (got_b, got_m) in zip(arrays, SEGMENTS, got):
        assert got_b.dtype == torch.int32 and got_m.dtype == torch.int32
        assert got_b.shape == obs.shape and got_m.shape == obs.shape[:-1]
        for want_b, want_m in (
                j_viterbi.viterbi_decode(obs, 16, blocked, impl="xla"),
                viterbi_decode_pallas(obs, 16, blocked, interpret=True)):
            np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
            np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_decode_many_takes_any_leading_shape_and_no_segment():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(0, 4, (2, 3, 36)))
    b = torch.from_numpy(rng.integers(0, 4, (2, 3, 2, 96)).astype(np.uint8))
    (a_bits, a_metric), (b_bits, b_metric) = viterbi.viterbi_decode_many(
        [(a, 4), (b, 4)])
    assert a_bits.shape == (2, 3, 36) and a_metric.shape == (2, 3)
    assert b_bits.shape == (2, 3, 2, 96) and b_metric.shape == (2, 3, 2)
    for got, obs in ((a_bits, a), (b_bits, b)):
        assert torch.equal(got, viterbi.viterbi_decode_plain(obs, 16, 4)[0])
    assert viterbi.viterbi_decode_many([]) == []
    (c_bits, c_metric), = viterbi.viterbi_decode_many([(a, 2)], num_states=4)
    assert torch.equal(c_bits, viterbi.viterbi_decode_plain(a, 4, 2)[0])
    with pytest.raises(ValueError, match="num_states"):
        viterbi.viterbi_decode_many([(a, 4)], num_states=8)
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi_decode_many([(a, 4)], num_states=4)
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi_decode_many([(a, 2)])
    with pytest.raises(ValueError, match="segments on"):
        viterbi.viterbi_decode_many([(a, 4), (b.to("meta"), 4)])


# --- the kernel's lane algorithm, emulated --------------------------------

def _lane_decode(obs: np.ndarray, blocked: int, S: int = 16):
    """csrc/viterbi.cu in numpy: a warp of 32 lanes carries 32 / S
    sequences, lane ``S * g + i`` holds state i of the warp's sequence g;
    predecessors come from lanes p and p | 1 of the same sequence
    (``__shfl_sync`` of width S); a step's decisions are one 32-bit ballot
    word; the final state is the minimum of ``(metric << log2 S) | state``
    over the sequence's lanes; the traceback reads bit ``S * g + state``
    of each word."""
    B, T = obs.shape
    per = 32 // S
    bits_ = S.bit_length() - 1
    warps = (B + per - 1) // per
    rows = np.zeros((per * warps, T), np.int64)
    rows[:B] = obs
    rows = rows.reshape(warps, per, T)
    e0, e1 = k5._packed_expected(S)
    lane = np.arange(32)
    g, i = lane // S, lane % S
    p = (i << 1) & (S - 2)
    exp0, exp1 = (e0 >> (2 * i)) & 3, (e1 >> (2 * i)) & 3
    src0, src1 = S * g + p, S * g + (p | 1)

    def distance(x):
        return (x & 1) + (x >> 1)

    m = np.zeros((warps, 32), np.int64)
    words = np.zeros((warps, T), np.uint64)
    for t in range(T):
        d = rows[:, g, t]
        cand0 = m[:, src0] + distance(exp0 ^ d)
        cand1 = m[:, src1] + distance(exp1 ^ d)
        if t < blocked:
            cand1 = np.where(i & ((S - 1) << t) & (S - 1), viterbi.BIG,
                             cand1)
        take1 = cand1 < cand0
        m = np.where(take1, cand1, cand0)
        words[:, t] = (take1.astype(np.uint64) << lane.astype(np.uint64)
                       ).sum(axis=1)
    key = ((m << bits_) | i).reshape(warps, per, S).min(axis=2)
    metric, state = key >> bits_, key & (S - 1)
    low = S * np.arange(per)
    bits = np.zeros((warps, per, T), np.int64)
    for u in range(T - 1, -1, -1):
        bits[:, :, u] = state >> (bits_ - 1)
        k = (words[:, u, None].astype(np.int64) >> (low + state)) & 1
        state = ((state << 1) & (S - 2)) | k
    return (bits.reshape(per * warps, T)[:B].astype(np.int32),
            metric.reshape(per * warps)[:B].astype(np.int32))


@pytest.mark.parametrize("T,blocked", SEGMENTS + [(1, 0), (1, 4), (2, 4),
                                                  (3, 4), (5, 0)])
@pytest.mark.parametrize("kind", ["noisy", "pure_noise", "constant0",
                                  "constant3"])
def test_lane_algorithm_is_the_plain_version(kind, T, blocked):
    """Ties included: pure noise and constant inputs make equal candidate
    and equal final metrics, where k = 0 and the lowest state must win."""
    rng = np.random.default_rng(T + blocked + len(kind))
    obs = _kind(rng, kind, 9, T, min(blocked, T))  # odd: a half-filled warp
    got_b, got_m = _lane_decode(obs, blocked)
    want_b, want_m = viterbi.viterbi_decode_plain(torch.from_numpy(obs), 16,
                                                  blocked)
    np.testing.assert_array_equal(got_b, want_b.numpy())
    np.testing.assert_array_equal(got_m, want_m.numpy())


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2 * k5.MAX_STEPS), min_size=16, max_size=16))
def test_key_minimum_is_the_lowest_numbered_minimal_state(metrics):
    """min over (metric << 4) | state gives the least metric and, among
    equal metrics, the lowest state, at every metric a sequence of up to
    MAX_STEPS steps can reach; the key stays inside int32."""
    m = np.array(metrics, np.int64)
    key = ((m << 4) | np.arange(16)).min()
    assert key < 2 ** 31
    assert key >> 4 == m.min() and key & 15 == int(np.argmin(m))


# --- what the wrapper checks before a launch -------------------------------

def test_rows_are_passed_as_they_are():
    """No copy, no conversion: the kernel gets the tensor's own memory, its
    element size and its row stride."""
    wide = torch.zeros((6, 300), dtype=torch.uint8)
    view = wide[:, 100:200]
    flat, size, stride, batch, T = k5._rows(view, 0)
    assert flat.data_ptr() == view.data_ptr()
    assert (size, stride, batch, T) == (1, 300, 6, 100)
    frames = torch.zeros((4, 5, 36), dtype=torch.int32)
    flat, size, stride, batch, T = k5._rows(frames, 4)
    assert flat.data_ptr() == frames.data_ptr()
    assert (size, stride, batch, T) == (4, 36, 20, 36)
    assert k5._rows(torch.zeros(7, dtype=torch.int64), 0)[1:] == (8, 7, 1, 7)
    # leading dimensions that fold into one row stride
    assert k5._rows(torch.zeros((4, 5, 480), dtype=torch.uint8)[..., 20:120],
                    0)[1:] == (1, 480, 20, 100)


@pytest.mark.parametrize("bad", ["float", "bool", "int16", "too_long",
                                 "empty_steps", "inner_stride", "unfoldable",
                                 "blocked"])
def test_rows_refuse_what_the_kernel_does_not_take(bad):
    obs = torch.zeros((4, 6, 40), dtype=torch.int32)
    blocked = 0
    if bad == "float":
        obs = obs.float()
    elif bad == "bool":
        obs = obs.bool()
    elif bad == "int16":
        obs = obs.to(torch.int16)
    elif bad == "too_long":
        obs = torch.zeros((1, k5.MAX_STEPS + 1), dtype=torch.uint8)
    elif bad == "empty_steps":
        obs = obs[..., :0]
    elif bad == "inner_stride":
        obs = obs[..., ::2]
    elif bad == "unfoldable":
        obs = obs[:, :4, :]
    else:
        blocked = 2
    with pytest.raises(ValueError):
        k5._rows(obs, blocked)


def test_shared_memory_limit_and_constants_follow_the_source():
    from digiham_tpu_torch.ops.build import SMEM_LIMIT

    assert k5.smem_bytes(100) == 4 * k5.WARPS * 100 + k5.SEQS * 100
    assert k5.smem_bytes(k5.MAX_STEPS) <= SMEM_LIMIT
    assert k5.smem_bytes(k5.MAX_STEPS + 1) > SMEM_LIMIT
    source = (k5.library.__globals__["CSRC"] / k5.SOURCE).read_text()
    for name, value in (("WARPS", k5.WARPS), ("MAX_SEGMENTS",
                                               k5.MAX_SEGMENTS)):
        assert f"constexpr int {name} = {value};" in source
    # the many-batch entry's packed fields and its argument types
    assert f"fields + {k5.SEGMENT_FIELDS} * k" in source
    assert len(k5._SIGNATURES["digiham_viterbi16_many"]) == 5
    assert k5._SIGNATURES["digiham_viterbi16_many"][0] is ctypes.c_void_p


# --- 4 states: the D-Star header code --------------------------------------

def _case4(kind, seed, T, blocked):
    """4-state inputs: noisy encoded sequences (leading zeros under a
    blocked start), pure noise (ties) and constants."""
    rng = np.random.default_rng(4000 + seed)
    if kind == "noisy":
        bits = rng.integers(0, 2, (9, T))
        bits[:, :blocked] = 0
        obs = viterbi.conv_encode(bits, 4)
        flips = rng.random(obs.shape) < 0.1
        return np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)
    if kind == "pure_noise":
        return rng.integers(0, 4, (9, T))
    return np.full((3, T), 3 * (seed % 2), np.int64)


@pytest.mark.parametrize("blocked", [0, 2])
@pytest.mark.parametrize("T", [1, 2, 3, 36, 100, 330])
@pytest.mark.parametrize("kind,seed", [("noisy", 0), ("noisy", 1),
                                       ("pure_noise", 2), ("pure_noise", 3),
                                       ("constant", 4), ("constant", 5)])
def test_plain_viterbi_4_states_matches_jax(kind, seed, T, blocked):
    """The port's plain version at 4 states against the JAX package's XLA
    scan and its numpy decode (batched), and the port's own numpy decode;
    exact, ties included."""
    obs = _case4(kind, seed, T, blocked)
    got_b, got_m = viterbi.viterbi_decode_plain(torch.from_numpy(obs), 4,
                                                blocked)
    assert got_b.dtype == torch.int32 and got_b.shape == obs.shape
    for ref, (want_b, want_m) in {
            "xla": j_viterbi.viterbi_decode(obs, 4, blocked),
            "numpy": j_viterbi.viterbi_decode_np(obs, 4, blocked),
            "port numpy": viterbi.viterbi_decode_np(obs, 4, blocked)}.items():
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b), ref)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m), ref)
    # the entry a caller uses takes it for CPU tensors, launching nothing
    before = k5.LAUNCHES
    bits, metric = viterbi.viterbi_decode(torch.from_numpy(obs), 4, blocked)
    assert k5.LAUNCHES == before
    assert torch.equal(bits, got_b) and torch.equal(metric, got_m)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("states,blocked", [(16, 0), (16, 4), (4, 0),
                                            (4, 2)])
def test_decode_np_sends_one_sequence_to_the_native_library(
        monkeypatch, states, blocked, seed):
    """viterbi_decode_np: a 1-D sequence goes to native.viterbi (as the
    JAX package's does), a batch to the numpy decode; both equal the JAX
    package's viterbi_decode_np."""
    from digiham_tpu_torch import native

    rng = np.random.default_rng(50 + seed)
    T = {16: 100, 4: 330}[states]
    obs = rng.integers(0, 4, (3, T))
    calls = []
    real = native.viterbi

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(native, "viterbi", counted)
    for row in obs:
        bits, metric = viterbi.viterbi_decode_np(row, states, blocked)
        want_b, want_m = j_viterbi.viterbi_decode_np(row, states, blocked)
        assert bits.dtype == np.int64 and isinstance(metric, np.int64)
        np.testing.assert_array_equal(bits, want_b)
        assert metric == want_m
    assert len(calls) == len(obs)
    bits, metric = viterbi.viterbi_decode_np(obs, states, blocked)
    assert len(calls) == len(obs)  # the batch stays on numpy
    want_b, want_m = j_viterbi.viterbi_decode_np(obs, states, blocked)
    np.testing.assert_array_equal(bits, want_b)
    np.testing.assert_array_equal(metric, want_m)


@pytest.mark.parametrize("T,blocked", [(330, 0), (330, 2), (1, 0), (1, 2),
                                       (2, 2), (3, 2), (5, 0), (100, 2)])
@pytest.mark.parametrize("kind", ["noisy", "pure_noise", "constant0",
                                  "constant3"])
def test_lane_algorithm_4_states_is_the_plain_version(kind, T, blocked):
    """The kernel's 4-state instance: 4 lanes a sequence, 8 sequences a
    warp, a 4-bit field of the ballot word each; 19 sequences leave the
    last warp part-filled."""
    rng = np.random.default_rng(T + blocked + len(kind))
    if kind == "noisy":
        bits = rng.integers(0, 2, (19, T))
        bits[:, :blocked] = 0
        obs = viterbi.conv_encode(bits, 4)
        obs = np.where(rng.random(obs.shape) < 0.1,
                       obs ^ rng.integers(1, 4, obs.shape), obs)
    else:
        obs = _kind(rng, kind, 19, T, 0)
    got_b, got_m = _lane_decode(obs, blocked, S=4)
    want_b, want_m = viterbi.viterbi_decode_plain(torch.from_numpy(obs), 4,
                                                  blocked)
    np.testing.assert_array_equal(got_b, want_b.numpy())
    np.testing.assert_array_equal(got_m, want_m.numpy())


def test_4_state_tables_and_limits():
    """The packed expected dibits of the 4-state instance, its blocked
    mask, and its shared-memory limit (16 sequences a block)."""
    from digiham_tpu_torch.ops.build import SMEM_LIMIT

    _, expected = viterbi._branch_tables(4, viterbi.TRANSITIONS_4)
    e0, e1 = k5._packed_expected(4)
    assert e0 < 1 << 8 and e1 < 1 << 8
    for i in range(4):
        assert (e0 >> (2 * i)) & 3 == expected[i, 0]
        assert (e1 >> (2 * i)) & 3 == expected[i, 1]
    assert [viterbi.blocked_mask(t, 2, 4) for t in range(4)] == [3, 2, 0, 0]
    assert k5.seqs(4) == 16 and k5.seqs(16) == k5.SEQS == 4
    assert k5.smem_bytes(k5.max_steps(4), 4) <= SMEM_LIMIT
    assert k5.smem_bytes(k5.max_steps(4) + 4, 4) > SMEM_LIMIT
    assert k5.max_steps(16) == k5.MAX_STEPS
    assert k5._rows(torch.zeros((3, 330), dtype=torch.uint8), 2, 4)[1:] \
        == (1, 330, 3, 330)
    with pytest.raises(ValueError, match="steps"):
        k5._rows(torch.zeros((1, k5.max_steps(4) + 1), dtype=torch.uint8),
                 0, 4)
    with pytest.raises(ValueError, match="blocked_steps"):
        k5._rows(torch.zeros((1, 10), dtype=torch.uint8), 4, 4)
    source = (k5.library.__globals__["CSRC"] / k5.SOURCE).read_text()
    for name in k5._SIGNATURES:
        assert f'extern "C" int {name}(' in source
