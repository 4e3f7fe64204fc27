"""The port's 16-state Viterbi (``viterbi_decode_plain``, the plain
version of kernel K5) against the JAX package's three decoders: the XLA
scan, the Pallas kernel in interpret mode and the numpy oracle. The cases
are those of tests/test_viterbi_pallas.py. All arithmetic is integer, so
bits and metrics must be exactly equal, both tie rules included (k=0 wins
equal metrics; the lowest-numbered final state wins)."""
import numpy as np
import pytest
import torch

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
    obs = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-state"):
        viterbi.viterbi_decode(obs, num_states=4)
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
