"""The port's host FEC twins, the numpy code the YSF and NXDN phase machines
run, against the JAX package's: ``viterbi_decode_np`` (16 and 4 states,
``blocked_steps`` 0/2/4, 1-D and batched, noisy and tie-heavy inputs, a
hypothesis property), the 16-state decode also against the port's torch
``viterbi_decode_plain``; the CRC bit packers, ``ysf_dch_header``,
``deinterleave``, ``depuncture``, ``dewhiten_bits`` and
``descramble_dibits_nxdn``. Everything is integer: equal or a failure."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from digiham_tpu.fec import crc as j_crc
from digiham_tpu.fec import interleave as j_interleave
from digiham_tpu.fec import lfsr as j_lfsr
from digiham_tpu.fec import viterbi as j_viterbi
from digiham_tpu_torch.fec import crc, interleave, lfsr, viterbi

torch.set_num_threads(1)


def _noisy(rng, shape, num_states, rate, blocked=0):
    bits = rng.integers(0, 2, shape)
    bits[..., :blocked] = 0
    obs = viterbi.conv_encode(bits, num_states)
    flips = rng.random(obs.shape) < rate
    return np.where(flips, obs ^ rng.integers(1, 4, obs.shape), obs)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape == np.shape(w)
        np.testing.assert_array_equal(g, w)


def test_conv_encode_matches_jax_at_both_state_counts():
    bits = np.random.default_rng(3).integers(0, 2, (4, 70))
    for states in (16, 4):
        np.testing.assert_array_equal(viterbi.conv_encode(bits, states),
                                      j_viterbi.conv_encode(bits, states))
    np.testing.assert_array_equal(viterbi.TRANSITIONS_4,
                                  j_viterbi.TRANSITIONS_4)


@pytest.mark.parametrize("states,blocked", [(16, 0), (16, 4), (4, 0),
                                            (4, 2)])
@pytest.mark.parametrize("kind", ["clean", "noisy", "noise", "constant"])
def test_viterbi_decode_np_matches_jax(states, blocked, kind):
    """Batched [5, 3, T] and 1-D inputs, with the blocked start where the
    code has one; noise and constant inputs are tie-heavy."""
    rng = np.random.default_rng(states * 10 + blocked)
    shape = (5, 3, 66)
    if kind == "clean":
        obs = _noisy(rng, shape, states, 0.0, blocked)
    elif kind == "noisy":
        obs = _noisy(rng, shape, states, 0.15, blocked)
    elif kind == "noise":
        obs = rng.integers(0, 4, shape)
    else:
        obs = np.full(shape, 3 if blocked else 1, np.int64)
    _same(viterbi.viterbi_decode_np(obs, states, blocked),
          j_viterbi.viterbi_decode_np(obs, states, blocked))
    for row in obs.reshape(-1, obs.shape[-1])[:4]:  # 1-D: JAX may go native
        _same(viterbi.viterbi_decode_np(row.astype(np.uint8), states,
                                        blocked),
              j_viterbi.viterbi_decode_np(row, states, blocked))


def test_viterbi_decode_np_clean_roundtrip_and_refusals():
    rng = np.random.default_rng(5)
    for states in (16, 4):
        bits = rng.integers(0, 2, (6, 50))
        bits[:, -4:] = 0
        got, metric = viterbi.viterbi_decode_np(
            viterbi.conv_encode(bits, states), states)
        np.testing.assert_array_equal(got, bits)
        assert not metric.any()
    with pytest.raises(ValueError, match="blocked_steps"):
        viterbi.viterbi_decode_np(np.zeros(8, np.int64), 16, 2)
    with pytest.raises(ValueError, match="num_states"):
        viterbi.viterbi_decode_np(np.zeros(8, np.int64), 8)


@pytest.mark.parametrize("blocked", [0, 4])
def test_viterbi_decode_np_matches_plain_torch(blocked):
    """At 16 states the host decode equals the port's torch plain version
    (the plain version of K5): the same bits and metrics."""
    rng = np.random.default_rng(40 + blocked)
    obs = np.concatenate([_noisy(rng, (20, 96), 16, 0.1, blocked),
                          rng.integers(0, 4, (20, 96))])
    bits, metric = viterbi.viterbi_decode_np(obs, 16, blocked)
    p_bits, p_metric = viterbi.viterbi_decode_plain(torch.from_numpy(obs),
                                                    16, blocked)
    np.testing.assert_array_equal(bits, p_bits.numpy())
    np.testing.assert_array_equal(metric, p_metric.numpy())


@settings(max_examples=60, deadline=None)
@given(st.sampled_from([(16, 0), (16, 4), (4, 0), (4, 2)]),
       st.lists(st.integers(0, 3), min_size=1, max_size=40),
       st.integers(0, 3))
def test_viterbi_decode_np_property(code, dibits, fill):
    """Any dibit sequence, short ones shorter than the blocked window
    included, padded with a constant run (ties): equal to JAX's."""
    states, blocked = code
    obs = np.asarray(dibits + [fill] * 8, np.int64)[None]
    _same(viterbi.viterbi_decode_np(obs, states, blocked),
          j_viterbi.viterbi_decode_np(obs, states, blocked))


def test_crc_bit_packers_match_jax():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (3, 7)).astype(np.uint8)
    bits = rng.integers(0, 2, (3, 56)).astype(np.uint8)
    for name, arg in (("bytes_to_bits_msb", data),
                      ("bytes_to_bits_lsb", data),
                      ("bits_to_bytes_msb", bits),
                      ("bits_to_bytes_lsb", bits)):
        got, want = getattr(crc, name)(arg), getattr(j_crc, name)(arg)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for nbits in (32, 80, 160):
        x = rng.integers(0, 2, (4, nbits))
        np.testing.assert_array_equal(crc.crc16_ysf(nbits).compute_np(x),
                                      j_crc.crc16_ysf(nbits).compute_np(x))


def test_interleave_host_helpers_match_jax():
    rng = np.random.default_rng(9)
    for block in (0, 1):
        got, want = (interleave.ysf_dch_header(block),
                     j_interleave.ysf_dch_header(block))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    payload = rng.integers(0, 4, (2, 360))
    np.testing.assert_array_equal(
        interleave.deinterleave(payload, interleave.ysf_dch_header(1)),
        j_interleave.deinterleave(payload, j_interleave.ysf_dch_header(1)))
    for mask in ("depuncture_mask_sacch", "depuncture_mask_facch1"):
        table, j_table = (getattr(interleave, mask)(),
                          getattr(j_interleave, mask)())
        bits = rng.integers(0, 2, (3, int(table[1].sum())))
        got = interleave.depuncture(bits, table)
        want = j_interleave.depuncture(bits, j_table)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_lfsr_host_helpers_match_jax():
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (2, 100)).astype(np.uint8)
    for offset in (0, 7):
        np.testing.assert_array_equal(
            lfsr.dewhiten_bits(bits, lfsr.ysf_whitening(), offset),
            j_lfsr.dewhiten_bits(bits, j_lfsr.ysf_whitening(), offset))
    dibits = rng.integers(0, 4, (3, 72)).astype(np.uint8)
    for offset in (0, 8, 38, 110):
        got = lfsr.descramble_dibits_nxdn(dibits, offset)
        want = j_lfsr.descramble_dibits_nxdn(dibits, offset)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
