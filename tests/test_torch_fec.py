"""The port's FEC and sync correlation against the JAX package's: block
code decode (random words and every single/double error per code),
BPTC(196,96) decode and the dense sync correlation, all exactly equal."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.fec import bptc as j_bptc
from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec.linear import decode as j_decode
from digiham_tpu.ops.correlate import sync_correlate_conv
from digiham_tpu.pipeline.dmr import dmr_sync_correlate as j_sync
from digiham_tpu_torch.fec import bptc, codes
from digiham_tpu_torch.fec.linear import decode, popcount
from digiham_tpu_torch.ops.correlate import sync_correlate
from digiham_tpu_torch.pipeline.dmr import dmr_sync_correlate

torch.set_num_threads(1)

CODES = ["HAMMING_7_4", "HAMMING_13_9", "HAMMING_15_11", "GOLAY_20_8",
         "QR_16_7"]


def _both(name, words):
    ours_c, ours_ok = decode(getattr(codes, name), torch.from_numpy(words))
    ref_c, ref_ok = j_decode(getattr(j_codes, name), jnp.asarray(words))
    return ours_c.numpy(), ours_ok.numpy(), np.asarray(ref_c), \
        np.asarray(ref_ok)


def _assert_same(name, words):
    oc, ook, rc, rok = _both(name, words)
    assert oc.dtype == rc.dtype and ook.dtype == rok.dtype
    assert np.array_equal(oc, rc), name
    assert np.array_equal(ook, rok), name


@pytest.mark.parametrize("name", CODES)
def test_decode_random_words(name):
    code = getattr(j_codes, name)
    rng = np.random.default_rng(CODES.index(name))
    words = rng.integers(0, 1 << code.n, (64, 32)).astype(np.int32)
    _assert_same(name, words)


@pytest.mark.parametrize("name", CODES)
def test_decode_all_single_and_double_errors(name):
    code = getattr(j_codes, name)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 1 << code.k, 16)
    clean = code.encode(data)
    patterns = [1 << i for i in range(code.n)] + [
        (1 << i) | (1 << k) for i, k in itertools.combinations(
            range(code.n), 2)]
    words = (clean[:, None] ^ np.asarray(patterns)[None, :]).astype(np.int32)
    _assert_same(name, words)
    # the port corrects what the code guarantees
    oc, ook, _, _ = _both(name, words[:, :code.n])
    assert ook.all() and (oc == clean[:, None]).all()


def test_popcount_int64():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(popcount(torch.from_numpy(x)).numpy(), want)


def test_bptc_decode_matches_jax():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2, (24, 96))
    bits = j_bptc.encode(data)
    # clean words, one flip, two flips in one column, and random garbage
    flips = bits.copy()
    flips[6:12, rng.integers(0, 196)] ^= 1
    flips[12:18, [1, 16]] ^= 1
    flips[18:] = rng.integers(0, 2, (6, 196))
    for x in (bits, flips):
        ours_d, ours_ok = bptc.decode(torch.from_numpy(x))
        ref_d, ref_ok = j_bptc.decode(jnp.asarray(x))
        assert ours_d.dtype == torch.int32 and ours_ok.dtype == torch.bool
        assert np.array_equal(ours_d.numpy(), np.asarray(ref_d))
        assert np.array_equal(ours_ok.numpy(), np.asarray(ref_ok))
    assert np.array_equal(bptc.decode(torch.from_numpy(bits))[0].numpy(),
                          data)


@pytest.mark.parametrize("n_values,K", [(4, 24), (2, 16)])
def test_sync_correlate_matches_jax(n_values, K):
    rng = np.random.default_rng(n_values)
    sym = rng.integers(0, n_values, (3, 5, 300)).astype(np.uint8)
    pats = rng.integers(0, n_values, (4, K)).astype(np.int64)
    ours = sync_correlate(torch.from_numpy(sym),
                          torch.from_numpy(pats.astype(np.uint8)), n_values)
    ref = np.asarray(sync_correlate_conv(jnp.asarray(sym), pats, n_values))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), ref)


def test_dmr_sync_correlate_matches_jax():
    rng = np.random.default_rng(5)
    dib = rng.integers(0, 4, (8, 1600)).astype(np.uint8)
    ours = dmr_sync_correlate(torch.from_numpy(dib))
    ref = np.asarray(j_sync(jnp.asarray(dib)))
    assert ours.shape == ref.shape == (8, 1577, 4)
    assert np.array_equal(ours.numpy(), ref)
