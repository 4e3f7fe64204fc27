"""The port's YSF and NXDN checksums against the JAX package's
``BitCrc``: the impulse-response tables, the numpy path and the tensor
path (parity of an integer masked sum) on random bits. All exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.fec import crc as j_crc
from digiham_tpu_torch.fec import crc

torch.set_num_threads(1)

VARIANTS = [("crc16_ysf", 32), ("crc16_ysf", 80), ("crc6_nxdn", 26),
            ("crc12_nxdn", 80)]


@pytest.mark.parametrize("name,nbits", VARIANTS)
def test_crc_tables_equal(name, nbits):
    ours, ref = getattr(crc, name)(nbits), getattr(j_crc, name)(nbits)
    assert (ours.width, ours.const) == (ref.width, ref.const)
    assert ours.table.dtype == ref.table.dtype
    assert np.array_equal(ours.table, ref.table)
    # the bit planes are the table, most significant checksum bit first
    weights = 1 << np.arange(ours.width - 1, -1, -1)
    assert np.array_equal(ours.bit_planes @ weights, ref.table)


@pytest.mark.parametrize("name,nbits", VARIANTS)
def test_crc_compute_matches_jax(name, nbits):
    ours, ref = getattr(crc, name)(nbits), getattr(j_crc, name)(nbits)
    rng = np.random.default_rng(nbits)
    bits = rng.integers(0, 2, (5, 11, nbits)).astype(np.int32)
    bits[0, 0] = 0
    bits[0, 1] = 1
    want = ref.compute_np(bits)
    got = ours.compute(torch.from_numpy(bits))
    j_got = np.asarray(ref.compute(jnp.asarray(bits)))
    assert got.dtype == torch.int32 and j_got.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), j_got)
    assert np.array_equal(ours.compute_np(bits), want)
    assert 0 <= got.min() and got.max() < 1 << ours.width


def test_crc_accepts_its_planes_as_a_buffer():
    """Pipelines pass the planes as a registered buffer on the bits'
    device; the result is the same."""
    c = crc.crc12_nxdn(80)
    bits = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (7, 80)))
    assert torch.equal(c.compute(bits), c.compute(bits, c.planes("cpu")))
