"""The port's bulk (channel, time) steps (``digiham_tpu_torch.parallel.
sharded``) on local CPU meshes of shape (2, 2), (1, 4) and (4, 1), held
against the JAX package's on the 8-device virtual mesh on the same seeded
audio: decisions, frame fields and sync hits exact; the RRC within 2e-6 of
the block's peak. Every time shard of every split demodulates from a fresh
state, and the audio is screened so that none of those decisions is a
knife edge (tests/torch_scale.py). Also: the bulk step equals the port's
own single-device computation per time shard, and the mesh's checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digiham_tpu.parallel import sharded_fsk_step as j_fsk_step
from digiham_tpu.parallel import sharded_gfsk_step as j_gfsk_step
from digiham_tpu.parallel import sharded_pipeline_step as j_pipeline_step
from digiham_tpu.parallel import sharded_rrc_filter as j_rrc_filter
from digiham_tpu_torch.dsp.demod import demod_init, gfsk_demod_block
from digiham_tpu_torch.dsp.rrc import RrcState, rrc_filter_block
from digiham_tpu_torch.parallel import (make_mesh, sharded_fsk_step,
                                        sharded_gfsk_step,
                                        sharded_pipeline_step,
                                        sharded_rrc_filter)
from digiham_tpu_torch.pipeline.dmr import (dmr_decode_frames,
                                            dmr_sync_correlate)
from torch_scale import (STREAMS, bulk_windows, jax_mesh, port_mesh,
                         screened_audio)

SHAPES = [(2, 2), (1, 4), (4, 1)]
C = 4
# protocol -> centuries each time shard demodulates (YSF: one 480-dibit
# frame needs 5)
CENTURIES = {"dmr": 2, "ysf": 5, "nxdn": 2, "dstar": 2, "pocsag": 1}


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax.devices()


@pytest.fixture(scope="module")
def audio():
    """protocol -> [C, 4 * T_local] audio, every time shard of the 1-, 2-
    and 4-way splits knife-edge free from a fresh demod state."""
    cache = {}

    def get(protocol):
        if protocol not in cache:
            sps = STREAMS[protocol][0].sps
            n_cent = CENTURIES[protocol]
            seg = n_cent * (100 * sps + 1) + 1
            total = 4 * seg
            cache[protocol] = screened_audio(
                protocol, C, total, 300 + len(cache),
                bulk_windows((1, 2, 4), seg, n_cent * 100, total))
        return cache[protocol]

    return get


def _equal(got, want, what):
    np.testing.assert_array_equal(
        got.numpy().astype(np.int64), np.asarray(want).astype(np.int64),
        err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_rrc_filter_matches_jax(devices, audio, shape):
    """Overlap-save with the halo hop == JAX's within 2e-6 of the peak,
    and == the whole row's streaming filter from zeroed state exactly."""
    x = audio("dmr")
    got = sharded_rrc_filter(port_mesh(shape), x)
    want = np.asarray(j_rrc_filter(jax_mesh(shape), jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
    whole, _ = rrc_filter_block(torch.from_numpy(x),
                                RrcState.init(C, device="cpu"))
    assert torch.equal(got, whole)


@pytest.mark.parametrize("shape", SHAPES)
def test_pipeline_step_matches_jax(devices, audio, shape):
    x = audio("dmr")
    voice, hits = sharded_pipeline_step(port_mesh(shape), x, 10, 2)
    j_voice, j_hits = j_pipeline_step(jax_mesh(shape), jnp.asarray(x), 10, 2)
    assert tuple(voice.shape) == np.shape(j_voice) and voice.shape[-1] == 27
    _equal(voice, j_voice, "voice_payload")
    _equal(hits, j_hits, "sync hits")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("protocol", ["dmr", "ysf", "nxdn"])
def test_gfsk_step_matches_jax(devices, audio, protocol, shape):
    x = audio(protocol)
    n_cent = CENTURIES[protocol]
    fields, hits = sharded_gfsk_step(port_mesh(shape), x, protocol, n_cent)
    j_fields, j_hits = j_gfsk_step(jax_mesh(shape), jnp.asarray(x),
                                   protocol, n_cent)
    assert set(fields) == set(j_fields)
    for key, want in j_fields.items():
        assert tuple(fields[key].shape) == np.shape(want), key
        _equal(fields[key], want, key)
    _equal(hits, j_hits, "sync hits")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("protocol", ["dstar", "pocsag"])
def test_fsk_step_matches_jax(devices, audio, protocol, shape):
    x = audio(protocol)
    n_cent = CENTURIES[protocol]
    out, hits = sharded_fsk_step(port_mesh(shape), x, protocol, n_cent)
    j_out, j_hits = j_fsk_step(jax_mesh(shape), jnp.asarray(x), protocol,
                               n_cent)
    assert tuple(out.shape) == np.shape(j_out)
    _equal(out, j_out, protocol)
    _equal(hits, j_hits, "sync hits")


def test_dmr_step_matches_single_device(audio):
    """The bulk step == the port's single-device computation: the whole
    row's RRC, then per time shard a demod from a fresh state, the sync
    hits and the frame decode."""
    x = audio("dmr")
    voice, hits = sharded_pipeline_step(port_mesh((2, 2)), x, 10, 2)
    y, _ = rrc_filter_block(torch.from_numpy(x),
                            RrcState.init(C, device="cpu"))
    seg = x.shape[1] // 2
    want_hits = torch.zeros(C, dtype=torch.int64)
    for t in range(2):
        dibits, _ = gfsk_demod_block(y[:, t * seg:(t + 1) * seg],
                                     demod_init(C, "cpu"), 2, 10)
        want_hits += (dmr_sync_correlate(dibits) <= 3).any(-1).sum(-1)
        n = dibits.shape[1] // 144
        want = dmr_decode_frames(dibits[:, :n * 144].reshape(C, n, 144))
        assert torch.equal(voice[:, t * n:(t + 1) * n],
                           want["voice_payload"]), t
    assert torch.equal(hits.to(torch.int64), want_hits)


def test_mesh_checks(audio):
    """A mesh may name one device several times; it never packs shards
    onto fewer devices than asked, finds no card here for devices=None,
    and refuses channels or samples that do not divide."""
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"channel": 2, "time": 2}
    assert mesh.single_process and len(mesh.local) == 4
    assert [str(d) for d in mesh.devices] == ["cpu"] * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
    x = audio("dmr")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_rrc_filter(make_mesh(3, 1, devices=["cpu"] * 3), x)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_rrc_filter(mesh, x[:, :-1])
