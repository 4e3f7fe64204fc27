"""The port's YSF pipeline against the JAX package's: every batch function
on synthesized frames, the whole ``step`` over 3 chained blocks of the
smoke stream (FM audio of header, V/D2 and terminator frames on the RX
frame grid), a mid-stream hand-off through ``digiham_tpu_torch.convert``,
and the committed smoke fixture rebuilt from ``ysf_synth`` plus the JAX
pipeline (so it cannot drift from either). Integers and bytes are exact;
the volume ring is within 1e-3 (f32 summation order).

``ysf_decode_frames`` decodes FICH and DCH through one call of
``viterbi_decode_many`` (one launch of K5 on the card): its fields must
equal the batch functions called alone, whatever integer type the frames
have, and on the CPU nothing launches.

Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_pipeline_ysf.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.pipeline import ysf as j_ysf
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.dsp.rrc import WIDE_RRC
from digiham_tpu_torch.pipeline import YsfPipeline, ysf as p_ysf

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (DOTS, VARIANTS, assert_fields_equal,  # noqa: E402
                          audio_stream_knife_edge_free, build_audio_fixture,
                          jax_audio_chain, port_audio_chain, tx_stream)
from ysf_synth import (encode_v2_voice, header_frame,  # noqa: E402
                       terminator_frame, vd2_frame)

torch.set_num_threads(1)

STREAM = smoke.YSF
RING_ATOL = 1e-3  # volume means of ~5e2-sized samples, f32 order: ~1e-4


def _tx_variant(variant: int) -> np.ndarray:
    """Per step two frame slots: dotting then a V/D2 frame; a header and a
    V/D2 frame; a V/D2 frame and a terminator. Every step holds a V/D2
    frame that decodes (FICH and DCH ok)."""
    rng = np.random.default_rng(2000 + variant)

    def vd2(fn):
        return vd2_frame(fn, bytes(rng.integers(32, 127, 10).tolist()),
                         bytes(rng.integers(0, 256, 7).tolist()))

    call = b"CALL%d" % variant
    return tx_stream(STREAM, [
        [DOTS[:480], vd2(0)],
        [header_frame(b"ALL", call, b"DOWN", b"UP"), vd2(1)],
        [vd2(2), terminator_frame()],
    ])


def _jax_chain(samples, **kw):
    pipe = j_ysf.YsfPipeline(channels=samples.shape[0], sps=STREAM.sps,
                             n_centuries=STREAM.n_centuries)
    return jax_audio_chain(pipe, j_ysf.YsfPipelineState, STREAM, samples,
                           **kw)


def _port_chain(samples, **kw):
    pipe = YsfPipeline(channels=samples.shape[0], sps=STREAM.sps,
                       n_centuries=STREAM.n_centuries, device="cpu")
    return port_audio_chain(pipe, STREAM, samples, **kw)


def build_fixture(noise_seeds=None) -> dict:
    return build_audio_fixture(STREAM, WIDE_RRC, _tx_variant,
                               lambda x: _jax_chain(x)[0], noise_seeds)


@pytest.fixture(scope="module")
def committed():
    return smoke.load(STREAM)


@pytest.fixture(scope="module")
def samples(committed):
    return smoke.audio(STREAM, committed["tx_dibits"],
                       committed["noise_seeds"])


def _random_frames(seed, shape):
    """Frame dibits: half synthesized V/D2 frames with a few symbol
    errors, half noise."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 4, (int(np.prod(shape)), 480)).astype(np.uint8)
    for i in range(0, len(flat), 2):
        frame = vd2_frame(i % 8, bytes(rng.integers(0, 256, 10).tolist()),
                          bytes(rng.integers(0, 256, 7).tolist())).copy()
        hit = rng.random(480) < 0.01 * (i % 4)
        frame[hit] ^= rng.integers(1, 4, int(hit.sum())).astype(np.uint8)
        flat[i] = frame
    return flat.reshape(shape + (480,))


def test_decode_fich_batch_matches_jax():
    frames = _random_frames(1, (3, 6))
    fich = frames[..., 20:120]
    got_w, got_ok = p_ysf.decode_fich_batch(torch.from_numpy(fich))
    want_w, want_ok = j_ysf.decode_fich_batch(jnp.asarray(fich), impl="xla")
    assert_fields_equal({"fich_data": got_w.numpy(), "ok": got_ok.numpy()},
                        {"fich_data": np.asarray(want_w),
                         "ok": np.asarray(want_ok)})
    assert got_ok.numpy()[:, ::2].all()  # the synthesized frames decode
    # a word with its top bit set survives the int64 detour
    assert (got_w.numpy() >= 0).all() and (got_w.numpy() >> 31).any()


def test_decode_vd2_voice_batch_matches_jax():
    rng = np.random.default_rng(2)
    ambe = [bytes(rng.integers(0, 256, 7).tolist()) for _ in range(6)]
    voice = np.stack([encode_v2_voice(a) for a in ambe]
                     + [rng.integers(0, 4, 52).astype(np.uint8)
                        for _ in range(6)]).reshape(2, 6, 52)
    got = p_ysf.decode_vd2_voice_batch(torch.from_numpy(voice)).numpy()
    want = np.asarray(j_ysf.decode_vd2_voice_batch(jnp.asarray(voice)))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the mapping carries 49 voice bits: they round-trip
    for a, g in zip(ambe, got[0]):
        assert bytes(g[:6]) == a[:6] and g[6] == a[6] & 0x80


def test_decode_vd2_dch_batch_matches_jax():
    payload = _random_frames(3, (2, 8))[..., 120:]
    got_d, got_ok = p_ysf.decode_vd2_dch_batch(torch.from_numpy(payload))
    want_d, want_ok = j_ysf.decode_vd2_dch_batch(jnp.asarray(payload),
                                                 impl="xla")
    assert_fields_equal({"dch": got_d.numpy(), "ok": got_ok.numpy()},
                        {"dch": np.asarray(want_d),
                         "ok": np.asarray(want_ok)})
    assert got_ok.numpy()[:, ::2].all()


def test_ysf_decode_frames_and_sync_correlate_match_jax():
    frames = _random_frames(4, (2, 4))
    got = {k: v.numpy() for k, v in
           p_ysf.ysf_decode_frames(torch.from_numpy(frames)).items()}
    want = {k: np.asarray(v) for k, v in
            j_ysf.ysf_decode_frames(jnp.asarray(frames), impl="xla").items()}
    assert_fields_equal(got, want)
    dibits = frames.reshape(2, -1)
    dense = p_ysf.ysf_sync_correlate(torch.from_numpy(dibits)).numpy()
    j_dense = np.asarray(j_ysf.ysf_sync_correlate(jnp.asarray(dibits)))
    assert dense.dtype == j_dense.dtype and np.array_equal(dense, j_dense)
    assert (dense[:, ::480][:, ::2] == 0).all()  # the sync words are found


@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64"])
def test_decode_frames_is_one_decode_of_both_channels(dtype, monkeypatch):
    """The frame function hands FICH and DCH to one ``viterbi_decode_many``
    call and its fields equal ``decode_fich_batch`` and
    ``decode_vd2_dch_batch`` called alone on the same frames."""
    from digiham_tpu_torch.ops import viterbi as k5

    frames = torch.from_numpy(_random_frames(5, (3, 2)).astype(dtype))
    calls = []
    many = p_ysf.viterbi_decode_many

    def counted(segments):
        segments = list(segments)
        calls.append([(tuple(o.shape), o.dtype, b) for o, b in segments])
        return many(segments)

    monkeypatch.setattr(p_ysf, "viterbi_decode_many", counted)
    before = k5.LAUNCHES
    out = p_ysf.ysf_decode_frames(frames)
    assert k5.LAUNCHES == before  # CPU tensors launch nothing
    # one call, two segments, the frames' own integer type
    assert calls == [[((3, 2, 100), frames.dtype, 0)] * 2]
    fich_data, fich_ok = p_ysf.decode_fich_batch(frames[..., 20:120])
    dch, dch_ok = p_ysf.decode_vd2_dch_batch(frames[..., 120:])
    assert len(calls) == 1  # the batch functions decode on their own
    for k, want in (("fich_data", fich_data), ("fich_ok", fich_ok),
                    ("vd2_dch", dch), ("vd2_dch_ok", dch_ok)):
        assert out[k].dtype == want.dtype and torch.equal(out[k], want), k
    want = j_ysf.ysf_decode_frames(jnp.asarray(frames.numpy()), impl="xla")
    assert_fields_equal({k: v.numpy() for k, v in out.items()},
                        {k: np.asarray(v) for k, v in want.items()})


def test_chained_steps_launch_nothing_on_the_cpu(samples):
    from digiham_tpu_torch.ops import demod_front, fir, viterbi as k5

    before = (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES)
    outs, _ = _port_chain(samples[:2])
    assert len(outs) == smoke.STEPS
    assert (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES) == before


def test_fixture_rebuilds_exactly(committed, samples):
    """The committed fixture equals a fresh build from ysf_synth and the
    JAX pipeline with its stored seeds, and every stream is knife-edge
    free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    for v in range(VARIANTS):
        assert audio_stream_knife_edge_free(STREAM, WIDE_RRC, samples[v]), v


def test_fixture_decodes_the_frames(committed):
    """The stream is YSF worth checking: every step has a V/D2 frame whose
    FICH and DCH decode, and the header and terminator FICHs decode."""
    fich_ok = committed["expected_fich_ok"]       # [V, STEPS, 2]
    dch_ok = committed["expected_vd2_dch_ok"]
    assert (fich_ok & dch_ok).any(-1).all()
    assert fich_ok[:, 1:].all()
    assert (committed["expected_sync_dist"][:, 1:] == 0).all()


def test_step_matches_jax(samples, committed):
    """Every output field of every chained block equals JAX's: keys,
    dtypes, shapes and values; the final state too."""
    j_outs, j_state = _jax_chain(samples)
    p_outs, p_state = _port_chain(samples)
    for s, (jo, po) in enumerate(zip(j_outs, p_outs)):
        assert_fields_equal(po, jo, s)
        for k in STREAM.fields:
            assert np.array_equal(jo[k], committed[f"expected_{k}"][:, s])
    assert np.array_equal(p_state.demod.pos.numpy(),
                          np.asarray(j_state.demod.pos))
    assert np.array_equal(p_state.demod.offset.numpy(),
                          np.asarray(j_state.demod.offset))
    assert np.abs(p_state.demod.volume_ring.numpy()
                  - np.asarray(j_state.demod.volume_ring)).max() <= RING_ATOL
    # the RRC carry is raw input: bitwise equal
    assert np.array_equal(p_state.rrc.history.numpy(),
                          np.asarray(j_state.rrc.history))


def test_step_prefiltered_matches_jax(samples):
    """use_rrc=False: the input is filtered already and only the century
    demod runs (kernel K3's plain version)."""
    from digiham_tpu.dsp.rrc import RrcState, rrc_filter_block

    C = 2
    block = samples[:C, :STREAM.block_len]
    filt, _ = rrc_filter_block(jnp.asarray(block), RrcState.init(C),
                               impl="xla")
    filt = np.array(filt)  # a writable copy for torch.from_numpy
    jp = j_ysf.YsfPipeline(C, STREAM.sps, STREAM.n_centuries, use_rrc=False)
    j_out, j_state = jp.step(jnp.asarray(filt), jp.init_state(), impl="xla")
    pp = YsfPipeline(C, STREAM.sps, STREAM.n_centuries, use_rrc=False,
                     device="cpu")
    p_out, p_state = pp.step(torch.from_numpy(filt), pp.init_state())
    assert_fields_equal({k: v.numpy() for k, v in p_out.items()},
                        {k: np.asarray(v) for k, v in j_out.items()})
    assert np.array_equal(p_state.demod.pos.numpy(),
                          np.asarray(j_state.demod.pos))
    assert not p_state.rrc.history.any()  # passes through untouched


def test_convert_handoff_midstream(samples):
    """JAX runs the first block; its state crosses to the port through
    convert.from_jax, the port runs the second and matches JAX's own
    continuation; the port's state crosses back through convert.to_numpy
    and JAX continues from it equally."""
    from digiham_tpu.dsp.demod import DemodState
    from digiham_tpu.dsp.rrc import RrcState

    x = samples[:4]
    _, j_state = _jax_chain(x, steps=1)
    state, carry = convert.from_jax(j_state, device="cpu")
    assert carry is None
    p_outs, p_state = _port_chain(x, state=state, first_step=1, steps=1)
    j_rest, _ = _jax_chain(x, state=j_state, first_step=1, steps=1)
    assert_fields_equal(p_outs[0], j_rest[0])

    back = convert.to_numpy(p_state)
    assert sorted(back) == ["demod.offset", "demod.pos", "demod.volume_ring",
                            "rrc.history"]
    assert back["demod.pos"].dtype == np.int32
    j_back = j_ysf.YsfPipelineState(
        RrcState(jnp.asarray(back["rrc.history"])),
        DemodState(jnp.asarray(back["demod.pos"]),
                   jnp.asarray(back["demod.offset"]),
                   jnp.asarray(back["demod.volume_ring"])))
    j_last, _ = _jax_chain(x, state=j_back, first_step=2, steps=1)
    p_last, _ = _port_chain(x, state=p_state, first_step=2, steps=1)
    assert_fields_equal(p_last[0], j_last[0])


if __name__ == "__main__":
    fx = build_fixture()
    STREAM.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(STREAM.fixture, **fx)
    print(f"wrote {STREAM.fixture} (noise seeds "
          f"{fx['noise_seeds'].tolist()})")
