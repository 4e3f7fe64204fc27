"""The port's NXDN pipeline against the JAX package's: every batch
function on synthesized units, the whole ``step`` plus
``nxdn_decode_frames`` over 3 chained blocks of the smoke stream (FM audio
of voice and FACCH1 frames on the RX frame grid, narrow RRC at 20 sps), a
mid-stream hand-off through ``digiham_tpu_torch.convert``, and the
committed smoke fixture rebuilt from ``nxdn_synth`` plus the JAX pipeline
(so it cannot drift from either). Integers and bytes are exact; the
volume ring is within 1e-3 (f32 summation order).

Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_pipeline_nxdn.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.pipeline import nxdn as j_nxdn
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.dsp.rrc import NARROW_RRC
from digiham_tpu_torch.pipeline import NxdnPipeline, nxdn as p_nxdn

sys.path.insert(0, os.path.dirname(__file__))
from nxdn_synth import (encode_facch1, encode_sacch_unit,  # noqa: E402
                        nxdn_frame, vcall_superframe_bytes,
                        voice_slot_dibits)
from torch_parity import (DOTS, VARIANTS, assert_fields_equal,  # noqa: E402
                          audio_stream_knife_edge_free, build_audio_fixture,
                          jax_audio_chain, port_audio_chain, tx_stream)

torch.set_num_threads(1)

STREAM = smoke.NXDN
FRAMES_PER_BLOCK = STREAM.symbols_per_block // STREAM.frame_size
RING_ATOL = 1e-3  # volume means of ~5e2-sized samples, f32 order: ~1e-4
MESSAGE_TYPES = (0x10, 0x08, 0x01)  # IDLE, TX_RELEASE, VCALL


def _frame(rng, units, index: int, option: int) -> np.ndarray:
    """One RTCH frame: LICH, SACCH unit ``index % 4`` of the superframe,
    and per slot a voice payload (option bit set) or a FACCH1."""
    slots = []
    for s in range(2):
        offset = 38 + 72 * s
        if (option >> (1 - s)) & 1:
            slots.append(voice_slot_dibits(rng.integers(0, 4, 72), offset))
        else:
            slots.append(encode_facch1(
                MESSAGE_TYPES[int(rng.integers(0, 3))], offset))
    return nxdn_frame((0b01, 0b10, option),
                      encode_sacch_unit(index % 4, units[index % 4]), slots)


def _tx_variant(variant: int) -> np.ndarray:
    """Per step two frame slots: dotting then a frame, then two frames per
    step, cycling voice/voice, FACCH1/FACCH1 and mixed slots. Every step
    holds a frame whose LICH and SACCH decode."""
    rng = np.random.default_rng(3000 + variant)
    units = vcall_superframe_bytes(variant % 8, 100 + variant,
                                   2000 + variant)
    options = [0b11, 0b00, 0b10, 0b01, 0b11]
    frames = [_frame(rng, units, i, o) for i, o in enumerate(options)]
    return tx_stream(STREAM, [[DOTS[:192], frames[0]], frames[1:3],
                              frames[3:5]])


def _jax_frames(dibits):
    frames = dibits[:, :FRAMES_PER_BLOCK * 192].reshape(
        dibits.shape[0], FRAMES_PER_BLOCK, 192)
    return j_nxdn.nxdn_decode_frames(frames, impl="xla")


def _port_frames(dibits):
    frames = dibits[:, :FRAMES_PER_BLOCK * 192].reshape(
        dibits.shape[0], FRAMES_PER_BLOCK, 192)
    return p_nxdn.nxdn_decode_frames(frames)


def _jax_chain(samples, **kw):
    pipe = j_nxdn.NxdnPipeline(channels=samples.shape[0], sps=STREAM.sps,
                               n_centuries=STREAM.n_centuries)
    return jax_audio_chain(pipe, j_nxdn.NxdnPipelineState, STREAM, samples,
                           post=_jax_frames, **kw)


def _port_chain(samples, **kw):
    pipe = NxdnPipeline(channels=samples.shape[0], sps=STREAM.sps,
                        n_centuries=STREAM.n_centuries, device="cpu")
    return port_audio_chain(pipe, STREAM, samples, post=_port_frames, **kw)


def build_fixture(noise_seeds=None) -> dict:
    return build_audio_fixture(STREAM, NARROW_RRC, _tx_variant,
                               lambda x: _jax_chain(x)[0], noise_seeds,
                               first_seed=9000)


@pytest.fixture(scope="module")
def committed():
    return smoke.load(STREAM)


@pytest.fixture(scope="module")
def samples(committed):
    return smoke.audio(STREAM, committed["tx_dibits"],
                       committed["noise_seeds"])


def _with_errors(rng, dibits, rate):
    dibits = np.array(dibits, np.uint8)
    hit = rng.random(dibits.shape) < rate
    dibits[hit] ^= rng.integers(1, 4, int(hit.sum())).astype(np.uint8)
    return dibits


def test_decode_sacch_batch_matches_jax():
    rng = np.random.default_rng(1)
    units = vcall_superframe_bytes(1, 1234, 4321)
    clean = [encode_sacch_unit(i, units[i]) for i in range(4)]
    sacch = np.stack(clean + [_with_errors(rng, u, 0.05) for u in clean]
                     + [rng.integers(0, 4, 30).astype(np.uint8)
                        for _ in range(4)]).reshape(3, 4, 30)
    got = p_nxdn.decode_sacch_batch(torch.from_numpy(sacch))
    want = j_nxdn.decode_sacch_batch(jnp.asarray(sacch), impl="xla")
    names = ("structure", "bits", "ok")
    assert_fields_equal({n: g.numpy() for n, g in zip(names, got)},
                        {n: np.asarray(w) for n, w in zip(names, want)})
    assert got[2].numpy()[0].all()
    assert np.array_equal(got[0].numpy()[0], np.arange(4))
    assert np.array_equal(got[1].numpy()[0], units)


@pytest.mark.parametrize("offset", [38, 110])
def test_decode_facch1_batch_matches_jax(offset):
    rng = np.random.default_rng(offset)
    clean = [encode_facch1(mt, offset) for mt in MESSAGE_TYPES]
    slots = np.stack(clean + [_with_errors(rng, u, 0.03) for u in clean]
                     + [rng.integers(0, 4, 72).astype(np.uint8)
                        for _ in range(3)]).reshape(3, 3, 72)
    got = p_nxdn.decode_facch1_batch(torch.from_numpy(slots), offset)
    want = j_nxdn.decode_facch1_batch(jnp.asarray(slots), offset=offset,
                                      impl="xla")
    assert_fields_equal({"mtype": got[0].numpy(), "ok": got[1].numpy()},
                        {"mtype": np.asarray(want[0]),
                         "ok": np.asarray(want[1])})
    assert got[1].numpy()[0].all()
    assert np.array_equal(got[0].numpy()[0], MESSAGE_TYPES)


def test_nxdn_decode_frames_and_sync_correlate_match_jax():
    rng = np.random.default_rng(4)
    units = vcall_superframe_bytes(2, 77, 88)
    frames = np.stack(
        [_with_errors(rng, _frame(rng, units, i, i % 4), 0.01 * (i % 3))
         for i in range(6)]
        + [rng.integers(0, 4, 192).astype(np.uint8) for _ in range(2)]
    ).reshape(2, 4, 192)
    got = {k: v.numpy() for k, v in
           p_nxdn.nxdn_decode_frames(torch.from_numpy(frames)).items()}
    want = {k: np.asarray(v) for k, v in j_nxdn.nxdn_decode_frames(
        jnp.asarray(frames), impl="xla").items()}
    assert_fields_equal(got, want)
    dibits = frames.reshape(2, -1)
    dense = p_nxdn.nxdn_sync_correlate(torch.from_numpy(dibits)).numpy()
    j_dense = np.asarray(j_nxdn.nxdn_sync_correlate(jnp.asarray(dibits)))
    assert dense.dtype == j_dense.dtype and np.array_equal(dense, j_dense)


@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64"])
def test_decode_frames_is_one_decode_of_sacch_and_both_slots(dtype,
                                                             monkeypatch):
    """The frame function hands the SACCH and both FACCH1 slots to one
    ``viterbi_decode_many`` call (the slots as one [..., 2, 96] batch) and
    its fields equal ``decode_sacch_batch`` and ``decode_facch1_batch``
    called alone on the same frames."""
    from digiham_tpu_torch.ops import viterbi as k5

    rng = np.random.default_rng(6)
    units = vcall_superframe_bytes(3, 55, 66)
    frames = torch.from_numpy(np.stack(
        [_with_errors(rng, _frame(rng, units, i, i % 4), 0.01 * (i % 3))
         for i in range(4)]
        + [rng.integers(0, 4, 192).astype(np.uint8) for _ in range(2)]
    ).reshape(3, 2, 192).astype(dtype))
    calls = []
    many = p_nxdn.viterbi_decode_many

    def counted(segments):
        segments = list(segments)
        calls.append([(tuple(o.shape), b) for o, b in segments])
        return many(segments)

    monkeypatch.setattr(p_nxdn, "viterbi_decode_many", counted)
    before = k5.LAUNCHES
    out = p_nxdn.nxdn_decode_frames(frames)
    assert k5.LAUNCHES == before  # CPU tensors launch nothing
    assert calls == [[((3, 2, 36), 4), ((3, 2, 2, 96), 4)]]
    structure, bits, ok = p_nxdn.decode_sacch_batch(frames[..., 18:48])
    want = {"sacch_structure": structure, "sacch_bits": bits, "sacch_ok": ok}
    for i in range(2):
        want[f"facch_mtype{i}"], want[f"facch_ok{i}"] = \
            p_nxdn.decode_facch1_batch(
                frames[..., 48 + 72 * i:120 + 72 * i], 38 + 72 * i)
    assert len(calls) == 1  # the batch functions decode on their own
    for k, w in want.items():
        assert out[k].dtype == w.dtype and torch.equal(out[k], w), k
    j_out = j_nxdn.nxdn_decode_frames(jnp.asarray(frames.numpy()),
                                      impl="xla")
    assert_fields_equal({k: v.numpy() for k, v in out.items()},
                        {k: np.asarray(v) for k, v in j_out.items()})


def test_chained_steps_launch_nothing_on_the_cpu(samples):
    from digiham_tpu_torch.ops import demod_front, fir, viterbi as k5

    before = (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES)
    outs, _ = _port_chain(samples[:2])
    assert len(outs) == smoke.STEPS
    assert (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES) == before


def test_fixture_rebuilds_exactly(committed, samples):
    """The committed fixture equals a fresh build from nxdn_synth and the
    JAX pipeline with its stored seeds, and every stream is knife-edge
    free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    for v in range(VARIANTS):
        assert audio_stream_knife_edge_free(STREAM, NARROW_RRC,
                                            samples[v]), v


def test_fixture_decodes_the_frames(committed):
    """The stream is NXDN worth checking: every step has a frame whose
    LICH and SACCH decode; after the first block every LICH and sync
    word does, and the FACCH1 slots decode. (A clean SACCH can still fail
    its CRC: the reference inflates punctured bits as received zeros, so
    the decode is not maximum-likelihood. Both packages agree on those.)"""
    lich_ok = committed["expected_lich_ok"]       # [V, STEPS, 2]
    sacch_ok = committed["expected_sacch_ok"]
    assert (lich_ok & sacch_ok).any(-1).all()
    assert lich_ok[:, 1:].all()
    assert (committed["expected_sync_dist"][:, 1:] == 0).all()
    # options 0b00 (step 1 frame 0): both slots FACCH1; 0b10: slot 1;
    # 0b01: slot 0
    assert committed["expected_facch_ok0"][:, 1, 0].all()
    assert committed["expected_facch_ok1"][:, 1, 0].all()
    assert committed["expected_facch_ok1"][:, 1, 1].all()
    assert committed["expected_facch_ok0"][:, 2, 0].all()


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
    assert p_state.rrc.history.shape[-1] == 160


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
    j_back = j_nxdn.NxdnPipelineState(
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
