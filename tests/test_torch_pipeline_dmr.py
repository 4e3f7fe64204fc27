"""The port's DMR pipeline against the JAX package's, on synthesized DMR
streams: output dicts equal over chained blocks, a mid-stream hand-off
through ``digiham_tpu_torch.convert``, the FM-audio ``step`` on the CPU,
and the committed smoke fixture rebuilt from ``dmr_synth`` plus the JAX
pipeline (so it cannot drift from either).

Rebuild the fixture with
``PYTHONPATH=. python tests/test_torch_pipeline_dmr.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp.demod import DemodState as JDemodState
from digiham_tpu.dsp.fm import fm_discriminator as jfm
from digiham_tpu.dsp.rrc import RrcState as JRrcState
from digiham_tpu.pipeline import DmrPipeline as JPipeline
from digiham_tpu.pipeline.dmr import DmrPipelineState as JState
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.pipeline import DmrPipeline

sys.path.insert(0, os.path.dirname(__file__))
from dmr_synth import (data_frame, embedded_fragments, group_lc,  # noqa: E402
                       voice_frame)
from digiham_tpu.protocols.dmr.components import (  # noqa: E402
    LCSS_CONTINUATION, LCSS_START, LCSS_STOP)
from torch_parity import knife_edge_free, port_audio_chain  # noqa: E402

torch.set_num_threads(1)

VARIANTS = 8
FRAMES_PER_STEP = smoke.DMR.n_centuries * 100 // 144
RRC_DELAY_SYMBOLS = 4  # the 81-tap RRC's centre tap sits 40 samples back
DOTS = np.tile(np.array([0, 2], np.uint8), 72)


def _tx_dibits(variant: int) -> np.ndarray:
    """One variant's TX dibits: per block, 11 frame slots at the RX frame
    grid (144-aligned in each block's dibits) plus 16 filler symbols.
    Slots 0-2 are a dotting preamble, then VOICE_LC headers, voice bursts
    (sync, then EMB with the embedded LC) and terminators, alternating
    TDMA slots. The stream leads the RX grid by the RRC delay."""
    rng = np.random.default_rng(1000 + variant)
    lc = group_lc(100 + variant, 2000 + variant)
    frags = embedded_fragments(lc)
    lcss = [LCSS_START, LCSS_CONTINUATION, LCSS_CONTINUATION, LCSS_STOP]
    n_slots = smoke.STEPS * FRAMES_PER_STEP
    frames = []
    for f in range(n_slots):
        ts = f % 2
        if f < 3:
            frames.append(DOTS)
        elif f < 5:
            frames.append(data_frame(ts, 1, lc))
        elif f >= n_slots - 2:
            frames.append(data_frame(ts, 2, lc))
        else:
            kind = ((f - 5) // 2) % 6
            payload = rng.integers(0, 4, 108)
            if kind in (0, 5):
                frames.append(voice_frame(ts, payload, sync=True))
            else:
                frames.append(voice_frame(
                    ts, payload, sync=False, emb_fragment=frags[kind - 1],
                    lcss=lcss[kind - 1]))
    blocks = []
    for s in range(smoke.STEPS):
        blocks += frames[s * FRAMES_PER_STEP:(s + 1) * FRAMES_PER_STEP]
        blocks.append(DOTS[:smoke.DMR.n_centuries * 100
                           - FRAMES_PER_STEP * 144])
    content = np.concatenate(blocks)
    n_sym = -(-smoke.DMR.stream_len // smoke.DMR.sps) + 1
    tail = np.tile(np.array([0, 2], np.uint8),
                   -(-(n_sym - len(content) + RRC_DELAY_SYMBOLS) // 2))
    return np.concatenate([content[RRC_DELAY_SYMBOLS:], tail])[:n_sym]


def _jax_run(re, im, state=None, carry=None, first_step=0,
             steps=smoke.STEPS):
    """JAX pipeline over chained blocks of full-stream planes [C, N].
    Returns (per-step output dicts as numpy, final state, final carry)."""
    C = re.shape[0]
    pipe = JPipeline(channels=C, sps=smoke.DMR.sps,
                     n_centuries=smoke.DMR.n_centuries)
    if state is None:
        state = pipe.init_state()
        carry = (jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.float32))
    halo = state.rrc.history.shape[-1]
    outs = []
    for s in range(first_step, first_step + steps):
        o = s * smoke.DMR.advance
        if s:
            # the JAX twin of smoke.rebase_iq
            audio, _ = jfm(jnp.asarray(re[:, o - halo:o]
                                       + 1j * im[:, o - halo:o]),
                           jnp.asarray(re[:, o - halo - 1]
                                       + 1j * im[:, o - halo - 1]))
            state = JState(JRrcState(audio * smoke.FM_SCALE),
                           JDemodState(state.demod.pos - smoke.DMR.advance,
                                       state.demod.offset,
                                       state.demod.volume_ring))
            carry = (jnp.asarray(re[:, o - 1]), jnp.asarray(im[:, o - 1]))
        out, carry, state = pipe.step_iq_planes(
            jnp.asarray(re[:, o:o + smoke.DMR.block_len]),
            jnp.asarray(im[:, o:o + smoke.DMR.block_len]), *carry, state)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return outs, state, carry


def _port_run(re, im, state=None, carry=None, first_step=0,
              steps=smoke.STEPS):
    """The same chain through the port (CPU tensors: plain versions)."""
    C = re.shape[0]
    pipe = DmrPipeline(channels=C, sps=smoke.DMR.sps,
                       n_centuries=smoke.DMR.n_centuries, device="cpu")
    re_t, im_t = torch.from_numpy(re), torch.from_numpy(im)
    if state is None:
        state = pipe.init_state()
        carry = (torch.ones(C), torch.zeros(C))
    outs = []
    for s in range(first_step, first_step + steps):
        o = s * smoke.DMR.advance
        if s:
            state, carry = smoke.rebase_iq(smoke.DMR, state, re_t, im_t, o)
        out, carry, state = pipe.step_iq_planes(
            re_t[:, o:o + smoke.DMR.block_len],
            im_t[:, o:o + smoke.DMR.block_len], *carry, state)
        outs.append({k: v.numpy() for k, v in out.items()})
    return outs, state, carry


def _knife_edge_free(re, im) -> bool:
    from digiham_tpu.dsp.rrc import WIDE_RRC

    return knife_edge_free(re, im, smoke.STEPS * smoke.DMR.n_centuries * 100,
                           smoke.DMR.sps, WIDE_RRC, fm_scale=smoke.FM_SCALE)


def build_fixture(noise_seeds=None) -> dict:
    """TX dibits, noise seeds and the JAX pipeline's fields. Without
    seeds, draws per-variant seeds until the stream is knife-edge free."""
    tx = np.stack([_tx_dibits(v) for v in range(VARIANTS)])
    if noise_seeds is None:
        noise_seeds = []
        for v in range(VARIANTS):
            seed = 7000 + 100 * v
            while not _knife_edge_free(*(p[0] for p in smoke.modulate(
                    smoke.DMR, tx[v:v + 1], [seed]))):
                seed += 1
            noise_seeds.append(seed)
    noise_seeds = np.asarray(noise_seeds, np.int64)
    outs, _, _ = _jax_run(*smoke.modulate(smoke.DMR, tx, noise_seeds))
    fx = {"tx_dibits": tx, "noise_seeds": noise_seeds}
    for k in smoke.DMR.fields:
        fx[f"expected_{k}"] = np.stack([o[k] for o in outs], axis=1)
    return fx


@pytest.fixture(scope="module")
def committed():
    return smoke.load(smoke.DMR)


@pytest.fixture(scope="module")
def stream(committed):
    return smoke.modulate(smoke.DMR, committed["tx_dibits"], committed["noise_seeds"])


def test_fixture_rebuilds_exactly(committed):
    """The committed fixture equals a fresh build from dmr_synth and the
    JAX pipeline with its stored seeds, and every stream is knife-edge
    free."""
    fresh = build_fixture(committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    re, im = smoke.modulate(smoke.DMR, committed["tx_dibits"], committed["noise_seeds"])
    for v in range(VARIANTS):
        assert _knife_edge_free(re[v], im[v]), v


def test_fixture_decodes_the_bursts(committed):
    """The stream is DMR worth checking: once the AGC has seen the full
    deviation, headers and terminators decode (BPTC ok, data types 1 and
    2) and the voice sync bursts classify as voice."""
    bptc_ok = committed["expected_bptc_ok"].reshape(VARIANTS, -1)
    data_type = committed["expected_data_type"].reshape(VARIANTS, -1)
    sync_type = committed["expected_sync_type"].reshape(VARIANTS, -1)
    assert bptc_ok[:, 4].all() and bptc_ok[:, -2:].all()
    assert (data_type[:, 3:5] == 1).all() and (data_type[:, -2:] == 2).all()
    assert (sync_type[:, 3:5] == 1).all()
    assert (sync_type[:, 5] == 2).all()


def test_step_iq_planes_matches_jax(stream, committed):
    """Every output field of every chained block equals JAX's: keys,
    dtypes, shapes and values."""
    re, im = stream
    j_outs, _, _ = _jax_run(re, im)
    p_outs, _, _ = _port_run(re, im)
    for s, (jo, po) in enumerate(zip(j_outs, p_outs)):
        assert sorted(jo) == sorted(po)
        for k in jo:
            assert po[k].dtype == jo[k].dtype, (s, k)
            assert po[k].shape == jo[k].shape, (s, k)
            assert np.array_equal(po[k], jo[k]), (s, k)
        for k in smoke.DMR.fields:
            assert np.array_equal(po[k], committed[f"expected_{k}"][:, s])


def test_convert_handoff_midstream(stream):
    """JAX runs the first block; its state crosses to the port through
    convert.from_jax, the port runs the rest and matches JAX's own
    continuation exactly; the port's state crosses back through
    convert.to_numpy and JAX continues from it equally."""
    re, im = stream
    j_outs, j_state, j_carry = _jax_run(re, im, steps=1)
    state, carry = convert.from_jax(
        j_state, tuple(np.asarray(c) for c in j_carry), device="cpu")
    p_outs, p_state, p_carry = _port_run(re, im, state, carry,
                                         first_step=1, steps=1)
    j_rest, j_state2, _ = _jax_run(re, im, j_state, j_carry,
                                   first_step=1, steps=1)
    for k in j_rest[0]:
        assert np.array_equal(p_outs[0][k], j_rest[0][k]), k

    back = convert.to_numpy(p_state, p_carry)
    j_back = JState(JRrcState(jnp.asarray(back["rrc.history"])),
                    JDemodState(jnp.asarray(back["demod.pos"]),
                                jnp.asarray(back["demod.offset"]),
                                jnp.asarray(back["demod.volume_ring"])))
    assert back["demod.pos"].dtype == np.int32
    np.testing.assert_array_equal(back["demod.pos"],
                                  np.asarray(j_state2.demod.pos))
    j_last, _, _ = _jax_run(re, im, j_back,
                            (jnp.asarray(back["last_re"]),
                             jnp.asarray(back["last_im"])),
                            first_step=2, steps=1)
    p_last, _, _ = _port_run(re, im, p_state, p_carry, first_step=2,
                             steps=1)
    for k in j_last[0]:
        assert np.array_equal(p_last[0][k], j_last[0][k]), k


def test_step_audio_matches_jax(stream):
    """The FM-audio entry point ``step`` on CPU tensors equals JAX's
    ``step`` (impl="xla") on the same audio block."""
    re, im = stream
    C, L = 4, smoke.DMR.block_len
    iq = re[:C, :L] + 1j * im[:C, :L]
    audio, _ = jfm(jnp.asarray(iq), jnp.ones((C,), jnp.complex64))
    audio = np.asarray(audio) * np.float32(smoke.FM_SCALE)
    jp = JPipeline(channels=C, sps=smoke.DMR.sps, n_centuries=smoke.DMR.n_centuries)
    j_out, j_state = jp.step(jnp.asarray(audio), jp.init_state(),
                             impl="xla")
    tp = DmrPipeline(channels=C, sps=smoke.DMR.sps,
                     n_centuries=smoke.DMR.n_centuries, device="cpu")
    p_out, p_state = tp.step(torch.from_numpy(audio), tp.init_state())
    for k in j_out:
        assert np.array_equal(p_out[k].numpy(), np.asarray(j_out[k])), k
    np.testing.assert_array_equal(p_state.demod.pos.numpy(),
                                  np.asarray(j_state.demod.pos))
    # the RRC carry is raw input: bitwise equal
    np.testing.assert_array_equal(p_state.rrc.history.numpy(),
                                  np.asarray(j_state.rrc.history))


def test_step_audio_chain_decodes_the_fixture(committed):
    """The FM-audio path over the fixture: ``smoke.audio`` (the numpy
    discriminator of the same I/Q) through ``step`` in 3 chained blocks,
    rebased with exactly ntaps-1 samples of history, decodes to the
    fields the JAX package got from the I/Q planes."""
    audio = smoke.audio(smoke.DMR, committed["tx_dibits"],
                        committed["noise_seeds"])
    pipe = DmrPipeline(channels=VARIANTS, sps=smoke.DMR.sps,
                       n_centuries=smoke.DMR.n_centuries, device="cpu")
    outs, state = port_audio_chain(pipe, smoke.DMR, audio)
    for s, out in enumerate(outs):
        for k in smoke.DMR.fields:
            assert np.array_equal(out[k], committed[f"expected_{k}"][:, s]), \
                (s, k)
    assert state.rrc.history.shape == (VARIANTS, 80)


def test_step_iq_complex_matches_planes(stream):
    """step_iq splits complex I/Q into planes and runs step_iq_planes."""
    re, im = stream
    C, L = 4, smoke.DMR.block_len
    pipe = DmrPipeline(channels=C, sps=smoke.DMR.sps,
                       n_centuries=smoke.DMR.n_centuries, device="cpu")
    iq = torch.complex(torch.from_numpy(re[:C, :L]),
                       torch.from_numpy(im[:C, :L]))
    last = torch.ones(C, dtype=torch.complex64)
    out_c, carry_c, _ = pipe.step_iq(iq, last, pipe.init_state())
    out_p, carry_p, _ = pipe.step_iq_planes(
        iq.real.contiguous(), iq.imag.contiguous(), torch.ones(C),
        torch.zeros(C), pipe.init_state())
    for k in out_p:
        assert torch.equal(out_c[k], out_p[k]), k
    assert torch.equal(carry_c, torch.complex(*carry_p))


if __name__ == "__main__":
    fx = build_fixture()
    smoke.DMR.fixture.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.DMR.fixture, **fx)
    print(f"wrote {smoke.DMR.fixture} (noise seeds {fx['noise_seeds'].tolist()})")
