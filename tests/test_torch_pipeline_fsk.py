"""The port's 2FSK pipeline against the JAX package's: ``FskPipeline.step``
over 3 chained blocks (smoke.rebase_audio's rules) for D-Star (sps 10) and
POCSAG (sps 40, inverted) — bits, sync distances, pos, offset and ring —
without an RRC (kernel K3's plain version), with an RRC design (K2's, fsk
mode), POCSAG at sps 20 and 94, a mid-stream hand-off of a 3-leaf state
through ``digiham_tpu_torch.convert``, and the committed smoke fixtures
``data/{dstar,pocsag}_smoke.npz`` rebuilt from tests/torch_fsk.py's
variants plus the JAX pipeline. Integers are exact; the volume ring is
within 1e-3 (f32 summation order).

Rebuild the fixtures with
``PYTHONPATH=.:tests python tests/test_torch_pipeline_fsk.py``.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp.rrc import WIDE_RRC as J_WIDE_RRC
from digiham_tpu.pipeline import fsk as j_fsk
from digiham_tpu_torch import convert, smoke
from digiham_tpu_torch.dsp.rrc import WIDE_RRC
from digiham_tpu_torch.pipeline import FskPipeline
from digiham_tpu_torch.pipeline.fsk import FskPipelineState

sys.path.insert(0, os.path.dirname(__file__))
import torch_fsk  # noqa: E402
from torch_parity import (VARIANTS, assert_fields_equal,  # noqa: E402
                          audio_stream_knife_edge_free, build_audio_fixture,
                          jax_audio_chain, port_audio_chain)

torch.set_num_threads(1)

RING_ATOL = 1e-3
STREAMS = {"dstar": smoke.DSTAR, "pocsag": smoke.POCSAG}
VARIANT_OF = {"dstar": torch_fsk.dstar_variant,
              "pocsag": torch_fsk.pocsag_variant}


def _n_bits(stream) -> int:
    return -(-stream.stream_len // stream.sps) + 1


def _jax_chain(protocol, stream, samples, rrc=None, **kw):
    pipe = j_fsk.FskPipeline(samples.shape[0], protocol,
                             n_centuries=stream.n_centuries, rrc=rrc,
                             sps=stream.sps)
    return jax_audio_chain(pipe, j_fsk.FskPipelineState, stream, samples,
                           **kw)


def _port_chain(protocol, stream, samples, rrc=None, **kw):
    pipe = FskPipeline(samples.shape[0], protocol,
                       n_centuries=stream.n_centuries, rrc=rrc,
                       sps=stream.sps, device="cpu")
    return port_audio_chain(pipe, stream, samples, **kw)


def build_fixture(protocol, noise_seeds=None) -> dict:
    stream = STREAMS[protocol]
    return build_audio_fixture(
        stream, None, lambda v: VARIANT_OF[protocol](v, _n_bits(stream)),
        lambda x: _jax_chain(protocol, stream, x)[0], noise_seeds,
        mode="fsk", invert=protocol == "pocsag")


@pytest.fixture(scope="module", params=sorted(STREAMS))
def case(request):
    """(protocol, stream, committed fixture, its audio [V, stream_len])."""
    stream = STREAMS[request.param]
    fx = smoke.load(stream)
    return (request.param, stream, fx,
            smoke.audio(stream, fx["tx_dibits"], fx["noise_seeds"]))


def test_fixture_rebuilds_exactly(case):
    """The committed fixture equals a fresh build from torch_fsk and the
    JAX pipeline with its stored seeds, and every stream is knife-edge
    free."""
    protocol, stream, committed, samples = case
    fresh = build_fixture(protocol, committed["noise_seeds"])
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        assert fresh[k].dtype == committed[k].dtype, k
        assert np.array_equal(fresh[k], committed[k]), k
    for v in range(VARIANTS):
        assert audio_stream_knife_edge_free(
            stream, None, samples[v], "fsk", protocol == "pocsag"), v


def test_fixture_holds_the_syncs(case):
    """The stream is worth checking: the demodulated bits are the TX bits
    (up to the demod's start-up), and the syncs of the transmissions are
    found at distance 0."""
    protocol, stream, committed, _ = case
    bits = committed["expected_dibits"].reshape(VARIANTS, -1)
    tx = committed["tx_dibits"][:, :bits.shape[1]]
    # every symbol after the first century matches the TX bit one apart
    # at most (the demod's start-up offset)
    lag = [min(range(3), key=lambda d, v=v: int(
        (bits[v, 100:-3] != tx[v, 100 - d:-3 - d]).sum()))
        for v in range(VARIANTS)]
    errors = [int((bits[v, 100:-3] != tx[v, 100 - lag[v]:-3 - lag[v]]).sum())
              for v in range(VARIANTS)]
    noisy = {"dstar": torch_fsk.D_ERRORS, "pocsag": torch_fsk.P_ERRORS}
    assert all(e == 0 for v, e in enumerate(errors) if v != noisy[protocol])
    names = [f for f in stream.fields if f.startswith("sync_dist_")]
    for name in names:
        assert (committed[f"expected_{name}"] == 0).any(), name


def test_step_matches_jax(case):
    """Every output field of every chained block equals JAX's: keys,
    dtypes, shapes and values; the final state too (no RRC: None)."""
    protocol, stream, committed, samples = case
    j_outs, j_state = _jax_chain(protocol, stream, samples)
    p_outs, p_state = _port_chain(protocol, stream, samples)
    for s, (jo, po) in enumerate(zip(j_outs, p_outs)):
        assert_fields_equal(po, jo, s)
        for k in stream.fields:
            assert np.array_equal(jo[k], committed[f"expected_{k}"][:, s])
    assert p_state.rrc is None and j_state.rrc is None
    assert np.array_equal(p_state.demod.pos.numpy(),
                          np.asarray(j_state.demod.pos))
    assert np.array_equal(p_state.demod.offset.numpy(),
                          np.asarray(j_state.demod.offset))
    assert np.abs(p_state.demod.volume_ring.numpy()
                  - np.asarray(j_state.demod.volume_ring)).max() <= RING_ATOL


def _screened(stream, protocol, tx, design, first_seed):
    """Per row, the first noise seed whose stream is knife-edge free."""
    seeds = []
    for v in range(len(tx)):
        seed = first_seed + 100 * v
        while not audio_stream_knife_edge_free(
                stream, design, smoke.audio(stream, tx[v:v + 1], [seed])[0],
                "fsk", protocol == "pocsag"):
            seed += 1
        seeds.append(seed)
    return seeds


@pytest.mark.parametrize("protocol,sps,n_centuries,rrc", [
    ("dstar", 10, 2, True),     # K2 in fsk mode
    ("pocsag", 40, 2, True),    # K2 in fsk mode, inverted
    ("pocsag", 20, 3, False),   # 2400 baud
    ("pocsag", 94, 2, False),   # 512 baud
])
def test_other_shapes_match_jax(protocol, sps, n_centuries, rrc):
    """FskPipeline with an RRC design (the RRC -> demod segment: K2 on the
    card), and POCSAG at the other baud rates (K3 up to sps 94): chained
    blocks equal JAX's, the RRC history is the raw input tail."""
    stream = dataclasses.replace(STREAMS[protocol], sps=sps,
                                 n_centuries=n_centuries)
    tx = np.stack([VARIANT_OF[protocol](v, _n_bits(stream))
                   for v in (0, 3)])
    design = WIDE_RRC if rrc else None
    samples = smoke.audio(stream, tx, _screened(stream, protocol, tx, design,
                                                300 + sps))
    j_outs, j_state = _jax_chain(protocol, stream, samples,
                                 J_WIDE_RRC if rrc else None)
    p_outs, p_state = _port_chain(protocol, stream, samples, design)
    for s, (jo, po) in enumerate(zip(j_outs, p_outs)):
        assert_fields_equal(po, jo, s)
        assert po["dibits"].shape == (2, n_centuries * 100)
    assert np.array_equal(p_state.demod.pos.numpy(),
                          np.asarray(j_state.demod.pos))
    if rrc:
        assert np.array_equal(p_state.rrc.history.numpy(),
                              np.asarray(j_state.rrc.history))
    else:
        assert p_state.rrc is None


def test_convert_handoff_midstream(case):
    """JAX runs the first block; its 3-leaf state (no RRC) crosses to the
    port through convert.from_jax, the port runs the second and matches
    JAX's own continuation; the port's state crosses back through
    convert.to_numpy (3 arrays) and JAX continues from it equally."""
    from digiham_tpu.dsp.demod import DemodState

    protocol, stream, _, samples = case
    x = samples[:4]
    _, j_state = _jax_chain(protocol, stream, x, steps=1)
    state, carry = convert.from_jax(j_state, device="cpu")
    assert carry is None and isinstance(state, FskPipelineState)
    assert state.rrc is None
    p_outs, p_state = _port_chain(protocol, stream, x, state=state,
                                  first_step=1, steps=1)
    j_rest, _ = _jax_chain(protocol, stream, x, state=j_state, first_step=1,
                           steps=1)
    assert_fields_equal(p_outs[0], j_rest[0])

    back = convert.to_numpy(p_state)
    assert sorted(back) == ["demod.offset", "demod.pos", "demod.volume_ring"]
    j_back = j_fsk.FskPipelineState(
        None, DemodState(jnp.asarray(back["demod.pos"]),
                         jnp.asarray(back["demod.offset"]),
                         jnp.asarray(back["demod.volume_ring"])))
    j_last, _ = _jax_chain(protocol, stream, x, state=j_back, first_step=2,
                           steps=1)
    p_last, _ = _port_chain(protocol, stream, x, state=p_state, first_step=2,
                            steps=1)
    assert_fields_equal(p_last[0], j_last[0])


def test_chained_steps_launch_nothing_on_the_cpu(case):
    from digiham_tpu_torch.ops import demod_front, fir, viterbi as k5

    protocol, stream, _, samples = case
    before = (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES)
    outs, _ = _port_chain(protocol, stream, samples[:2])
    assert len(outs) == smoke.STEPS
    assert (dict(demod_front.LAUNCHES), fir.LAUNCHES, k5.LAUNCHES) == before


@pytest.mark.parametrize("rrc", [None, WIDE_RRC], ids=["no_rrc", "rrc"])
def test_checkpoint_round_trip(rrc):
    """An FskPipelineState saves and loads field for field, its RRC as
    None where the pipeline has none; a blob that lacks a tensor raises."""
    import io
    import pickle

    from digiham_tpu_torch.runtime.checkpoint import load_state, save_state

    pipe = FskPipeline(3, "pocsag", rrc=rrc, device="cpu")
    state = pipe.init_state()
    state.demod.pos += torch.tensor([1, 2, 3], dtype=torch.int32)
    back = load_state(save_state(state), device="cpu")
    assert type(back) is FskPipelineState
    assert (back.rrc is None) == (rrc is None)
    if rrc is not None:
        assert torch.equal(back.rrc.history, state.rrc.history)
    for k in ("pos", "offset", "volume_ring"):
        assert torch.equal(getattr(back.demod, k), getattr(state.demod, k))
    payload = pickle.loads(save_state(state))
    with np.load(io.BytesIO(payload["npz"])) as npz:
        arrays = {k: npz[k] for k in npz.files if k != "demod.pos"}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload["npz"] = buf.getvalue()
    with pytest.raises(KeyError):
        load_state(pickle.dumps(payload), device="cpu")


@pytest.mark.parametrize("protocol", sorted(STREAMS))
def test_pipeline_surface(protocol):
    """The attributes the bank and the stream runtime read, the JAX
    pipeline's defaults, buffers that give a pipeline without an RRC its
    device, and ``step_symbols`` the same as ``step``; an unknown protocol
    raises."""
    pipe = FskPipeline(3, protocol, n_centuries=2, device="cpu")
    ref = j_fsk.FskPipeline(3, protocol, n_centuries=2)
    assert (pipe.sps, pipe.invert, pipe.protocol, pipe.n_centuries,
            pipe.symbols_per_block) == (ref.sps, ref.invert, ref.protocol,
                                        ref.n_centuries,
                                        ref.symbols_per_block)
    assert pipe.rrc_design is None and not pipe.use_rrc
    assert pipe.device == torch.device("cpu")
    names = {n for n, _ in pipe.named_buffers()}
    assert {f"sync_{k}" for k in ref.patterns} <= names
    assert "rrc_taps" not in names
    state = pipe.init_state()
    assert state.rrc is None and state.demod.pos.shape == (3,)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 500, (3, 2 * (100 * pipe.sps + 1) + 2)).astype(np.float32))
    a, sa = pipe.step(x, state)
    b, sb = pipe.step_symbols(x, state)
    assert sorted(a) == sorted(b) == ["dibits"] + [
        f"sync_dist_{k}" for k in ref.patterns]
    assert all(torch.equal(a[k], b[k]) for k in a)
    with_rrc = FskPipeline(3, protocol, rrc=WIDE_RRC, device="cpu")
    assert with_rrc.use_rrc and with_rrc.rrc_design is WIDE_RRC
    assert with_rrc.init_state().rrc.history.shape == (3, WIDE_RRC.ntaps - 1)
    assert FskPipeline(3, "pocsag", sps=94, device="cpu").sps == 94
    with pytest.raises(ValueError):
        FskPipeline(3, "dmr", device="cpu")


if __name__ == "__main__":
    for protocol, stream in STREAMS.items():
        fx = build_fixture(protocol)
        stream.fixture.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(stream.fixture, **fx)
        print(f"wrote {stream.fixture} (noise seeds "
              f"{fx['noise_seeds'].tolist()})")
