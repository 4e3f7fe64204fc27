"""Time-sharded STREAMING steps of the port (``digiham_tpu_torch.parallel.
streaming``): the exact carry ring. For all five protocols and 2 and 4
time shards, two consecutive steps of the port's ``TimeShardedStream`` on a
CPU mesh give the same symbols, dense sync distances (the invalid tail
marked 99 included) and frame fields as the JAX package's on the 8-device
virtual mesh, and the same symbol stream as the port's single-device
``ChannelBank``; also the carry chain alone (no RRC, 4 shards, 3 steps),
the DMR-specific names and the drift-budget check. Audio screened
knife-edge free over every symbol compared (tests/torch_scale.py)."""
import jax
import numpy as np
import pytest
import torch

from digiham_tpu.parallel.streaming import (
    TimeShardedPipeline as JTimeShardedPipeline,
    TimeShardedStream as JTimeShardedStream)
from digiham_tpu_torch.dsp.demod import DemodState
from digiham_tpu_torch.parallel.streaming import (DEFAULT_CPS,
                                                  TimeShardedDmrPipeline,
                                                  TimeShardedDmrStream,
                                                  TimeShardedPipeline,
                                                  TimeShardedStream)
from digiham_tpu_torch.pipeline import (PROTOCOLS, DmrPipeline, FskPipeline,
                                        NxdnPipeline, YsfPipeline)
from digiham_tpu_torch.runtime.channel_bank import ChannelBank
from torch_scale import jax_mesh, port_mesh, screened_audio

torch.set_num_threads(1)

C = 2


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax.devices()


def _single(protocol, cps, use_rrc=True):
    """The port's single-device pipeline of the protocol at cps
    centuries a step (so every block starts on the stream's frame grid)."""
    if protocol == "dmr":
        return DmrPipeline(C, 10, cps, use_rrc=use_rrc, device="cpu")
    if protocol == "ysf":
        return YsfPipeline(C, 10, cps, device="cpu")
    if protocol == "nxdn":
        return NxdnPipeline(C, 20, cps, device="cpu")
    return FskPipeline(C, protocol, n_centuries=cps, device="cpu")


def _cat(outs, key):
    return np.concatenate([np.asarray(o[key]) for o in outs], axis=1)


def _run(protocol, n_time, n_steps, seed, use_rrc=True):
    """(port outs, JAX outs, the port ChannelBank's symbols, pipeline)."""
    cps = DEFAULT_CPS[protocol]
    sp = TimeShardedPipeline(port_mesh((2, n_time)), C, protocol,
                             centuries_per_shard=cps, use_rrc=use_rrc)
    total = n_steps * sp.block_len + sp.h_right + 1200
    x = screened_audio(protocol, C, total, seed,
                       [(0, total, n_steps * sp.symbols_per_block)],
                       filtered=use_rrc)
    outs = TimeShardedStream(sp).push(x)
    j_sp = JTimeShardedPipeline(jax_mesh((2, n_time)), C, protocol,
                                centuries_per_shard=cps, use_rrc=use_rrc)
    j_outs = JTimeShardedStream(j_sp).push(x)
    results = ChannelBank(_single(protocol, cps, use_rrc), [None] * C,
                          device="cpu").push(x)
    return outs, j_outs, _cat(results, "dibits"), sp


def _compare(outs, j_outs, bank_dibits, n_steps, sp):
    assert len(outs) == len(j_outs) == n_steps
    for step, (o, j) in enumerate(zip(outs, j_outs)):
        assert set(o) == set(j), step
        for key in j:
            got = o[key].numpy()
            assert got.shape == np.shape(j[key]), (step, key)
            np.testing.assert_array_equal(
                got.astype(np.int64), np.asarray(j[key]).astype(np.int64),
                err_msg=f"step {step} {key}")
    got = _cat(outs, "dibits")
    n = min(got.shape[1], bank_dibits.shape[1])
    assert n >= n_steps * sp.symbols_per_block - sp.n_time * sp.seg_symbols
    np.testing.assert_array_equal(got[:, :n], bank_dibits[:, :n])


@pytest.mark.parametrize("n_time", [2, 4])
@pytest.mark.parametrize("protocol",
                         ["dmr", "ysf", "nxdn", "dstar", "pocsag"])
def test_time_shards_match_jax_and_channel_bank(devices, protocol, n_time):
    """Full pipeline (RRC where the protocol has one), 2 consecutive
    steps: equal to the JAX package's time-sharded stream output by output
    and to the port's single-device stream symbol by symbol."""
    outs, j_outs, bank_dibits, sp = _run(protocol, n_time, 2,
                                         500 + 10 * n_time)
    _compare(outs, j_outs, bank_dibits, 2, sp)
    if PROTOCOLS[protocol].step_decodes:
        assert any(k not in ("dibits",) and not k.startswith("sync_dist")
                   for k in outs[0])


def test_time_shards_no_rrc(devices):
    """The carry chain alone: no filter stage, 4 shards, 3 steps (the
    third step runs a carry whose pos has gone negative)."""
    outs, j_outs, bank_dibits, sp = _run("dmr", 4, 3, 77, use_rrc=False)
    assert sp.h_left == sp.drift_budget and sp.rrc_design is None
    _compare(outs, j_outs, bank_dibits, 3, sp)


def test_dmr_names_and_shapes(devices):
    """TimeShardedDmrPipeline/TimeShardedDmrStream are the DMR pipeline;
    the halos are ntaps-1 + drift_budget and drift_budget + cps + 2, the
    state lives on the mesh's first device, and a frame-misaligned
    centuries_per_shard is refused."""
    sp = TimeShardedDmrPipeline(port_mesh((2, 2)), C)
    assert TimeShardedDmrStream is TimeShardedStream
    assert (sp.protocol, sp.centuries_per_shard) == ("dmr", 36)
    assert (sp.h_left, sp.h_right) == (80 + 24, 24 + 36 + 2)
    assert sp.block_len == 2 * 36 * 100 * 10 and sp.n_centuries == 72
    state = sp.init_state()
    assert state.pos.device.type == "cpu" and state.pos.dtype == torch.int32
    with pytest.raises(ValueError, match="multiple of 36"):
        TimeShardedPipeline(port_mesh((2, 2)), C, "dmr",
                            centuries_per_shard=30)
    with pytest.raises(ValueError, match="multiple of 24"):
        TimeShardedPipeline(port_mesh((2, 2)), C, "ysf",
                            centuries_per_shard=30)
    with pytest.raises(ValueError, match="unknown protocol"):
        TimeShardedPipeline(port_mesh((2, 2)), C, "p25")


def test_drift_budget_raises(devices):
    """The carried pos must stay inside the halo budget: a carry at the
    budget raises in both packages, one inside it passes."""
    from digiham_tpu.dsp.demod import DemodState as JDemodState
    import jax.numpy as jnp

    sp = TimeShardedPipeline(port_mesh((2, 2)), C, "dmr")
    j_sp = JTimeShardedPipeline(jax_mesh((2, 2)), C, "dmr")
    ring = np.zeros((C, 100), np.float32)
    for pos, fails in (([23, -23], False), ([24, 0], True),
                       ([0, -24], True)):
        pos = np.asarray(pos, np.int32)
        port = DemodState(torch.from_numpy(pos),
                          torch.zeros(C, dtype=torch.int32),
                          torch.from_numpy(ring))
        jax_state = JDemodState(jnp.asarray(pos), jnp.zeros(C, jnp.int32),
                                jnp.asarray(ring))
        for check in (lambda: sp.check_drift(port),
                      lambda: j_sp.check_drift(jax_state)):
            if fails:
                with pytest.raises(RuntimeError, match="halo budget"):
                    check()
            else:
                check()
