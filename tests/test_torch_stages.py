"""The stage split of the raw-IQ DMR step (``digiham_tpu_torch/bench/
stages.py``, the port of tools/profile_pipeline.py and the fused row of
tools/profile_fused.py) on the CPU:

- every cutoff at 2 channels x 2 centuries over 2 windows of one base
  stream equals the same chain composed from the JAX package's functions
  as tools/profile_pipeline.py :45-84 composes it (and profile_fused.py's
  ``full_body`` for ``fused``), on the same numpy planes: each step's float
  sum (``gen``, ``fm``, ``rrc``) within 1e-5 relative, each step's dibit,
  sync and field sum (``demod``, ``sync``, ``full``, ``fused``) exactly,
  and the rep's checksum within 1e-5 relative (exactly for ``fused``);
- ``main(["--device", "cpu", ...])`` prints the seven cutoffs in order,
  each ``"correct": true`` with distinct rep checksums and the JAX tool's
  keys; without a card it exits 1;
- a row's ``correct`` comes from its plain check: a K3 wrapper whose
  dibits differ from its plain version's fails the ``demod`` cutoff, and
  the program prints the failure line and no row after it.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digiham_tpu.dsp.demod import gfsk_demod_block as j_demod
from digiham_tpu.dsp.fm import fm_discriminator as j_fm
from digiham_tpu.dsp.rrc import WIDE_RRC as J_WIDE, rrc_filter_block as j_rrc
from digiham_tpu.pipeline import DmrPipeline as JDmrPipeline
from digiham_tpu.pipeline.dmr import (FRAME_SIZE, dmr_decode_frames,
                                      dmr_sync_correlate)
from digiham_tpu_torch.bench import common, stages
from digiham_tpu_torch.pipeline import DmrPipeline

torch.set_num_threads(1)

C, NC, SPS, STEPS = 2, 2, 10, 2
L = NC * (100 * SPS + 1) + 8
RTOL = 1e-5  # float32 sums in another order than XLA's


def jax_run(stage, n_cent, channels):
    """tools/profile_pipeline.py's ``subset_step(stage)`` (:45-84) and
    profile_fused.py's ``full_body`` (:110-117) for ``fused``."""
    pipe = JDmrPipeline(channels=channels, sps=SPS, n_centuries=n_cent)

    def run(iq, last_iq, state):
        if stage == "gen":
            return jnp.abs(iq).sum(), last_iq, state
        if stage == "fused":
            out, last_iq, state = pipe.step_iq(iq, last_iq, state)
            s = (out["dibits"].astype(jnp.int32).sum()
                 + out["sync_dist_dense"].sum()
                 + out["voice_payload"].astype(jnp.int32).sum())
            return s, last_iq, state
        audio, iq_carry = j_fm(iq, last_iq)
        audio = audio * 5000.0
        if stage == "fm":
            return audio.sum(), iq_carry, state
        filtered, rrc_state = j_rrc(audio, state.rrc, J_WIDE)
        if stage == "rrc":
            return filtered.sum(), iq_carry, state
        dibits, demod_state = j_demod(filtered, state.demod, n_cent, SPS)
        state = dataclasses.replace(state, rrc=rrc_state, demod=demod_state)
        if stage == "demod":
            return dibits.astype(jnp.int32).sum(), iq_carry, state
        sync = dmr_sync_correlate(dibits)
        if stage == "sync":
            return dibits.astype(jnp.int32).sum() + sync.sum(), iq_carry, \
                state
        n_frames = n_cent * 100 // FRAME_SIZE
        frames = dibits[:, :n_frames * FRAME_SIZE].reshape(
            channels, n_frames, FRAME_SIZE)
        fields = dmr_decode_frames(frames)
        acc = (dibits.astype(jnp.int32).sum() + sync.sum()
               + fields["voice_payload"].astype(jnp.int32).sum()
               + fields["bptc_data"].sum() + fields["sync_type"].sum()
               + fields["tact_slot"].sum())
        return acc, iq_carry, state

    return pipe, run


def jax_steps(stage, re, im, n_cent, steps):
    """``step_k`` of the JAX tools over the same base planes: each step's
    scalar, and the rep's checksum."""
    channels = re.shape[0]
    pipe, run = jax_run(stage, n_cent, channels)
    base = (re + 1j * im).astype(np.complex64)
    state = pipe.init_state()
    last_iq = jnp.ones((channels,), jnp.complex64)
    fused = stage == "fused"
    acc = jnp.int32(0) if fused else jnp.float32(0)
    values = []
    for k in range(steps):
        iq = jnp.asarray(base[:, k * common.STRIDE:k * common.STRIDE + L])
        s, last_iq, state = run(iq, last_iq, state)
        values.append(s)
        acc = acc + (s if fused else s.astype(jnp.float32))
        state.demod.pos = jnp.zeros_like(state.demod.pos)
    if fused:
        return values, acc
    return values, (acc + state.demod.offset.sum()
                    + state.demod.volume_ring.sum() + state.rrc.history.sum())


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(14)
    n = L + common.STRIDE * (STEPS - 1)
    return (rng.normal(size=(C, n)).astype(np.float32),
            rng.normal(size=(C, n)).astype(np.float32))


@pytest.mark.parametrize("stage", stages.CUTOFFS)
def test_cutoff_equals_the_jax_tools_chain(stage, planes):
    re, im = planes
    pipe = DmrPipeline(channels=C, sps=SPS, n_centuries=NC, device="cpu")
    got_acc, got = stages.stage_steps(stage, pipe, torch.from_numpy(re),
                                      torch.from_numpy(im), L, STEPS)
    want, want_acc = jax_steps(stage, re, im, NC, STEPS)
    assert len(got) == len(want) == STEPS
    for k, (g, w) in enumerate(zip(got, want)):
        if stage in stages.FLOAT_CUTOFFS:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL,
                                       err_msg=f"{stage} step {k}")
        else:
            assert g.dtype == torch.int64 and w.dtype == jnp.int32
            assert int(g) == int(w), (stage, k)
    if stage == "fused":
        assert int(got_acc) == int(want_acc)
    else:
        np.testing.assert_allclose(float(got_acc), float(want_acc),
                                   rtol=RTOL)


def test_main_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = stages.main(["--device", "cpu", "--channels", "4",
                          "--centuries", "2", "--steps", "2", "--reps", "2"])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert rc == 0, lines
    assert [ln["stage_cutoff"] for ln in lines] == list(stages.CUTOFFS)
    for i, ln in enumerate(lines):
        assert ln["correct"] is True and ln["backend"] == "cpu", ln
        assert ln["distinct_checksums"] == 2
        assert ln["per_step_ms"] > 0 and ln["msps"] > 0
        assert (ln["delta_ms"] is None) == (i == 0)
        assert ln["launches_per_step"] == {}  # the plain versions
        assert ln["gate"]["path"] == "step_iq_planes"
        assert ln["plain_check"]["equal"] is True


def test_a_kernel_unlike_its_plain_version_fails_its_cutoff(monkeypatch):
    from digiham_tpu_torch.ops import demod_front

    plain = demod_front.demod

    def wrong(*args, **kw):
        dibits, *rest = plain(*args, **kw)
        return (dibits ^ 1, *rest)

    monkeypatch.setattr(demod_front, "demod", wrong)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = stages.main(["--device", "cpu", "--channels", "2",
                          "--centuries", "2", "--steps", "2", "--reps", "2"])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert rc == 1
    assert [ln.get("stage_cutoff") for ln in lines[:-1]] == [
        "gen", "fm", "rrc"]
    assert lines[-1]["correct"] is False and lines[-1]["value"] is None
    assert "demod" in lines[-1]["error"]


def test_no_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = stages.main([])
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 1 and line["value"] is None and "error" in line
