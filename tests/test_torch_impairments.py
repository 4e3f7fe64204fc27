"""The port's impairment models (``digiham_tpu_torch/soak/impairments.py``)
and its impaired-RF matrix (``soak/impaired.py``) against the JAX repo's.

- Every function of tools/impairments.py and ``impair``'s composition give
  the same complex64 stream bit for bit on the same seeds; the planar form
  gives the complex form's planes and the bank form row ``c`` the complex
  form at ``seeds[c]``.
- The matrix on 2 channels x 12 frames on the CPU: for each of its 9
  cases, the frames each channel decodes on path B (FM audio through the
  bank) equal those of the JAX test's own chain (tests/test_impaired_rf.py
  ``_ours``: the JAX ``fm_discriminator`` and ``TrackedChannelBank`` at 2
  centuries, pushes of 4,096, flush), rebuilt here without the reference
  harness; a difference is accepted only with a machine verdict of
  ``soak/classify.py`` on the two banks' symbol trajectories over the same
  audio. Path A (raw I/Q through ``step_iq_planes``, K1's plain version)
  decodes the same count as path B on every channel.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import impairments as J  # noqa: E402  (tools/impairments.py)
import jax.numpy as jnp  # noqa: E402
import torch_soak  # noqa: E402
from digiham_tpu.dsp.fm import fm_discriminator as j_fm  # noqa: E402
from digiham_tpu_torch.soak import impaired  # noqa: E402
from digiham_tpu_torch.soak import impairments as P  # noqa: E402
from digiham_tpu_torch.soak import synth  # noqa: E402

torch.set_num_threads(1)

CASES = dict(impaired.CASES)


def _iq(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    return synth.modulate(rng.integers(0, 4, n // 10))


@pytest.mark.parametrize("name,call", [
    ("add_cfo", lambda M, iq: M.add_cfo(iq, -437.5)),
    ("add_multipath", lambda M, iq: M.add_multipath(iq, 3, 0.3, 40.0)),
    ("clip_iq", lambda M, iq: M.clip_iq(iq, 0.9)),
    ("resample_ppm+", lambda M, iq: M.resample_ppm(iq, 120.0)),
    ("resample_ppm-", lambda M, iq: M.resample_ppm(iq, -150.0)),
    ("add_awgn", lambda M, iq: M.add_awgn(iq, 9.0,
                                          np.random.default_rng(5))),
])
def test_each_impairment_equals_the_tool(name, call):
    iq = _iq()
    got, want = call(P, iq), call(J, iq)
    assert got.dtype == want.dtype == np.complex64
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("name", list(CASES) + ["everything"])
def test_impair_composition_equals_the_tool(name):
    kw = CASES.get(name, dict(cfo_hz=-250.0, mp_delay=3, mp_gain=0.3,
                              clip_level=1.2, ppm=-80.0, snr_db=16.0))
    iq = _iq()
    for seed in (0, 11, 12345):
        got, want = P.impair(iq, seed=seed, **kw), J.impair(iq, seed=seed,
                                                            **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["urban_combo", "clock-150ppm", "clean"])
def test_planar_and_bank_forms_equal_the_complex_form(name):
    kw = CASES[name]
    iq = _iq()
    re, im = P.impair_planes(iq.real, iq.imag, seed=7, **kw)
    want = J.impair(iq, seed=7, **kw)
    assert re.dtype == im.dtype == np.float32
    assert np.array_equal(re, want.real) and np.array_equal(im, want.imag)
    seeds = [4, 9, 11]
    re, im = P.impair_bank(iq, seeds, **kw)
    for c, s in enumerate(seeds):
        want = J.impair(iq, seed=s, **kw)
        assert np.array_equal(re[c], want.real)
        assert np.array_equal(im[c], want.imag)


def test_dmr_call_is_the_jax_tests_stream():
    """``synth.dmr_call`` and ``synth.modulate`` are test_impaired_rf's
    ``_tx`` and ``modulate`` (:44-58)."""
    import test_impaired_rf as T

    want_iq, payload = T._tx()
    assert np.array_equal(synth.DMR_PAYLOAD, payload)
    assert np.array_equal(synth.modulate(synth.dmr_call(T.N_FRAMES)),
                          want_iq)


def _jax_audio(iq: np.ndarray) -> np.ndarray:
    """tests/test_impaired_rf.py's ``_audio``: [1, n] float32."""
    a, _ = j_fm(jnp.asarray(iq[None, :]), jnp.ones((1,), jnp.complex64))
    return (np.asarray(a)[0] * 5000.0).astype(np.float32)[None]


def _agree_or_classified(a, b, audio, what):
    """Two runs agree in bytes and events on every channel, or where their
    symbol trajectories part carries a machine verdict."""
    for c in range(audio.shape[0]):
        if a.bytes[c] == b.bytes[c] and a.events[c] == b.events[c]:
            continue
        v = torch_soak.divergence(a.traj.channel(c), b.traj.channel(c),
                                  audio[c], a.bank.pipeline)
        assert v["verdict"] != "UNCLASSIFIED", (what, c, v)


FRAMES = 12
CHANNELS = 2


@pytest.fixture(scope="module")
def port_matrix():
    return impaired.run(channels=CHANNELS, frames=FRAMES, device="cpu",
                        log=lambda text: None)


@pytest.mark.parametrize("name", list(CASES))
def test_impaired_matrix_equals_the_jax_chain(name, port_matrix):
    """The JAX chain (``_ours``: its FM discriminator, its bank at 2
    centuries, pushes of 4,096, flush) and the port's bank agree on the
    same audio; the port's path B counts are its bank's on the port's own
    FM audio, and equal the JAX chain's counts unless the two audios'
    rounding differences part the banks at a classified knife edge. The
    banks hold both channels: a one-channel JAX bank aliases its sample
    buffer (tests/torch_soak.py ``alias_check``)."""
    from digiham_tpu_torch.protocols.dmr.phases import pack_dibits

    want = pack_dibits(synth.DMR_PAYLOAD)
    iq = synth.modulate(synth.dmr_call(FRAMES))
    a = port_matrix["counts"][name, "A"]
    b = port_matrix["counts"][name, "B"]
    assert np.array_equal(a, b), (name, a, b)
    assert not port_matrix["cases"][name]["A"]["unclassified"]
    assert not port_matrix["cases"][name]["B"]["unclassified"]
    streams = [J.impair(iq, seed=impaired.SEED + c, **CASES[name])
               for c in range(CHANNELS)]
    audio_j = np.concatenate([_jax_audio(s) for s in streams])
    audio_p = impaired.fm_audio(
        torch.from_numpy(np.stack([s.real for s in streams])),
        torch.from_numpy(np.stack([s.imag for s in streams])))
    j, p_j = torch_soak.banks("dmr", CHANNELS, n_centuries=2)
    _, p_p = torch_soak.banks("dmr", CHANNELS, n_centuries=2)
    for audio, runs in ((audio_j, (j, p_j)), (audio_p, (p_p,))):
        chunks = list(range(0, audio.shape[1], 4096)) + [audio.shape[1]]
        torch_soak.drive(runs, audio, chunks)
    _agree_or_classified(p_j, j, audio_j, (name, "same audio"))
    assert [o.count(want) for o in p_p.bytes] == list(b)
    if [o.count(want) for o in j.bytes] != list(b):
        _agree_or_classified(p_p, p_j, audio_p, (name, "FM rounding"))
