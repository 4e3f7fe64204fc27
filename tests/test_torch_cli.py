"""The port's ten pipe tools (``digiham_tpu_torch/cli``) against the JAX
package's on the same input, on the CPU, and the fixture the card's run
holds them to (``digiham_tpu_torch/data/cli_smoke.npz``).

Each example chain of examples/*.sh (``smoke.CLI_CHAINS``: DMR, YSF,
NXDN48, D-Star, POCSAG, each fed one variant of its bank fixture's stream)
is run stage by stage, in-process (``tests/torch_cli.py``: patched stdin,
stdout and argv). The fixture holds each stage's output from the JAX
package's tools on their ``--backend jax`` route; the port's tools take
the stage's fixture input, with ``--backend cpu`` (the torch code the card
runs, with the kernels' plain versions) and ``--backend numpy`` (the host
oracles, held to the JAX tools' ``--backend numpy`` bytes, run here).

Tolerances and why:

- demodulator symbols (flush tail included), decoder bytes, metadata text,
  POCSAG messages, ``mbe_synthesizer``'s PCM: equal;
- ``rrc_filter``: within rtol 1e-4, atol 2e-2, the envelope the JAX
  package holds its own two backends to (tests/test_cli.py:116-124): the
  port sums tap by tap, XLA's convolution in its own order;
- ``digitalvoice_filter``: within 2 LSB at speech level and 8 LSB (1 per
  4,096 of full scale) on full-scale input, the stand-in's echoed bytes or
  the overdriven stretch, saturating where JAX's does
  (tests/test_torch_audio.py says why); the numpy oracle byte for byte.

Rebuild the fixture with ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_cli.py``; ``test_fixture_rebuilds_exactly`` fails if it
drifts.
"""
import os
import shlex
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

from digiham_tpu.cli import tools as jax_tools  # noqa: E402
from digiham_tpu.dsp import audio as j_audio  # noqa: E402
from digiham_tpu_torch import smoke  # noqa: E402
from digiham_tpu_torch.cli import tools  # noqa: E402
from digiham_tpu_torch.codec.mbe import ConnectionError_  # noqa: E402
from torch_cli import patched_io, run_tool  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("rrc_filter", "fsk_demodulator", "gfsk_demodulator",
         "digitalvoice_filter", "dmr_decoder", "ysf_decoder",
         "dstar_decoder", "nxdn_decoder", "pocsag_decoder",
         "mbe_synthesizer")
DSP_TOOLS = TOOLS[:4]
JAX = {n: getattr(jax_tools, f"{n}_main") for n in TOOLS}
PORT = {n: getattr(tools, f"{n}_main") for n in TOOLS}
CHAINS = {c.name: c for c in smoke.CLI_CHAINS}
FOUR_FSK = [c.name for c in smoke.CLI_CHAINS if c.rrc is not None]
VOICE = [c.name for c in smoke.CLI_CHAINS if c.voice]
RRC_RTOL, RRC_ATOL = 1e-4, 2e-2
SPEECH_LSB, FULL_SCALE_LSB = 2, 8


def build_fixture() -> dict:
    """Every chain through the JAX package's tools, in-process on the CPU,
    checking that each chain's frames decode (its bank variant's voice
    bytes and events)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            smoke.CodecStandIn(os.path.join(tmp, "codec.sock")) as server:
        for chain in smoke.CLI_CHAINS:
            n = chain.name
            data = smoke.cli_audio(chain).tobytes()
            if chain.rrc is not None:
                data = run_tool(JAX["rrc_filter"],
                                [*chain.rrc, "--backend", "jax"], data)
                out[f"{n}_filtered"] = np.frombuffer(data, np.float32)
            symbols = run_tool(JAX[chain.demod],
                               [*chain.demod_args, "--backend", "jax"], data)
            out[f"{n}_symbols"] = np.frombuffer(symbols, np.uint8)
            meta = os.path.join(tmp, f"{n}.meta")
            decoded = run_tool(JAX[chain.decoder],
                               ["-f", meta] if chain.meta else [], symbols)
            text = open(meta, "rb").read() if chain.meta else b""
            voice, events = smoke.bank_expected(smoke.load(chain.bank),
                                                chain.variant)
            assert decoded and decoded == voice, n
            assert text.decode() == events, n
            out[f"{n}_decoded"] = np.frombuffer(decoded, np.uint8)
            out[f"{n}_meta"] = np.frombuffer(text, np.uint8)
            if chain.voice:
                speech = smoke.stand_in_speech(decoded)
                pcm = run_tool(JAX["mbe_synthesizer"], ["-s", server.path],
                               decoded, wait_for=len(speech))
                assert pcm == speech, n
                out[f"{n}_pcm"] = np.frombuffer(pcm, np.int16)
                out[f"{n}_voice"] = np.frombuffer(run_tool(
                    JAX["digitalvoice_filter"], ["--backend", "jax"], pcm),
                    np.int16)
    out["voice_out"] = np.frombuffer(run_tool(
        JAX["digitalvoice_filter"], ["--backend", "jax"],
        smoke.voice_pcm().tobytes()), np.int16)
    fx = smoke.load(smoke.DMR_BANK)
    voices = [smoke.bank_expected(fx, v)[0]
              for v in range(fx["tx_dibits"].shape[0])]
    pcm = smoke.bank_voice_pcm(voices)
    y, _ = j_audio.digitalvoice_filter(
        jnp.asarray(pcm), j_audio.DigitalVoiceState.init(pcm.shape[0]))
    out["bank_voice"] = np.asarray(y)
    return out


@pytest.fixture(scope="module")
def fx():
    with np.load(smoke.CLI_FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def stand_in():
    with tempfile.TemporaryDirectory() as tmp, \
            smoke.CodecStandIn(os.path.join(tmp, "codec.sock")) as server:
        yield server


def _stage_input(fx, chain):
    """The demodulator's input: the JAX-filtered audio, or the raw audio
    where the chain has no RRC."""
    if chain.rrc is not None:
        return fx[f"{chain.name}_filtered"].tobytes()
    return smoke.cli_audio(chain).tobytes()


def _lsb(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape
    return int(np.abs(a - b).max()) if a.size else 0


def test_fixture_rebuilds_exactly(fx):
    built = build_fixture()
    assert sorted(built) == sorted(fx)
    for k, v in built.items():
        assert v.dtype == fx[k].dtype and np.array_equal(v, fx[k]), k


def test_chain_inputs_are_their_bank_variants():
    for chain in smoke.CLI_CHAINS:
        fxb = smoke.load(chain.bank)
        assert np.array_equal(smoke.cli_audio(chain),
                              smoke.bank_audio(chain.bank, fxb)[
                                  chain.variant]), chain.name


@pytest.mark.parametrize("name", FOUR_FSK)
def test_rrc_filter_cpu_within_the_envelope(fx, name):
    chain = CHAINS[name]
    audio = smoke.cli_audio(chain).tobytes()
    got = np.frombuffer(run_tool(PORT["rrc_filter"],
                                 [*chain.rrc, "--backend", "cpu"], audio),
                        np.float32)
    np.testing.assert_allclose(got, fx[f"{name}_filtered"], rtol=RRC_RTOL,
                               atol=RRC_ATOL)


@pytest.mark.parametrize("name", FOUR_FSK)
def test_rrc_filter_numpy_equals_jax(name):
    chain = CHAINS[name]
    audio = smoke.cli_audio(chain).tobytes()
    args = [*chain.rrc, "--backend", "numpy"]
    assert run_tool(PORT["rrc_filter"], args, audio) == run_tool(
        JAX["rrc_filter"], args, audio)


@pytest.mark.parametrize("backend", ["cpu", "numpy"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_demodulator_bytes_equal(fx, name, backend):
    """Symbols, the flush tail included: --backend cpu against the JAX
    tool's device route (the fixture), numpy against its numpy route."""
    chain = CHAINS[name]
    data = _stage_input(fx, chain)
    args = [*chain.demod_args, "--backend", backend]
    got = run_tool(PORT[chain.demod], args, data)
    if backend == "numpy":
        assert got == run_tool(JAX[chain.demod], args, data)
    assert got == fx[f"{name}_symbols"].tobytes()


@pytest.mark.parametrize("name", list(CHAINS))
def test_decoder_bytes_and_metadata_equal(fx, name, tmp_path):
    chain = CHAINS[name]
    meta = str(tmp_path / "meta")
    got = run_tool(PORT[chain.decoder], ["-f", meta] if chain.meta else [],
                   fx[f"{name}_symbols"].tobytes())
    assert got == fx[f"{name}_decoded"].tobytes()
    if chain.meta:
        assert open(meta, "rb").read() == fx[f"{name}_meta"].tobytes()
    if name == "pocsag":
        assert b"message:" in got


@pytest.mark.parametrize("name", VOICE)
def test_mbe_synthesizer_against_the_stand_in(fx, stand_in, name):
    got = run_tool(PORT["mbe_synthesizer"], ["-s", stand_in.path],
                   fx[f"{name}_decoded"].tobytes())
    assert got == fx[f"{name}_pcm"].tobytes()


@pytest.mark.parametrize("name", VOICE + ["voice"])
def test_digitalvoice_filter_cpu_within_the_envelope(fx, name):
    """The chains' PCM (the stand-in's echoed bytes: full scale) within
    8 LSB; the speech stretches of the post-filter's own input within 2,
    its overdriven stretch within 8 and on the rails where JAX's is."""
    pcm = smoke.voice_pcm() if name == "voice" else fx[f"{name}_pcm"]
    want = fx["voice_out" if name == "voice" else f"{name}_voice"]
    got = np.frombuffer(run_tool(PORT["digitalvoice_filter"],
                                 ["--backend", "cpu"], pcm.tobytes()),
                        np.int16)
    assert _lsb(got, want) <= FULL_SCALE_LSB
    if name == "voice":
        loud = np.zeros(len(pcm), bool)
        loud[np.flatnonzero(np.abs(pcm) > 16384).min():] = True
        ring = np.flatnonzero(np.abs(pcm) > 16384).max() + 2000
        speech = ~loud
        speech[ring:] = True
        assert _lsb(got[speech], want[speech]) <= SPEECH_LSB
        rails = (want == 32767) | (want == -32768)
        assert rails.any() and np.array_equal(got[rails], want[rails])


@pytest.mark.parametrize("name", VOICE + ["voice"])
def test_digitalvoice_filter_numpy_equals_jax(fx, name):
    pcm = (smoke.voice_pcm() if name == "voice" else fx[f"{name}_pcm"])
    args = ["--backend", "numpy"]
    assert run_tool(PORT["digitalvoice_filter"], args, pcm.tobytes()) \
        == run_tool(JAX["digitalvoice_filter"], args, pcm.tobytes())


@pytest.mark.parametrize("name", list(CHAINS))
def test_whole_chain_cpu(fx, stand_in, name, tmp_path):
    """The port's tools chained in-process from the chain's audio."""
    chain = CHAINS[name]
    data = smoke.cli_audio(chain).tobytes()
    meta = str(tmp_path / "meta")
    for tool, args in chain.tools():
        args = [a.format(meta=meta, server=stand_in.path) for a in args]
        if tool in DSP_TOOLS:
            args.append("--backend=cpu")
        data = run_tool(PORT[tool], args, data)
        if tool == chain.decoder:
            assert data == fx[f"{name}_decoded"].tobytes()
            if chain.meta:
                assert open(meta, "rb").read() == fx[f"{name}_meta"].tobytes()
        elif tool == "mbe_synthesizer":
            assert data == fx[f"{name}_pcm"].tobytes()
    if chain.voice:
        assert _lsb(np.frombuffer(data, np.int16),
                    fx[f"{name}_voice"]) <= FULL_SCALE_LSB


def test_dmr_decoder_control_fifo_sets_the_slot_filter(tmp_path):
    """-c: a thread reads slot filters 0-3 from the control file and sets
    them on the decoder; anything else is refused (dmr_cli.cpp:57-78)."""
    control = tmp_path / "control"
    control.write_text("1\n7\n")
    cli = tools.DmrDecoderCli()
    with patched_io(["dmr_decoder"], b""):
        assert cli.main(["-c", str(control)]) == 0
    deadline = time.monotonic() + 5
    while cli.decoder.slot_filter == 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # the refused 7 follows
    assert cli.decoder.slot_filter == 1


@pytest.mark.parametrize("corrupt", [1, 2])
@pytest.mark.parametrize("rs129", [False, True])
def test_dmr_decoder_rs129_flag_equals_the_jax_switch(rs129, corrupt,
                                                      monkeypatch, tmp_path):
    """``dmr_decoder --rs129`` gives the bytes and metadata the JAX tool
    gives under ``DIGIHAM_DMR_RS129=1``, and without the flag what it gives
    without the switch, on a stream whose voice LC header carries one
    correctable byte error (``corrupt`` 1) or two, which the check drops
    (tests/test_rs129.py's stream)."""
    from test_rs129 import _stream

    data = np.concatenate(_stream(corrupt_lc_bits=corrupt)).astype(
        np.uint8).tobytes()
    port_meta, jax_meta = tmp_path / "port", tmp_path / "jax"
    got = run_tool(PORT["dmr_decoder"], ["-f", str(port_meta)]
                   + (["--rs129"] if rs129 else []), data)
    if rs129:
        monkeypatch.setenv("DIGIHAM_DMR_RS129", "1")
    else:
        monkeypatch.delenv("DIGIHAM_DMR_RS129", raising=False)
    want = run_tool(JAX["dmr_decoder"], ["-f", str(jax_meta)], data)
    assert got == want and got
    meta = port_meta.read_bytes()
    assert meta == jax_meta.read_bytes()
    corrected = b"source:3141592" in meta and b"target:91" in meta
    assert corrected == (rs129 and corrupt == 1)


def test_mbe_synthesizer_test_flag(stand_in, capsys):
    with pytest.raises(SystemExit) as exit_:
        run_tool(PORT["mbe_synthesizer"], ["-t", "-s", stand_in.path], b"")
    assert exit_.value.code == 0
    assert "server response ok" in capsys.readouterr().err


def test_mbe_synthesizer_without_a_server_raises(tmp_path):
    with pytest.raises(ConnectionError_):
        run_tool(PORT["mbe_synthesizer"],
                 ["-s", str(tmp_path / "missing.sock")], b"")


@pytest.mark.parametrize("tool", DSP_TOOLS)
def test_cuda_backend_without_a_card_exits(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exit_:
        run_tool(PORT[tool], [], b"\0" * 64)  # --backend cuda by default
    assert exit_.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(exit_.value.code)


LAUNCH = textwrap.dedent("""
    import sys
    from digiham_tpu_torch.cli import tools
    main = getattr(tools, sys.argv[1] + "_main")
    sys.argv = sys.argv[1:]
    sys.exit(main())
""")


def _pipe(stages, stdin_path, stdout_path, env):
    """``stages`` (tool, args) as one shell pipe of fresh interpreters."""
    cmd = " | ".join(
        shlex.join([sys.executable, "-c", LAUNCH, tool, *map(str, args)])
        for tool, args in stages)
    return subprocess.run(
        ["bash", "-c", f"set -o pipefail; < {shlex.quote(str(stdin_path))} "
                       f"{cmd} > {shlex.quote(str(stdout_path))}"],
        env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("name,backend", [("dmr", "cpu"),
                                          ("pocsag", "numpy")])
def test_subprocess_pipe(fx, stand_in, name, backend, tmp_path):
    """The chain as a real shell pipe of the port's tools, one process a
    stage (examples/*.sh with the ``_torch`` scripts)."""
    chain = CHAINS[name]
    src, dst = tmp_path / "in.f32", tmp_path / "out.bin"
    smoke.cli_audio(chain).tofile(src)
    meta = tmp_path / "meta"
    stages = [(tool, [a.format(meta=meta, server=stand_in.path)
                      for a in args]
               + (["--backend", backend] if tool in DSP_TOOLS else []))
              for tool, args in chain.tools()]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = _pipe(stages, src, dst, env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = dst.read_bytes()
    if chain.voice:
        assert _lsb(np.frombuffer(out, np.int16),
                    fx[f"{name}_voice"]) <= FULL_SCALE_LSB
    else:
        assert out == fx[f"{name}_decoded"].tobytes()
    if chain.meta:
        assert meta.read_bytes() == fx[f"{name}_meta"].tobytes()


if __name__ == "__main__":
    np.savez_compressed(smoke.CLI_FIXTURE, **build_fixture())
    print(f"wrote {smoke.CLI_FIXTURE}")
