"""The port's example programs (``examples/torch_*.py``), each run as its
user runs it (a process of its own, from the repo root) with ``--device
cpu`` at a small size: its exit code and its result line. The channel bank
over each protocol's whole fixture stream must give the JAX bank's bytes
and events on every channel; the IQ demo's voice frames must equal the JAX
package's functions' on the same I/Q, and its PCM through a codec stand-in
the port's post-filter of the stand-in's speech; the serving bank's bytes
the JAX bank's. Exact (bytes)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, f"examples/{name}.py", *args,
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-1500:].decode()
    return r.stdout, r.stderr.decode()


@pytest.mark.parametrize("protocol", ["dmr", "ysf", "nxdn", "dstar",
                                      "pocsag"])
def test_channel_bank_equals_the_jax_bank(protocol):
    out, _ = _example("torch_channel_bank", protocol, "3", "1000")
    line = out.decode().splitlines()[-1]
    decoded = int(re.search(r"decoded (\d+) payload bytes", line).group(1))
    assert decoded > 0 and "3/3 channels equal the JAX bank's output" in line


def test_channel_bank_part_of_the_stream():
    out, _ = _example("torch_channel_bank", "dmr", "2", "2")
    line = out.decode().splitlines()[-1]
    assert line.startswith("[dmr] decoded ") and "equal" not in line


def _jax_voice(iq):
    """The JAX package's chain of examples/iq_to_audio.py on this I/Q."""
    import jax.numpy as jnp

    from digiham_tpu.dsp import (RrcState, WIDE_RRC, demod_init,
                                 fm_discriminator, gfsk_demod_block,
                                 rrc_filter)
    from digiham_tpu.protocols.dmr import make_decoder

    audio, _ = fm_discriminator(jnp.asarray(iq)[None, :],
                                jnp.ones((1,), jnp.complex64))
    filtered, _ = rrc_filter(audio * 5000, RrcState.init(1, WIDE_RRC),
                             WIDE_RRC)
    n_cent = (filtered.shape[1] // 10 - 2) // 100
    dibits, _ = gfsk_demod_block(filtered, demod_init(1), n_cent, 10)
    return make_decoder().process(np.asarray(dibits)[0])


def test_iq_to_audio_equals_the_jax_chain(tmp_path):
    from digiham_tpu_torch import smoke

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import torch_iq_to_audio as ex
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    iq = ex.synth_demo_iq()
    iq.tofile(tmp_path / "demo.cf32")
    ambe, meta = tmp_path / "out.ambe", tmp_path / "meta.txt"
    with smoke.CodecStandIn(str(tmp_path / "codec.sock")) as server:
        pcm, err = _example("torch_iq_to_audio", str(tmp_path / "demo.cf32"),
                            "--ambe", str(ambe), "--meta", str(meta),
                            "--codecserver", server.path)
    voice = ambe.read_bytes()
    assert voice and voice == _jax_voice(iq)
    assert f"decoded {len(voice)} voice payload bytes" in err
    assert "source:" in meta.read_text()
    import torch

    from digiham_tpu_torch.dsp import DigitalVoiceState, digitalvoice_filter

    speech = np.frombuffer(smoke.stand_in_speech(voice), np.int16)
    want, _ = digitalvoice_filter(torch.from_numpy(speech.copy())[None],
                                  DigitalVoiceState.init(1, "cpu"))
    assert pcm == want[0].numpy().astype("<i2").tobytes()


def test_iq_to_audio_synthesizes_a_demo_without_a_file():
    _, err = _example("torch_iq_to_audio")
    assert "synthesizing a demo DMR transmission" in err
    assert re.search(r"decoded [1-9]\d* voice payload bytes", err)


def test_multistream_bank_equals_the_jax_bank():
    out, _ = _example("torch_multistream_bank", "2", "2")
    lines = out.decode().splitlines()
    assert lines[0].startswith("checkpoint: ")
    assert lines[-1].startswith("2/2 channels decoded the JAX bank's voice")
