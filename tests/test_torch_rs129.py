"""The RS(12,9) option of the port's DMR decoder, ``make_decoder(rs129=...)``
(``protocols/dmr/phases.py::FramePhase(rs129=...)``): the four decode cases
of tests/test_rs129.py, each giving the metadata the JAX decoder gives
under ``DIGIHAM_DMR_RS129`` on the same frames. The check runs only on the
voice LC header; the bank path keeps none, as the JAX package's. Exact
(metadata strings)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_rs129 import _decode_frames, _stream  # noqa: E402

from digiham_tpu_torch.protocols.dmr import make_decoder  # noqa: E402
from digiham_tpu_torch.protocols.dmr.phases import FramePhase  # noqa: E402
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter  # noqa: E402


def _decode(frames, rs129):
    events = []
    dec = make_decoder(rs129=rs129)
    dec.set_meta_writer(PipelineMetaWriter(
        lambda b: events.append(b.decode())))
    voice = dec.process(np.concatenate(frames))
    return "".join(events), voice


def _jax(frames, rs129):
    return _decode_frames(frames, {"DIGIHAM_DMR_RS129": "1" if rs129
                                   else "0"})


@pytest.mark.parametrize("corrupt,rs129", [(1, False), (1, True), (2, True),
                                           (0, False), (0, True)])
def test_option_equals_jax_under_its_switch(corrupt, rs129):
    frames = _stream(corrupt_lc_bits=corrupt)
    meta, _ = _decode(frames, rs129)
    assert meta == _jax(frames, rs129)


def test_off_reference_faithful():
    """Off (the default): corrupted LC bytes flow through to metadata (the
    reference's behaviour: parity ignored)."""
    meta, _ = _decode(_stream(corrupt_lc_bits=1), False)
    assert "target:4259931" in meta  # the corrupted id leaks through


def test_on_corrects_single_byte_error():
    meta, _ = _decode(_stream(corrupt_lc_bits=1), True)
    assert "source:3141592" in meta and "target:91" in meta


def test_on_drops_uncorrectable():
    meta, _ = _decode(_stream(corrupt_lc_bits=2), True)
    assert "3141592" not in meta or "target:91" not in meta


def test_on_clean_stream_matches_off():
    a, voice_a = _decode(_stream(), False)
    b, voice_b = _decode(_stream(), True)
    assert a == b and "source:3141592" in a and voice_a == voice_b


def test_the_option_reaches_every_frame_phase():
    """The decoder re-injects the option on every phase swap, as it does
    the slot filter; a phase built alone takes it as an argument."""
    assert FramePhase().rs129 is False and FramePhase(True).rs129 is True
    dec = make_decoder(rs129=True)
    dec.process(np.concatenate(_stream(corrupt_lc_bits=1)))
    assert isinstance(dec.current_phase, FramePhase)
    assert dec.current_phase.rs129 is True
    assert make_decoder().rs129 is False
