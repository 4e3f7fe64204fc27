"""The port's D-Star host machines and frame decode against the JAX
package's: ``make_decoder()`` on tests/torch_fsk.py's eight roles (a call
with slow-data text, a voice-sync entry, two calls with D-PRS data, a half
terminator, bit errors, noise, a header that fails, a call cut by the
stream's end), chunked equal to one-shot; the data header (no voice); and
``dstar_decode_frames`` on batches of voice frames with their lookahead
(terminators, voice syncs, random bits). Bytes, events and fields are
exact."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.pipeline.fsk import dstar_decode_frames as j_decode_frames
from digiham_tpu.protocols.dstar import make_decoder as j_make_decoder
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu_torch.pipeline import dstar_decode_frames
from digiham_tpu_torch.pipeline.fsk import FskTables
from digiham_tpu_torch.protocols.dstar import make_decoder
from digiham_tpu_torch.protocols.dstar.header import encode_header
from digiham_tpu_torch.protocols.dstar.phases import (HEADER_SYNC,
                                                      TERMINATOR, VOICE_SYNC)
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
import torch_fsk  # noqa: E402
from test_dstar import (bit_sync_preamble, make_header_bytes,  # noqa: E402
                        voice_frame)

torch.set_num_threads(1)

N_BITS = 8000


def _decode(make, writer, bits, piece=None):
    """Bytes and the event string of one decoder over ``bits``, in
    ``piece``-bit calls (one call without)."""
    events = []
    dec = make()
    dec.set_meta_writer(writer(lambda b: events.append(b.decode())))
    step = piece or len(bits)
    out = b"".join(dec.process(bits[i:i + step])
                   for i in range(0, len(bits), step))
    return out, "".join(events)


@pytest.mark.parametrize("variant", range(torch_fsk.VARIANTS))
def test_make_decoder_matches_jax(variant):
    """Every role: the JAX decoder's bytes and events; in 97- and 1,000-bit
    pieces the same as in one piece."""
    bits = torch_fsk.dstar_variant(variant, N_BITS)
    want = _decode(j_make_decoder, JWriter, bits)
    got = _decode(make_decoder, PipelineMetaWriter, bits)
    assert got == want
    for piece in (97, 1000):
        assert _decode(make_decoder, PipelineMetaWriter, bits, piece) == got
    if variant == torch_fsk.D_IDLE:
        return
    assert len(got[0]) % 9 == 0 and len(got[0]) >= 9 * 8


def test_data_header_is_not_voice():
    """A header flagged as data opens no voice phase, in both packages."""
    bits = np.concatenate([bit_sync_preamble(), HEADER_SYNC, encode_header(
        make_header_bytes(voice=False))] + [voice_frame()] * 30)
    bits = bits.astype(np.uint8)
    got = _decode(make_decoder, PipelineMetaWriter, bits)
    assert got == _decode(j_make_decoder, JWriter, bits)
    assert got[0] == b""


def _frames(rng, n):
    """[n, 120] frames with their lookahead: random bits, full and half
    terminators (with and without a bit error), voice syncs."""
    frames = rng.integers(0, 2, (n, 120)).astype(np.uint8)
    for i in range(0, n, 5):
        kind = (i // 5) % 4
        if kind == 0:
            frames[i, 72:120] = TERMINATOR
        elif kind == 1:
            frames[i, 72:96] = TERMINATOR[24:]
        elif kind == 2:
            frames[i, 72:96] = VOICE_SYNC
        else:
            frames[i, 72:120] = TERMINATOR
            frames[i, 72 + int(rng.integers(0, 48))] ^= 1
    return frames


@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64"])
def test_dstar_decode_frames_matches_jax(dtype):
    """Fields, dtypes and shapes of the batched frame decode equal JAX's,
    for [B, 120] and [C, N, 120] batches, with the tables built or passed
    as the bank passes them."""
    rng = np.random.default_rng(7)
    frames = _frames(rng, 60).astype(dtype)
    want = {k: np.asarray(v) for k, v in
            j_decode_frames(jnp.asarray(frames)).items()}
    for tables in (None, FskTables.build("cpu")):
        got = {k: v.numpy() for k, v in dstar_decode_frames(
            torch.from_numpy(frames), tables).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert (want["term_full"][::20] == 0).all()
    assert (want["term_half"][5::20] == 0).all()
    assert (want["vsync_dist"][10::20] == 0).all()
    batched = dstar_decode_frames(torch.from_numpy(frames.reshape(3, 20,
                                                                  120)))
    assert all(np.array_equal(batched[k].numpy().reshape(want[k].shape),
                              want[k]) for k in want)


def test_decode_frames_fields_are_the_voice_machines():
    """The frame fields say what VoicePhase reads from the same bits: its
    voice bytes and the descrambled slow data of a clean call."""
    bits = torch_fsk.dstar_variant(torch_fsk.D_CALL, N_BITS)
    sync = np.flatnonzero(np.lib.stride_tricks.sliding_window_view(
        bits, 24).__xor__(HEADER_SYNC).sum(1) == 0)[0]
    start = sync + 24 + 660
    frames = np.stack([bits[start + 96 * i:start + 96 * i + 120]
                       for i in range(30)])
    got = dstar_decode_frames(torch.from_numpy(frames))
    out = _decode(make_decoder, PipelineMetaWriter, bits)[0]
    assert got["voice"].numpy()[:30].tobytes() == out[:9 * 30]
    assert got["vsync_dist"][0] == 0 and got["vsync_dist"][21] == 0
    assert (got["term_full"].numpy() > 1).all()


def test_bank_frame_cut_holds_the_lookahead():
    """The streaming-bank path on a call that ends in a full terminator
    exactly at a frame boundary: frames need 24 bits past their end, and
    the bank's bytes and events are the decoder's."""
    bits = torch_fsk.dstar_variant(torch_fsk.D_CALL, N_BITS)[None]
    from digiham_tpu_torch.pipeline import FskPipeline
    from digiham_tpu_torch.runtime.tracked_bank import (DstarAdapter,
                                                        TrackedChannelBank)
    for chunk in (96, 120, 701):
        bank = TrackedChannelBank(
            FskPipeline(1, "dstar", n_centuries=1, device="cpu"),
            adapter=DstarAdapter(), device="cpu")
        got = torch_bank.push_dibits(bank, PipelineMetaWriter, bits, chunk)
        assert got == tuple(torch_bank.reference_path(
            make_decoder, PipelineMetaWriter, bits)), chunk
