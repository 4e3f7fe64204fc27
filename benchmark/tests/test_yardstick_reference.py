"""The plain reference: its symbol-domain decoders equal the program's
per-channel decoders, its front equals the program's plain front for each
filter, slicer and sps the port runs, and through the harness its bytes
and events equal the program's bank (its plain versions, on the CPU) on
the same generated samples at 4 channels; a lower-precision run fails the
comparison."""
import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import check, traffic
from benchmark.reference import dsp, stream
from conftest import FRONTS, front_cell, run_small, small_cell

CELLS = ["dmr_site.busy", "ysf_site.busy", "dmr_site.live", "ysf_site.live"]


@pytest.mark.parametrize("protocol", ["dmr", "ysf"])
def test_decoder_equals_the_programs(protocol):
    pytest.importorskip("digiham_tpu_torch")
    from digiham_tpu_torch.bench import host_synth
    from digiham_tpu_torch.protocols import dmr, ysf
    from digiham_tpu_torch.runtime.meta import PipelineMetaWriter

    streams = getattr(host_synth, f"{protocol}_streams")(11, 3)
    make = {"dmr": dmr.make_decoder, "ysf": ysf.make_decoder}[protocol]
    for row in streams:
        frames, events = stream.decode_channel(protocol, row)
        dec, ev = make(), []
        dec.set_meta_writer(PipelineMetaWriter(ev.append))
        assert b"".join(b for _, b in frames) == dec.process(row)
        assert [e for _, e in events] == ev


@pytest.mark.parametrize("front", list(FRONTS))
def test_front_equals_the_programs_plain_version_in_blocks(front,
                                                           monkeypatch):
    """Each front the port runs (DMR and YSF; NXDN; D-Star; POCSAG):
    the reference over the stream equals the program's plain FIR with the
    design's taps, where it has one, then its plain century demod."""
    pytest.importorskip("digiham_tpu_torch")
    from digiham_tpu_torch.dsp.demod import _demod_block_plain, demod_init
    from digiham_tpu_torch.dsp.rrc import NARROW_RRC, WIDE_RRC
    from digiham_tpu_torch.ops.fir import fir_cmajor_plain

    rrc, sps, mode, invert = FRONTS[front]
    cell = front_cell(front, monkeypatch)
    audio = torch.from_numpy(traffic.make(cell, 3, "cpu").rows(
        [0, 1, 2, 3], 10 * (100 * sps + 1)))
    ours, ends, starts = dsp.demodulate(audio, sps, rrc, mode=mode,
                                        invert=invert)
    design = {"wide": WIDE_RRC, "narrow": NARROW_RRC}.get(rrc)
    y = audio
    if design is not None:
        assert np.array_equal(dsp.scaled_taps(rrc), design.scaled_taps)
        x = torch.cat([torch.zeros(4, design.ntaps - 1), audio], 1)
        y = fir_cmajor_plain(x, design.taps_tensor("cpu"))
    theirs, st = _demod_block_plain(y, demod_init(4, "cpu"), 8, sps, mode,
                                    invert)
    assert np.array_equal(ours[:, :800], theirs.numpy())
    assert set(np.unique(ours)) <= set(range(4 if mode == "gfsk" else 2))
    assert ends.shape == ours.shape and (ends[:, 1:] > ends[:, :-1]).all()
    assert (ends[:, 799] <= st.pos.numpy() + 1).all()
    # the ninth century starts where the program's carry stands
    assert starts.shape == (4, ours.shape[1] // 100)
    assert (starts[:, 0] == 0).all()
    assert np.array_equal(starts[:, 8], st.pos.numpy())


@pytest.mark.parametrize("name", CELLS)
def test_bank_equals_reference(name):
    pytest.importorskip("digiham_tpu_torch")
    result, said = run_small(small_cell(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 5 and result["failed"] == 0


@pytest.mark.parametrize("name,seed", [("dmr_site.busy", 1),
                                       ("ysf_site.busy", 1)])
def test_lower_precision_fails(name, seed):
    cell = small_cell(name)
    numbers, frames, _ = control.control(cell, seed, 8 * 48000, "cpu",
                                         n_workers=1)
    assert frames > 100
    assert any(v["value"] > v["limit"] for v in numbers.values()), numbers


def test_checked_channels_drawn_from_the_seed():
    cell = small_cell("dmr_site.busy")
    cell.config = dict(cell.config, channels=256)
    cell.mix = dict(cell.mix, checked_channels=64)
    a = check.checked_channels(cell, 2**31 + 1)
    assert len(a) == 64 == len(set(a)) and a == sorted(a)
    assert a == check.checked_channels(cell, 2**31 + 1)
    assert a != check.checked_channels(cell, 2**31 + 2)


def test_worker_processes_decode_as_one_process():
    from benchmark.synth import dmr

    rng = np.random.default_rng(4)
    dibits = [np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                              dmr.call(rng, 2.0)]) for _ in range(3)]
    assert (check._symbol_decode("dmr", dibits, 2)
            == check._symbol_decode("dmr", dibits, 1))
