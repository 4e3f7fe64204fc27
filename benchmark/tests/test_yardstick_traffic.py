"""The frozen TX copies under benchmark/synth give the same dibits as the
program's own builders, and the one generator gives the same samples for
the same seed."""
import numpy as np
import pytest
import torch

from benchmark.harness import traffic
from benchmark.synth import dmr, ysf
from conftest import small_cell

pytest.importorskip("digiham_tpu_torch")


def test_dmr_bursts_equal_the_programs():
    from digiham_tpu_torch.bench import dmr_synth as port

    rng = np.random.default_rng(7)
    lc = dmr.group_lc(0x123456, 0xABCDEF)
    assert lc == port.group_lc(0x123456, 0xABCDEF)
    payload = rng.integers(0, 4, 108)
    for slot in (0, 1):
        assert np.array_equal(dmr.make_cach(slot, 1, 2),
                              port.make_cach(slot, 1, 2))
        assert np.array_equal(dmr.voice_frame(slot, payload),
                              port.voice_frame(slot, payload))
        for dt in (1, 2):
            assert np.array_equal(dmr.data_frame(slot, dt, lc),
                                  port.data_frame(slot, dt, lc))
        ours = dmr.voice_superframe(slot, lc, [payload] * 6)
        theirs = port.voice_superframe(slot, lc, payload)
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    assert dmr.embedded_fragments(lc) == port.embedded_fragments(lc)


def test_ysf_frames_equal_the_programs():
    from digiham_tpu_torch.soak import synth as port

    rng = np.random.default_rng(8)
    ambe = rng.integers(0, 256, 7, dtype=np.uint8).tobytes()
    assert np.array_equal(ysf.vd2_frame(3, b"CALLSIGN01", ambe),
                          port.vd2_frame(3, b"CALLSIGN01", ambe))
    assert np.array_equal(ysf.header_frame(b"ALL", b"DG1ABC", b"D", b"U"),
                          port.header_frame(b"ALL", b"DG1ABC", b"D", b"U"))
    v36 = rng.integers(0, 4, 36)
    assert np.array_equal(ysf.v1_frame(5, v36), port.v1_frame(5, v36))
    v18 = rng.integers(0, 256, 18, dtype=np.uint8).tobytes()
    assert np.array_equal(ysf.vw_frame(6, v18), port.vw_frame(6, v18))
    assert np.array_equal(ysf.terminator_frame(), port.terminator_frame())


def test_modulation_equals_the_programs():
    from digiham_tpu_torch.soak import dmr_soak

    dibits = np.random.default_rng(9).integers(0, 4, 300).astype(np.uint8)
    ours = np.repeat(traffic.LEVELS[dibits], 10) * 1000.0
    assert np.array_equal(ours, dmr_soak.base_audio(dibits))


@pytest.mark.parametrize("protocol", ["dmr", "ysf"])
def test_calls_last_as_asked(protocol):
    tx = traffic.synth_module(protocol)
    rng = np.random.default_rng(10)
    for seconds in (2.0, 5.0, 8.0):
        air = len(tx.call(rng, seconds)) / tx.SYMBOL_RATE
        assert abs(air - seconds) < 0.5


@pytest.mark.parametrize("name", ["dmr_site.busy", "ysf_site.live"])
def test_same_seed_same_samples(name):
    cell = small_cell(name)
    a = traffic.make(cell, 2**31 + 5, torch.device("cpu"))
    b = traffic.make(cell, 2**31 + 5, torch.device("cpu"))
    c = traffic.make(cell, 2**31 + 6, torch.device("cpu"))
    assert a.loop.shape == (4, traffic.loop_samples(cell.mix, 48000))
    assert a.loop.dtype == np.float32
    assert np.array_equal(a.loop, b.loop)
    assert not np.array_equal(a.loop, c.loop)
    # a chunk past the loop's end wraps to its start
    assert np.array_equal(a.chunk(a.period - 10, 20)[:, 10:],
                          a.loop[:, :10])
