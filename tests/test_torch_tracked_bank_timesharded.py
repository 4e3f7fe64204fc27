"""The port's time-sharded tracker bank (``TimeShardedTrackedBank`` over
``TimeShardedPipeline`` on a (2, 2) CPU mesh) and its mesh bank
(``TrackedChannelBank(mesh=...)``), held against the JAX package's.

A counterpart of each of the nine JAX tests in
tests/test_tracked_bank_timesharded.py: for DMR, YSF, NXDN, D-Star and
POCSAG streams, a stream too short for one step (flush only), clock skew
that the driver must recentre, and snapshot/restore (also under skew), the
port's time-sharded bank emits the same voice bytes and metadata events
as the port's unsharded bank and the JAX package's time-sharded bank.
Then the mesh bank (DMR on samples and on dibits, NXDN on dibits, a
snapshot on a mesh) against the unsharded banks and the per-channel
reference decoder, and JAX checkpoints crossing into the port: a JAX
time-sharded bank's snapshot (its state a DemodState alone, also for the
4FSK protocols) through ``restore_jax``.

Every sample stream's noise is screened knife-edge free
(tests/torch_scale.py); the 2FSK streams are Gaussian-shaped (BT 0.5)."""
import pickle

import jax
import numpy as np
import pytest
import torch

from digiham_tpu.parallel.streaming import (
    TimeShardedPipeline as JTimeShardedPipeline)
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime import tracked_bank as j_tracked_bank
from digiham_tpu.runtime.stream import SampleBuffer as JSampleBuffer
from digiham_tpu_torch.pipeline import (DmrPipeline, FskPipeline,
                                        NxdnPipeline, YsfPipeline)
from digiham_tpu_torch.parallel.streaming import TimeShardedPipeline
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.tracked_bank import (TimeShardedTrackedBank,
                                                    TrackedChannelBank)
from dmr_synth import voice_frame
from torch_scale import gaussian, jax_mesh, port_mesh, screened_noise

torch.set_num_threads(1)

LEVELS = np.array([1.0, 3.0, -1.0, -3.0]) / 3.0
C = 2
ADAPTERS = {"dmr": "DmrAdapter", "ysf": "YsfAdapter",
            "nxdn": "NxdnAdapter", "dstar": "DstarAdapter",
            "pocsag": "PocsagAdapter"}
# the unsharded banks of the JAX tests: protocol -> centuries a step
PLAIN_CENTURIES = {"dmr": 4, "ysf": 5, "nxdn": 3, "dstar": 2, "pocsag": 2}


@pytest.fixture(scope="module")
def devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax.devices()


def _port_sharded(protocol, cps=None):
    sp = TimeShardedPipeline(port_mesh((2, 2)), C, protocol,
                             centuries_per_shard=cps)
    return TimeShardedTrackedBank(
        sp, adapter=getattr(tracked_bank, ADAPTERS[protocol])(),
        device="cpu")


def _port_plain(protocol):
    nc = PLAIN_CENTURIES[protocol]
    pipe = {"dmr": lambda: DmrPipeline(C, 10, nc, device="cpu"),
            "ysf": lambda: YsfPipeline(C, 10, nc, device="cpu"),
            "nxdn": lambda: NxdnPipeline(C, 20, nc, device="cpu"),
            "dstar": lambda: FskPipeline(C, "dstar", nc, device="cpu"),
            "pocsag": lambda: FskPipeline(C, "pocsag", nc, device="cpu"),
            }[protocol]()
    return TrackedChannelBank(
        pipe, adapter=getattr(tracked_bank, ADAPTERS[protocol])(),
        device="cpu")


def _jax_sharded(protocol, cps=None):
    sp = JTimeShardedPipeline(jax_mesh((2, 2)), channels=C,
                              protocol=protocol, centuries_per_shard=cps)
    return j_tracked_bank.TimeShardedTrackedBank(
        sp, adapter=getattr(j_tracked_bank, ADAPTERS[protocol])())


def _attach(bank, writer_type):
    outputs = {c: b"" for c in range(C)}
    bank.on_output = lambda c, d: outputs.__setitem__(c, outputs[c] + d)
    events = []
    for c in range(C):
        ev = []
        bank.set_meta_writer(c, writer_type(
            lambda b, ev=ev: ev.append(b.decode())))
        events.append(ev)
    return outputs, events


def _run(bank, writer_type, samples, chunk=8192, flush=True, start=0):
    """(bytes per channel, events per channel) of pushing samples[:,
    start:] in chunks, then flush."""
    outputs, events = _attach(bank, writer_type)
    for lo in range(start, samples.shape[1], chunk):
        bank.push(samples[:, lo:lo + chunk])
    if flush:
        bank.flush()
    return dict(outputs), ["".join(e) for e in events]


def _parity(protocol, samples, cps=None, expect_meta=True,
            min_steps=1):
    """The port's time-sharded bank == the port's unsharded bank == the
    JAX package's time-sharded bank, bytes and events."""
    bank = _port_sharded(protocol, cps)
    assert samples.shape[1] >= min_steps * bank.pipeline.block_len
    got = _run(bank, PipelineMetaWriter, samples)
    plain = _run(_port_plain(protocol), PipelineMetaWriter, samples)
    want = _run(_jax_sharded(protocol, cps), JWriter, samples)
    assert got == plain
    assert got == want
    assert any(len(v) > 0 for v in got[0].values())
    if expect_meta:
        assert any(len(m) > 0 for m in got[1])
    return bank


def _dmr_base(seed, n_frames):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 4, 108)
    frames = [voice_frame(s % 2, payload, sync=True)
              for s in range(n_frames)]
    dibits = np.concatenate([np.zeros(30, np.uint8)] + frames)
    return np.repeat(LEVELS[dibits], 10) * 1000


def _skewed(base, skew=1.5e-4):
    n = base.shape[-1]
    t = np.arange(int(n / (1 + skew))) * (1 + skew)
    return np.interp(t, np.arange(n), base)


def test_timesharded_bank_equals_unsharded(devices):
    samples = screened_noise(_dmr_base(3, 120), C, 40.0, 3, "dmr")
    bank = _parity("dmr", samples, min_steps=1)
    assert bank.pipeline.block_len + 2000 < samples.shape[1]


def test_timesharded_bank_snapshot_restore(devices):
    samples = screened_noise(_dmr_base(9, 130), C, 40.0, 9, "dmr")
    half = (samples.shape[1] // 2) // 512 * 512
    first = _port_sharded("dmr")
    outputs, _ = _attach(first, PipelineMetaWriter)
    first.push(samples[:, :half])
    blob = first.snapshot()
    pre = {c: len(outputs[c]) for c in outputs}
    first.push(samples[:, half:])
    second = _port_sharded("dmr")
    second.restore(blob)
    got, _ = _run(second, PipelineMetaWriter, samples, start=half,
                  chunk=samples.shape[1], flush=False)
    for c in outputs:
        assert outputs[c][pre[c]:] == got[c]
    assert any(outputs.values())


def test_timesharded_bank_dstar_equals_unsharded(devices):
    from test_dstar import full_voice_stream

    bits = np.concatenate(full_voice_stream(140) + [np.zeros(400, np.uint8)])
    base = gaussian(np.array([-1.0, 1.0])[bits], 10) * 1000
    _parity("dstar", screened_noise(base, C, 60.0, 5, "dstar"), cps=16)


def test_timesharded_bank_flush_only_tail(devices):
    """A stream shorter than one sharded block decodes entirely through
    the EOF flush: parity with the unsharded bank's flush."""
    samples = screened_noise(_dmr_base(7, 6), C, 40.0, 7, "dmr")
    bank = _port_sharded("dmr")
    outputs, _ = _attach(bank, PipelineMetaWriter)
    bank.push(samples)
    assert not any(outputs.values())  # nothing stepped yet
    assert samples.shape[1] < bank.pipeline.block_len
    got = _run(_port_sharded("dmr"), PipelineMetaWriter, samples)
    assert got == _run(_port_plain("dmr"), PipelineMetaWriter, samples)
    assert got == _run(_jax_sharded("dmr"), JWriter, samples)
    assert any(got[0].values())


def test_timesharded_bank_ysf_equals_unsharded(devices):
    from ysf_synth import header_frame, terminator_frame, vd2_frame

    rng = np.random.default_rng(11)
    parts = [rng.integers(0, 4, 60),
             header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
    parts += [vd2_frame(i % 8, b"TSHARDYSF ") for i in range(24)]
    parts += [terminator_frame(), np.zeros(400, np.uint8)]
    dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    base = np.repeat(LEVELS[dibits], 10) * 1000
    _parity("ysf", screened_noise(base, C, 40.0, 11, "ysf"))


def _nxdn_base(n_frames):
    from nxdn_synth import (encode_sacch_unit, nxdn_frame,
                            vcall_superframe_bytes, voice_slot_dibits)

    rng = np.random.default_rng(13)
    units = vcall_superframe_bytes(1, 1234, 5678)
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    parts = [rng.integers(0, 4, 80)]
    for i in range(n_frames):
        slots = [voice_slot_dibits(payload, 38),
                 voice_slot_dibits(payload, 38 + 72)]
        parts.append(nxdn_frame((0b01, 0b10, 0b11),
                                encode_sacch_unit(i % 4, units[i % 4]),
                                slots))
    parts.append(np.zeros(300, np.uint8))
    dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    return np.repeat(LEVELS[dibits], 20) * 1000


def test_timesharded_bank_nxdn_equals_unsharded(devices):
    _parity("nxdn", screened_noise(_nxdn_base(22), C, 40.0, 13, "nxdn"))


def test_timesharded_bank_pocsag_equals_unsharded(devices):
    from test_pocsag import (address_codeword, alpha_payloads,
                             build_stream, data_codeword)

    parts = [np.zeros(100, np.uint8)]
    for m in range(8):
        cws = [address_codeword(1000 + m, 3)]
        cws += [data_codeword(p) for p in alpha_payloads(f"TSHARD MSG {m}")]
        parts.append(build_stream(cws))
        parts.append(np.zeros(120, np.uint8))
    bits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    base = gaussian(np.array([1.0, -1.0])[bits], 40) * 1000
    _parity("pocsag", screened_noise(base, C, 60.0, 17, "pocsag"),
            expect_meta=False, min_steps=2)


def test_timesharded_bank_clock_skew_recentering(devices):
    """A +150 ppm stream whose cumulative drift (~0.15 samples a century)
    far exceeds the ±24 halo budget decodes as the unsharded bank does,
    and the carried pos stays recentred instead of tripping the budget."""
    samples = screened_noise(_skewed(_dmr_base(21, 240)), C, 30.0, 21,
                             "dmr")
    bank = _port_sharded("dmr")
    assert samples.shape[1] > 2 * bank.pipeline.block_len
    assert 1.5e-4 * samples.shape[1] > bank.pipeline.drift_budget
    outputs, events = _attach(bank, PipelineMetaWriter)
    for lo in range(0, samples.shape[1], 8192):
        bank.push(samples[:, lo:lo + 8192])
    assert int(bank.state.pos.abs().max()) < bank.pipeline.drift_budget
    bank.flush()
    got = (dict(outputs), ["".join(e) for e in events])
    assert got == _run(_port_plain("dmr"), PipelineMetaWriter, samples)
    assert got == _run(_jax_sharded("dmr"), JWriter, samples)
    assert any(got[0].values())


def test_timesharded_snapshot_restore_under_skew(devices):
    """snapshot()/restore() mid-stream while the recentring is active:
    the restored bank continues byte-identically."""
    samples = screened_noise(_skewed(_dmr_base(23, 200)), C, 30.0, 23,
                             "dmr")
    half = (samples.shape[1] // 2) // 512 * 512
    first = _port_sharded("dmr")
    outputs, _ = _attach(first, PipelineMetaWriter)
    first.push(samples[:, :half])
    blob = first.snapshot()
    pre = {c: len(outputs[c]) for c in outputs}
    first.push(samples[:, half:])
    second = _port_sharded("dmr")
    second.restore(blob)
    got, _ = _run(second, PipelineMetaWriter, samples, start=half,
                  chunk=samples.shape[1], flush=False)
    for c in outputs:
        assert outputs[c][pre[c]:] == got[c]
    assert any(outputs.values())


# --- the mesh bank -----------------------------------------------------------

def _mesh_bank(pipe, adapter=None, shape=(4, 1)):
    return TrackedChannelBank(pipe, adapter=adapter, device="cpu",
                              mesh=port_mesh(shape))


@pytest.mark.parametrize("seed", range(2))
def test_mesh_bank_dibit_contract(seed):
    """The DMR mesh bank on dibits == the per-channel reference decoder
    of the JAX package (tests/test_tracked_bank.py's streams)."""
    from test_tracked_bank import make_streams, reference_path

    streams = make_streams(seed, n_channels=4)
    bank = _mesh_bank(DmrPipeline(4, 10, 2, device="cpu"))
    outputs, events = _attach_n(bank, 4)
    for lo in range(0, streams.shape[1], 800):
        bank.push_dibits(streams[:, lo:lo + 800])
    ref_out, ref_meta = reference_path(streams)
    for c in range(4):
        assert outputs[c] == ref_out[c], c
        assert "".join(events[c]) == ref_meta[c], c


def _attach_n(bank, n):
    outputs = {c: b"" for c in range(n)}
    bank.on_output = lambda c, d: outputs.__setitem__(c, outputs[c] + d)
    events = [[] for _ in range(n)]
    for c in range(n):
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events[c]: ev.append(b.decode())))
    return outputs, events


def test_mesh_bank_samples_equal_unsharded():
    """The full sample path (K2 per shard, decode per shard) on a (4, 1)
    and a (2, 2) mesh == the unsharded bank == the JAX bank; the flush
    tail included."""
    from digiham_tpu.pipeline import DmrPipeline as JDmrPipeline

    samples = screened_noise(_dmr_base(11, 12), 4, 40.0, 11, "dmr")
    results = []
    for bank in (_mesh_bank(DmrPipeline(4, 10, 2, device="cpu")),
                 _mesh_bank(DmrPipeline(4, 10, 2, device="cpu"),
                            shape=(2, 2)),
                 TrackedChannelBank(DmrPipeline(4, 10, 2, device="cpu"),
                                    device="cpu"),
                 j_tracked_bank.TrackedChannelBank(
                     JDmrPipeline(channels=4, sps=10, n_centuries=2))):
        outputs, events = _attach_n(bank, 4) if not isinstance(
            bank, j_tracked_bank.TrackedChannelBank) else _attach_j(bank, 4)
        for lo in range(0, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
        bank.flush()
        results.append((dict(outputs), ["".join(e) for e in events]))
    assert results[0] == results[1] == results[2] == results[3]
    assert any(results[0][0].values())
    with pytest.raises(ValueError, match="not divisible"):
        _mesh_bank(DmrPipeline(6, 10, 2, device="cpu"))


def _attach_j(bank, n):
    outputs = {c: b"" for c in range(n)}
    bank.on_output = lambda c, d: outputs.__setitem__(c, outputs[c] + d)
    events = [[] for _ in range(n)]
    for c in range(n):
        bank.set_meta_writer(c, JWriter(
            lambda b, ev=events[c]: ev.append(b.decode())))
    return outputs, events


def test_nxdn_mesh_equals_unsharded():
    """The NXDN mesh bank on dibits (SACCH/FACCH1 Viterbi in each shard's
    decode) == the unsharded port bank == the JAX bank."""
    from digiham_tpu.pipeline import NxdnPipeline as JNxdnPipeline
    from test_tracked_bank_nxdn import make_streams

    streams = make_streams(1, n_channels=4)
    results = []
    for bank in (_mesh_bank(NxdnPipeline(4, 20, 3, device="cpu"),
                            tracked_bank.NxdnAdapter()),
                 TrackedChannelBank(NxdnPipeline(4, 20, 3, device="cpu"),
                                    adapter=tracked_bank.NxdnAdapter(),
                                    device="cpu")):
        outputs, events = _attach_n(bank, 4)
        for lo in range(0, streams.shape[1], 800):
            bank.push_dibits(streams[:, lo:lo + 800])
        results.append((dict(outputs), ["".join(e) for e in events]))
    j_bank = j_tracked_bank.TrackedChannelBank(
        JNxdnPipeline(channels=4, sps=20, n_centuries=3),
        adapter=j_tracked_bank.NxdnAdapter())
    outputs, events = _attach_j(j_bank, 4)
    for lo in range(0, streams.shape[1], 800):
        j_bank.push_dibits(streams[:, lo:lo + 800])
    results.append((dict(outputs), ["".join(e) for e in events]))
    assert results[0] == results[1] == results[2]
    assert any(results[0][0].values())


def test_snapshot_on_mesh():
    """A mesh bank's snapshot restores into a fresh mesh bank and into an
    unsharded bank, both continuing identically, mid-stream on samples
    (the carries split back over the shards)."""
    samples = screened_noise(_dmr_base(1, 40), 4, 40.0, 1, "dmr")
    half = (samples.shape[1] // 2) // 512 * 512
    first = _mesh_bank(DmrPipeline(4, 10, 2, device="cpu"))
    outputs, _ = _attach_n(first, 4)
    first.push(samples[:, :half])
    blob = first.snapshot()
    pre = {c: len(outputs[c]) for c in outputs}
    first.push(samples[:, half:])
    for second in (_mesh_bank(DmrPipeline(4, 10, 2, device="cpu")),
                   TrackedChannelBank(DmrPipeline(4, 10, 2, device="cpu"),
                                      device="cpu")):
        second.restore(blob)
        got, _ = _attach_n(second, 4)
        second.push(samples[:, half:])
        for c in outputs:
            assert outputs[c][pre[c]:] == got[c], c
    assert any(outputs.values())


# --- JAX checkpoints crossing into the port ----------------------------------

@pytest.mark.parametrize("protocol", ["dmr", "nxdn", "dstar"])
def test_jax_timesharded_snapshot_crosses(devices, protocol):
    """A JAX time-sharded bank runs the first half; its snapshot (the
    demod carry alone, 3 leaves, for the 4FSK protocols too, and the
    pending samples with the left edge) goes into the port's
    time-sharded bank through restore_jax, whose own host machines then
    re-acquire: the rest equals a JAX bank handed the same state and
    samples with fresh machines."""
    if protocol == "dmr":
        samples = screened_noise(_dmr_base(31, 160), C, 40.0, 31, "dmr")
    elif protocol == "nxdn":
        samples = screened_noise(_nxdn_base(44), C, 40.0, 33, "nxdn")
    else:
        from test_dstar import full_voice_stream

        bits = np.concatenate(full_voice_stream(160))
        samples = screened_noise(
            gaussian(np.array([-1.0, 1.0])[bits], 10) * 1000, C, 60.0, 35,
            "dstar")
    cps = 16 if protocol == "dstar" else None
    half = (samples.shape[1] // 2) // 512 * 512
    assert half > _port_sharded(protocol, cps).pipeline.block_len
    j_first = _jax_sharded(protocol, cps)
    j_first.push(samples[:, :half])
    blob = j_first.snapshot()
    payload = pickle.loads(blob)

    j_second = _jax_sharded(protocol, cps)
    j_second.state = j_load_state(payload["pipeline_state"])
    j_second.samples = JSampleBuffer(C)
    j_second.samples.push(payload["samples"])
    port = _port_sharded(protocol, cps)
    port.restore_jax(blob)
    assert port.state.pos.dtype == torch.int32
    assert np.array_equal(port.state.pos.numpy(),
                          np.asarray(j_second.state.pos))
    assert port.samples.fill == payload["samples"].shape[1]
    want = _run(j_second, JWriter, samples, start=half)
    got = _run(port, PipelineMetaWriter, samples, start=half)
    assert got == want
    assert any(got[0].values())
    with pytest.raises(ValueError, match="RRC"):
        _port_plain("dmr").restore_jax(blob)
