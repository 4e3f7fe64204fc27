"""The port's MultiStreamBank on the CPU (``device="cpu"``): the N-process
sharded tracked bank must emit what one TrackedChannelBank over the same
channels emits — the port's and the JAX package's — and keep the
checkpoint, prewarm and supervision contracts. Counterparts of the nine
JAX tests in tests/test_multistream.py (on its knife-edge-free streams,
``_synth``), SIGKILL mid-stream and kill-then-flush included; then the
workers' side: none imports ``jax`` or the JAX package, events written by
``worker_init`` carry global channel ids, a worker that fails (no card,
a failing init) surfaces as WorkerDied with its error text, the parent
never initializes CUDA, and a JAX MultiStreamBank snapshot crosses shard
by shard. Every worker process is waited for with a timeout."""
import os
import pickle
import signal

import pytest
import torch

from digiham_tpu.runtime.multistream import MultiStreamBank as JMultiStream
from digiham_tpu.pipeline import DmrPipeline as JDmrPipeline
from digiham_tpu.runtime.checkpoint import load_state as j_load_state
from digiham_tpu.runtime.stream import SampleBuffer as JSampleBuffer
from digiham_tpu.runtime.tracked_bank import TrackedChannelBank as JBank
from digiham_tpu_torch import smoke
from digiham_tpu_torch.pipeline import DmrPipeline
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.multistream import MultiStreamBank, WorkerDied
from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank
from test_multistream import _run_single as _run_single_jax
from test_multistream import _synth
import torch_workers

torch.set_num_threads(1)

KW = {"n_centuries": 2}
CHUNK = 4096


def _bank(channels, n_procs, got=None, **kw):
    on_output = None if got is None else (
        lambda c, d: got[c].append(bytes(d)))
    return MultiStreamBank("dmr", channels=channels, n_procs=n_procs,
                           on_output=on_output, pipeline_kwargs=KW,
                           device="cpu", **kw)


def _run_single(samples, channels, events=None):
    """The port's one TrackedChannelBank over the same channels."""
    got = [[] for _ in range(channels)]
    bank = TrackedChannelBank(DmrPipeline(channels, 10, 2, device="cpu"),
                              on_output=lambda c, d: got[c].append(bytes(d)),
                              device="cpu")
    if events is not None:
        for c in range(channels):
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, ev=events[c]: ev.append(b.decode())))
    for lo in range(0, samples.shape[1], CHUNK):
        bank.push(samples[:, lo:lo + CHUNK])
    return got


def _joined(got):
    return [b"".join(g) for g in got]


def test_multistream_matches_single_bank():
    """Two workers == the port's single bank == the JAX single bank, and
    the parent never initialized CUDA."""
    channels = 4
    samples, _ = _synth(channels, n_frames=6)
    got = [[] for _ in range(channels)]
    with _bank(channels, 2, got) as ms:
        assert [i["device"] for i in ms.worker_info] == ["cpu", "cpu"]
        assert all(s > 0 for s in ms.start_seconds)
        for lo in range(0, samples.shape[1], CHUNK):
            ms.push(samples[:, lo:lo + CHUNK])
    ref = _joined(_run_single(samples, channels))
    assert _joined(got) == ref
    assert _joined(_run_single_jax(samples, channels)) == ref
    assert any(ref)
    assert not torch.cuda.is_initialized()


def test_multistream_snapshot_restore_midstream():
    """A fresh bank restored from a mid-stream composite snapshot
    continues identically."""
    channels = 2
    samples, _ = _synth(channels, n_frames=8, seed=11)
    cut = samples.shape[1] // 2
    got_a = [[] for _ in range(channels)]
    with _bank(channels, 2, got_a) as ms:
        ms.push(samples[:, :cut])
        blob = ms.snapshot()
        pre = [len(b) for b in _joined(got_a)]
        ms.push(samples[:, cut:])
    got_b = [[] for _ in range(channels)]
    with _bank(channels, 2, got_b) as ms2:
        ms2.restore(blob)
        ms2.push(samples[:, cut:])
    for c in range(channels):
        assert _joined(got_a)[c][pre[c]:] == _joined(got_b)[c], c
    assert any(_joined(got_b))


def test_prewarm_is_invisible():
    """prewarm() runs a silence block through every worker and rolls it
    back: exact state rollback, no outputs, and the stream after it
    identical to an un-prewarmed bank's."""
    channels = 4
    samples, _ = _synth(channels, n_frames=6, seed=11)
    got = [[] for _ in range(channels)]
    with _bank(channels, 2, got) as ms:
        snap0 = ms.snapshot()
        ms.prewarm(CHUNK)
        assert ms.snapshot() == snap0
        assert all(len(g) == 0 for g in got)
        for lo in range(0, samples.shape[1], CHUNK):
            ms.push(samples[:, lo:lo + CHUNK])
    ref = _joined(_run_single(samples, channels))
    assert _joined(got) == ref and any(ref)


def test_multistream_rejects_bad_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        MultiStreamBank("dmr", channels=5, n_procs=2, device="cpu")
    with pytest.raises(ValueError, match="unknown protocol"):
        MultiStreamBank("p25", channels=4, n_procs=2, device="cpu")


def _push_all(bank, samples, kill_at=None):
    """Push in chunks; SIGKILL worker 1 just before chunk kill_at."""
    for i, lo in enumerate(range(0, samples.shape[1], CHUNK)):
        if kill_at is not None and i == kill_at:
            victim = bank._procs[1]
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(timeout=30)
        bank.push(samples[:, lo:lo + CHUNK])


@pytest.mark.parametrize("where", ["early", "last"])
def test_supervised_sigkill_byte_identical(where):
    """Elastic recovery: SIGKILL a worker mid-stream; the supervised bank
    respawns it, restores the last parent-held snapshot, replays the
    delta, and the output stream stays byte-identical to an unkilled
    run."""
    channels = 4
    samples, _ = _synth(channels, n_frames=8, seed=23)
    n_chunks = (samples.shape[1] + CHUNK - 1) // CHUNK
    kill_at = 2 if where == "early" else n_chunks - 1
    got = [[] for _ in range(channels)]
    with _bank(channels, 2, got, supervise=True, replay_limit=2) as ms:
        pid0 = ms._procs[1].pid
        _push_all(ms, samples, kill_at=kill_at)
        assert ms._procs[1].pid != pid0, "worker was never respawned"
        assert ms._procs[1].is_alive()
    ref = _joined(_run_single(samples, channels))
    assert _joined(got) == ref and any(ref)


def test_supervised_kill_then_flush():
    """Death detected on the flush message: recovery replays the buffer
    and re-sends the flush — the tail's output intact."""
    channels = 2
    samples, _ = _synth(channels, n_frames=6, seed=31)
    cut = (samples.shape[1] // 8192) * 8192 - 4096  # abrupt mid-stream end
    samples = samples[:, :cut]

    def run(kill):
        got = [[] for _ in range(channels)]
        with _bank(channels, 2, got, supervise=True, replay_limit=3) as ms:
            for lo in range(0, cut, CHUNK):
                ms.push(samples[:, lo:lo + CHUNK])
            if kill:
                victim = ms._procs[1]
                os.kill(victim.pid, signal.SIGKILL)
                victim.join(timeout=30)
            ms.flush()
        return _joined(got)

    killed = run(kill=True)
    assert killed == run(kill=False)
    assert any(killed)


def test_supervised_snapshot_restore_still_composes():
    """supervise=True must not change the checkpoint contract."""
    channels = 2
    samples, _ = _synth(channels, n_frames=6, seed=37)
    cut = samples.shape[1] // 2
    got_a = [[] for _ in range(channels)]
    with _bank(channels, 2, got_a, supervise=True, replay_limit=2) as ms:
        ms.push(samples[:, :cut])
        blob = ms.snapshot()
        pre = [len(b) for b in _joined(got_a)]
        ms.push(samples[:, cut:])
    got_b = [[] for _ in range(channels)]
    with _bank(channels, 2, got_b, supervise=True, replay_limit=2) as ms2:
        ms2.restore(blob)
        ms2.push(samples[:, cut:])
    for c in range(channels):
        assert _joined(got_a)[c][pre[c]:] == _joined(got_b)[c], c


def test_restore_rejects_protocol_mismatch():
    with _bank(2, 2) as ms:
        blob = ms.snapshot()
    with MultiStreamBank("pocsag", channels=2, n_procs=2, pipeline_kwargs=KW,
                         device="cpu") as ms2:
        with pytest.raises(ValueError, match="dmr"):
            ms2.restore(blob)


def test_multistream_worker_death_raises():
    """A crashed worker surfaces as WorkerDied (a RuntimeError), not a
    hang: the parent's gather polls worker liveness."""
    samples, _ = _synth(2, n_frames=2)
    ms = _bank(2, 2)
    try:
        ms._procs[0].terminate()
        ms._procs[0].join(timeout=30)
        with pytest.raises(RuntimeError, match="worker 0 .* died"):
            ms.push(samples[:, :CHUNK])
    finally:
        ms.close()


def test_workers_import_no_jax_and_events_carry_global_ids(tmp_path):
    """Workers whose init forbids jax and the JAX package run the whole
    stream (a later import of either would kill them); their events,
    written through smoke.record_worker under global channel ids, equal
    the single bank's, and so do their bytes."""
    import functools

    channels = 4
    samples, _ = _synth(channels, n_frames=6, seed=41)
    got = [[] for _ in range(channels)]
    with _bank(channels, 2, got, worker_init=functools.partial(
            torch_workers.forbid_jax_and_record, str(tmp_path))) as ms:
        ms.prewarm(CHUNK)
        for lo in range(0, samples.shape[1], CHUNK):
            ms.push(samples[:, lo:lo + CHUNK])
        ms.flush()
    events, launches = smoke.read_worker_records(str(tmp_path), channels)
    want_events = [[] for _ in range(channels)]
    ref = _run_single(samples, channels, want_events)
    assert events == ["".join(e) for e in want_events]
    assert any(events)
    assert all(b.startswith(r) for b, r in zip(_joined(got), _joined(ref)))
    assert launches == dict.fromkeys(smoke.launch_counts(), 0)  # the CPU


def test_worker_errors_raise_with_their_text():
    """A worker that cannot start exits, and the parent raises WorkerDied
    with the worker's own error text: here there is no card for
    device=None, and a worker_init fails."""
    if not torch.cuda.is_available():
        with pytest.raises(WorkerDied, match="no CUDA device") as err:
            MultiStreamBank("dmr", channels=2, n_procs=2,
                            pipeline_kwargs=KW)
        assert err.value.error and "Traceback" in err.value.error
    with pytest.raises(WorkerDied, match="worker of channel 0 refuses"):
        _bank(2, 2, worker_init=torch_workers.fail)
    assert not torch.cuda.is_initialized()


def test_jax_composite_snapshot_crosses_shard_by_shard():
    """A JAX MultiStreamBank's composite snapshot goes into the port's
    MultiStreamBank through restore_jax: each worker takes its JAX shard's
    pipeline state and pending samples (its own host machines stay), and
    the rest of the stream equals JAX banks handed the same shards."""
    channels, n_procs = 4, 2
    samples, _ = _synth(channels, n_frames=8, seed=43)
    cut = samples.shape[1] // 2
    with JMultiStream("dmr", channels=channels, n_procs=n_procs,
                      pipeline_kwargs=KW) as j_ms:
        j_ms.push(samples[:, :cut])
        blob = j_ms.snapshot()
    shards = pickle.loads(blob)["shards"]
    per = channels // n_procs
    want = []
    for w, shard in enumerate(shards):
        payload = pickle.loads(shard)
        got = [[] for _ in range(per)]
        j_bank = JBank(JDmrPipeline(channels=per, sps=10, n_centuries=2),
                       on_output=lambda c, d, got=got: got[c].append(
                           bytes(d)))
        j_bank.state = j_load_state(payload["pipeline_state"])
        j_bank.samples = JSampleBuffer(per)
        j_bank.samples.push(payload["samples"])
        j_bank.samples.consumed = 1
        for lo in range(cut, samples.shape[1], CHUNK):
            j_bank.push(samples[w * per:(w + 1) * per, lo:lo + CHUNK])
        want += _joined(got)
    got = [[] for _ in range(channels)]
    with _bank(channels, n_procs, got) as ms:
        ms.restore_jax(blob)
        for lo in range(cut, samples.shape[1], CHUNK):
            ms.push(samples[:, lo:lo + CHUNK])
        with pytest.raises(ValueError, match="dmr/4ch/2proc"):
            MultiStreamBank.restore_jax(
                ms, pickle.dumps(dict(pickle.loads(blob), channels=4,
                                      n_procs=2, protocol="ysf")))
    assert _joined(got) == want and any(want)
