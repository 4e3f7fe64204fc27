"""The tracked bank's sample store (``runtime/stream.py::DeviceSampleStore``)
on the CPU.

The store against the host ``SampleBuffer`` over seeded random pushes
(shorter than a block, several blocks at once, 1-D pushes broadcast to
every channel, growth past the initial capacity, one row range or a mesh
bank's several): every block a bank-like consumer hands on, every RRC
history its rebase rebuilds, and the pending tail, array for array. Then
the banks: every block ``TrackedChannelBank`` hands ``step_symbols`` and
the RRC history it carries into that step are the stream's own samples at
the bank's origin, on the DMR, YSF and NXDN fixtures and on a mesh bank;
the snapshot's and the flush's tails are the stream's unconsumed samples;
a snapshot in the host store's blob format (pending samples as a numpy
array) restores."""
import os
import pickle
import sys

import numpy as np
import pytest

from digiham_tpu_torch import smoke
from digiham_tpu_torch.pipeline import DmrPipeline, NxdnPipeline, YsfPipeline
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.checkpoint import save_state
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER
from digiham_tpu_torch.runtime.stream import (DeviceSampleStore,
                                              SampleBuffer,
                                              rrc_rebase_history)

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
from torch_scale import port_mesh  # noqa: E402

C = 4
# row ranges of the store: an unsharded bank's one, a mesh bank's two
SPLITS = {"one": [(0, C, "cpu")], "two": [(0, 1, "cpu"), (1, C, "cpu")]}
BANKS = {"dmr": (smoke.DMR_BANK, DmrPipeline, "DmrAdapter"),
         "ysf": (smoke.YSF_BANK, YsfPipeline, "YsfAdapter"),
         "nxdn": (smoke.NXDN_BANK, NxdnPipeline, "NxdnAdapter")}


def _pushes(rng, n_pushes: int, block: int):
    """Seeded pushes: [C, n] or [n] (every channel), float64 or float32,
    some row-strided views, from a few samples to several blocks."""
    for _ in range(n_pushes):
        n = int(rng.choice([rng.integers(1, block // 4),
                            rng.integers(block // 4, block),
                            rng.integers(block, 3 * block)]))
        if rng.random() < 0.2:
            yield rng.normal(0, 1000, n)
        else:
            wide = rng.normal(0, 1000, (C, n + 7)).astype(
                rng.choice([np.float32, np.float64]))
            yield wide[:, 3:3 + n]  # rows n + 7 apart


def _joined(views) -> np.ndarray:
    return np.concatenate([v.numpy() for v in views])


@pytest.mark.parametrize("cap", [64, 1 << 16])
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("seed", range(3))
def test_store_equals_sample_buffer(seed, split, cap):
    """A consumer that steps whenever ``need`` samples are pending (need a
    random lookahead past a random read position) and consumes a random
    part of each block gets the same blocks, rebased RRC histories, fills,
    consumed counts and tail from both stores."""
    rng = np.random.default_rng(seed)
    pipe = DmrPipeline(channels=C, sps=10, n_centuries=2, device="cpu")
    state = pipe.init_state()
    nt1 = state.rrc.history.shape[-1]
    host = SampleBuffer(C, initial_cap=cap)
    store = DeviceSampleStore(C, SPLITS[split], initial_cap=cap)
    block, steps = 200, 0
    before = TRACER.counts.uploads
    pushes = list(_pushes(rng, 40, block))
    for x in pushes:
        host.push(x)
        store.push(x)
        assert store.fill == host.fill
        while True:
            need = block + int(rng.integers(0, 60))
            if host.fill < need:
                break
            views = store.view(need)
            assert [v.shape[0] for v in views] == [
                hi - lo for lo, hi, _ in SPLITS[split]]
            got = _joined(views)
            want = host.view(need)
            assert got.dtype == np.float32 and np.array_equal(got, want)
            base = int(rng.integers(nt1 + 1, need))
            start = host.consumed == 0
            want_h = rrc_rebase_history(pipe, state, want, base, start)
            got_h = [rrc_rebase_history(pipe, state, v, base, start)
                     for v in views]
            assert np.array_equal(
                np.concatenate([h.history.numpy() for h in got_h]),
                want_h.history.numpy())
            host.consume(base)
            store.consume(base)
            # the histories are copies: the store moves on under them
            more = np.full(int(rng.integers(1, 40)), 7.0)
            store.push(more)
            host.push(more)
            assert np.array_equal(
                np.concatenate([h.history.numpy() for h in got_h]),
                want_h.history.numpy())
            steps += 1
            assert (store.fill, store.consumed) == (host.fill, host.consumed)
    assert steps >= 10
    assert np.array_equal(store.tail(), host.data[:, :host.fill])
    assert TRACER.counts.uploads - before == len(SPLITS[split]) * (
        len(pushes) + steps)
    assert TRACER.counts.upload_waits == 0  # no staging on the CPU


def test_store_edges():
    """A 1-D push reaches every channel, an empty push changes nothing, a
    short history zero-pads only at the stream start, neither a view past
    the fill nor a push of the wrong width is handed out, and pushes that
    torch cannot wrap are stored as ``SampleBuffer`` stores them."""
    pipe = DmrPipeline(channels=2, sps=10, n_centuries=2, device="cpu")
    state = pipe.init_state()
    store = DeviceSampleStore(2, [(0, 2, "cpu")], initial_cap=8)
    store.push(np.arange(6))
    store.push(np.zeros((2, 0)))
    store.push(np.arange(12).reshape(2, 6) + 100)
    assert store.fill == 12
    (v,) = store.view(12)
    assert np.array_equal(v.numpy()[0], [0, 1, 2, 3, 4, 5,
                                         100, 101, 102, 103, 104, 105])
    assert np.array_equal(v.numpy()[1, :6], np.arange(6))
    young = rrc_rebase_history(pipe, state, v, 10, stream_start=True)
    assert np.array_equal(young.history.numpy()[:, :70], np.zeros((2, 70)))
    assert np.array_equal(young.history.numpy()[:, 70:], v.numpy()[:, :10])
    with pytest.raises(ValueError, match="mid-stream rebase"):
        rrc_rebase_history(pipe, state, v, 10, stream_start=False)
    with pytest.raises(ValueError, match="13 samples asked of 12"):
        store.view(13)
    with pytest.raises(ValueError, match="3 rows to a store of 2"):
        store.push(np.zeros((3, 4)))
    store.consume(12)
    assert (store.fill, store.consumed, store.tail().shape) == (0, 12, (2, 0))
    # arrays torch does not wrap: negative strides, read-only, long double
    odd = [np.arange(8.0).reshape(2, 4)[:, ::-1],
           np.broadcast_to(np.arange(3, dtype=np.int64), (2, 3)),
           np.full((2, 2), 1.25, np.longdouble)]
    host = SampleBuffer(2)
    for x in odd:
        store.push(x)
        host.push(x)
    assert np.array_equal(store.tail(), host.data[:, :host.fill])


def _fixture(protocol, channels=None):
    stream, kind, adapter = BANKS[protocol]
    fx = smoke.load(stream)
    audio = smoke.bank_audio(stream, fx)
    if channels is not None:
        audio = audio[np.arange(channels) % audio.shape[0]]

    def make(mesh=None):
        return tracked_bank.TrackedChannelBank(
            kind(channels=audio.shape[0], sps=stream.sps,
                 n_centuries=stream.n_centuries, device="cpu"),
            adapter=getattr(tracked_bank, adapter)(), device="cpu",
            mesh=mesh)
    return fx, audio, make


def _spy_steps(bank, audio):
    """Wrap each shard's ``step_symbols``: every block and carried RRC
    history it is handed must be the stream's samples at the bank's
    origin (the store's ``consumed``), the history the ``ntaps-1`` before
    it (zeros before the stream's start). Returns the list of steps seen."""
    seen = []
    for sh in bank._shards:
        step = sh.pipeline.step_symbols

        def spied(x, state, step=step, sh=sh):
            at = bank.samples.consumed
            rows = audio[sh.lo:sh.hi]
            assert np.array_equal(x.numpy(), rows[:, at:at + x.shape[1]])
            hist = state.rrc.history.numpy()
            nt1 = hist.shape[1]
            want = np.zeros_like(hist)
            lo = max(0, at - nt1)
            want[:, nt1 - (at - lo):] = rows[:, lo:at]
            assert np.array_equal(hist, want)
            seen.append((sh.lo, at, x.shape[1]))
            return step(x, state)

        sh.pipeline.step_symbols = spied
    return seen


def _push(bank, audio, chunks, lo: int = 0) -> int:
    for n in chunks:
        bank.push(audio[:, lo:lo + n])
        lo += n
    return lo


@pytest.mark.parametrize("protocol", sorted(BANKS))
def test_bank_blocks_and_tails_are_the_stream(protocol, monkeypatch):
    """The fixture's bank: each step's block and carried RRC history, the
    snapshot's samples mid-stream and the tail the flush filters are the
    stream's own samples."""
    fx, audio, make = _fixture(protocol)
    bank = make()
    seen = _spy_steps(bank, audio)
    chunks = fx["chunks"]
    pushed = _push(bank, audio, chunks[:len(chunks) // 2])
    payload = pickle.loads(bank.snapshot())
    at = bank.samples.consumed
    assert payload["samples"].dtype == np.float32
    assert np.array_equal(payload["samples"], audio[:, at:pushed])
    pushed = _push(bank, audio, chunks[len(chunks) // 2:], pushed)
    assert pushed == audio.shape[1] and len(seen) == bank.steps >= 2
    tails = []
    flush_demod = tracked_bank._flush_demod

    def spied(pipeline, rrc, demod, tail, pos=0):
        tails.append(tail.copy())
        return flush_demod(pipeline, rrc, demod, tail, pos)

    monkeypatch.setattr(tracked_bank, "_flush_demod", spied)
    at = bank.samples.consumed
    bank.flush()
    (tail,) = tails
    assert np.array_equal(tail, audio[:, at:]) and tail.shape[1]
    assert bank.samples is None


def test_mesh_bank_store():
    """A (2, 1) mesh bank: each shard's store holds its rows, every block
    and history it steps are its rows of the stream, and the bytes and
    events equal the unsharded bank's."""
    fx, audio, make = _fixture("dmr", channels=4)
    bank = make(port_mesh((2, 1)))
    seen = _spy_steps(bank, audio)
    got = torch_bank.run(bank, PipelineMetaWriter, audio, fx["chunks"])
    assert sorted({lo for lo, _, _ in seen}) == [0, 2]
    assert len(seen) == 2 * bank.steps
    want = torch_bank.run(make(), PipelineMetaWriter, audio, fx["chunks"])
    assert got == want and any(want[0])


def test_a_host_store_snapshot_restores():
    """A blob whose pending samples come from the host ``SampleBuffer``
    (the format every earlier snapshot has: a numpy array) restores into
    the bank, which then gives what the uninterrupted bank gives."""
    fx, audio, make = _fixture("ysf")
    chunks = fx["chunks"]
    cut = len(chunks) // 2
    first = make()
    pushed = _push(first, audio, chunks[:cut])
    host = SampleBuffer(audio.shape[0])
    host.push(audio[:, :pushed])
    host.consume(first.samples.consumed)
    blob = pickle.dumps({"pipeline_state": save_state(first.state),
                         "chans": pickle.dumps(first.chans),
                         "samples": host.data[:, :host.fill].copy()})
    assert pickle.loads(first.snapshot()).keys() == pickle.loads(blob).keys()
    rest = audio[:, pushed:]
    want = torch_bank.run(first, PipelineMetaWriter, rest, chunks[cut:])
    second = make()
    second.restore(blob)
    assert (second.samples.fill, second.samples.consumed) == (host.fill, 1)
    got = torch_bank.run(second, PipelineMetaWriter, rest, chunks[cut:])
    assert got == want and any(want[0])
