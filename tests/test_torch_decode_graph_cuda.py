"""The decode round's CUDA graphs on the card (``runtime/decode_graph.py``):
for every adapter, successive graphed rounds on new frames equal the eager
path and alias nothing of each other; a shape used once stays eager; each
replay counts the K5 launches its graph holds, and the profiler sees each
of them; the DMR and NXDN banks on the card, whose rounds replay graphs,
give the bytes and events of the same banks on the CPU.
Needs an NVIDIA GPU and nvcc (marker ``cuda``); without a card every test
here skips. Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_decode_graph_cuda.py``
(``--noconftest``: the suite's conftest imports JAX)."""
import numpy as np
import pytest
import torch

from digiham_tpu_torch import smoke
from digiham_tpu_torch.bench.common import profiled
from digiham_tpu_torch.ops import viterbi
from digiham_tpu_torch.pipeline import (DmrPipeline, FskPipeline,
                                        NxdnPipeline, YsfPipeline)
from digiham_tpu_torch.pipeline.dmr import dmr_decode_frames
from digiham_tpu_torch.pipeline.fsk import (dstar_decode_frames,
                                            pocsag_decode_frames)
from digiham_tpu_torch.pipeline.nxdn import nxdn_decode_frames
from digiham_tpu_torch.pipeline.ysf import ysf_decode_frames
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER
from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

import torch_bank

pytestmark = pytest.mark.cuda

# adapter -> (decode, symbol values, K5 launches a round, the fixture's
# stream, its pipeline at C channels on a device)
ADAPTERS = {
    "DmrAdapter": (dmr_decode_frames, 4, 0, smoke.DMR_BANK,
                   lambda C, d: DmrPipeline(C, sps=10, n_centuries=16,
                                            device=d)),
    "YsfAdapter": (ysf_decode_frames, 4, 1, smoke.YSF_BANK,
                   lambda C, d: YsfPipeline(C, sps=10, n_centuries=10,
                                            device=d)),
    "NxdnAdapter": (nxdn_decode_frames, 4, 1, smoke.NXDN_BANK,
                    lambda C, d: NxdnPipeline(C, sps=20, n_centuries=4,
                                              device=d)),
    "DstarAdapter": (dstar_decode_frames, 2, 0, smoke.DSTAR_BANK,
                     lambda C, d: FskPipeline(
                         C, "dstar", n_centuries=smoke.DSTAR_BANK.n_centuries,
                         device=d)),
    "PocsagAdapter": (pocsag_decode_frames, 2, 0, smoke.POCSAG_BANK,
                      lambda C, d: FskPipeline(
                          C, "pocsag",
                          n_centuries=smoke.POCSAG_BANK.n_centuries,
                          sps=smoke.POCSAG_BANK.sps, device=d)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ only)")
    return torch.device("cuda")


def _site(adapter: str, dev, channels: int = 64):
    """(decode, adapter, pipeline on the card, round batches: five random
    batches at the bank's padded shape, the first third of each real
    frames and the rest zero padding)."""
    fn, values, _, _, make = ADAPTERS[adapter]
    pipe = make(channels, dev)
    ad = getattr(tracked_bank, adapter)()
    bank = TrackedChannelBank(pipe, adapter=ad)
    shape = (bank._batch, bank._frame_size + bank._lookahead)
    rng = np.random.default_rng(shape[0])
    batches = []
    for _ in range(5):
        f = rng.integers(0, values, shape).astype(np.uint8)
        f[shape[0] // 3:] = 0
        batches.append(f)
    return fn, ad, pipe, batches


def _eager(fn, frames, pipe) -> dict:
    """The eager path on the card: the chain, one copy a field."""
    return tracked_bank._fetch(fn(torch.from_numpy(frames).to(pipe.device),
                                  pipe.tables()))


def _counts():
    c = TRACER.counts
    return c.graph_captures, c.graph_replays, c.fetches


@pytest.mark.parametrize("adapter", sorted(ADAPTERS))
def test_graphed_rounds_equal_the_eager_path(dev, adapter):
    """Five rounds at one shape: the first eager, the second captured (its
    fields from the warm-up run), three replays on new frames, each one
    fetch; every round's dict, read after the last, equals the eager
    path's on its frames (keys, dtypes, shapes, values), so the replays read
    their new input and no round's arrays alias another's."""
    fn, ad, pipe, batches = _site(adapter, dev)
    want = [_eager(fn, f, pipe) for f in batches]
    got, steps = [], []
    for f in batches:
        before = _counts()
        got.append(ad.decode_fields(f, pipe))
        steps.append(tuple(a - b for a, b in zip(_counts(), before)))
    n = len(want[0])
    assert steps == [(0, 0, n), (1, 0, 1), (0, 1, 1), (0, 1, 1), (0, 1, 1)]
    for r, (g, w) in enumerate(zip(got, want)):
        assert list(g)[:n] == list(w), r
        for k, v in w.items():
            assert g[k].dtype == v.dtype and g[k].shape == v.shape, (r, k)
            assert np.array_equal(g[k], v), (r, k)
        if adapter == "DmrAdapter":
            assert np.array_equal(g["lc_packed"], np.packbits(
                w["bptc_data"].astype(np.uint8), axis=-1)), r


def test_a_shape_used_once_stays_eager(dev):
    """Shapes used once each (the timing programs' odd shapes, a mesh
    shard's one-off overflow) capture nothing and fetch a field at a time;
    a shape's second use captures."""
    fn, ad, pipe, batches = _site("NxdnAdapter", dev)
    n = len(_eager(fn, batches[0], pipe))
    before = _counts()
    for rows in (17, 100, 1):
        ad.decode_fields(batches[0][:rows], pipe)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 3 * n)
    ad.decode_fields(batches[1][:100], pipe)
    assert _counts()[0] - before[0] == 1


@pytest.mark.parametrize("adapter", sorted(ADAPTERS))
def test_each_replay_counts_its_k5_launches(dev, adapter):
    """The capture round launches K5 once for its warm-up (YSF, NXDN) and
    counts nothing for the capture; each replay adds the launches its graph
    holds; a profiler session around three replays sees exactly that many
    ``viterbi_kernel`` records, and none of its launches lacks its record
    (the benchmark's test of a complete slice)."""
    fn, ad, pipe, batches = _site(adapter, dev)
    k5 = ADAPTERS[adapter][2]
    ad.decode_fields(batches[0], pipe)
    before = viterbi.LAUNCHES
    ad.decode_fields(batches[1], pipe)
    assert viterbi.LAUNCHES - before == k5
    counted = []

    def replays():
        before = viterbi.LAUNCHES
        for f in batches[2:]:
            ad.decode_fields(f, pipe)
        counted.append(viterbi.LAUNCHES - before)

    session, _ = profiled(replays, dev)
    assert counted and set(counted) == {3 * k5}
    assert session.complete
    assert sum("viterbi_kernel" in e.name for e in session.events) == 3 * k5


@pytest.mark.parametrize("adapter", ["DmrAdapter", "NxdnAdapter"])
def test_banks_on_card_equal_the_cpu_banks(dev, adapter):
    """The fixture's bank at 16 channels on the card, whose decode rounds
    replay graphs after the first two, gives byte-identical voice and
    events to the same bank on the CPU."""
    _, _, _, stream, make = ADAPTERS[adapter]
    fx = smoke.load(stream)
    tile = np.arange(16) % fx["tx_dibits"].shape[0]
    audio = smoke.bank_audio(stream, fx)[tile]
    runs = {}
    for where in ("cpu", dev):
        bank = TrackedChannelBank(make(16, where),
                                  adapter=getattr(tracked_bank, adapter)(),
                                  device=where)
        before = _counts()
        runs[str(where)] = torch_bank.run(bank, PipelineMetaWriter, audio,
                                          fx["chunks"])
        graphed = [a - b for a, b in zip(_counts(), before)][:2]
        assert graphed[0] == (where != "cpu")
        assert (graphed[1] > 0) == (where != "cpu")
    assert runs["cuda"] == runs["cpu"]
    for c, v in enumerate(tile):
        assert (runs["cpu"][0][c], runs["cpu"][1][c]) == \
            smoke.bank_expected(fx, v), c
