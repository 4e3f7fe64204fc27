"""The decode round's CUDA-graph path (``runtime/decode_graph.py``) on the
CPU: the graph's body, packing every field's bytes into one buffer and
splitting them by its layout, gives exactly the eager path's field dict for
every adapter at its bank's padded batch shape; a bank off the card never
captures or replays a graph; and a used pipeline still snapshots, restores
and deep-copies, carrying no graph. The captures and replays themselves
run on the card (``tests/test_torch_decode_graph_cuda.py``)."""
import copy
import gc
import pickle
import threading

import numpy as np
import pytest
import torch

from digiham_tpu_torch import smoke
from digiham_tpu_torch.pipeline import (DmrPipeline, FskPipeline,
                                        NxdnPipeline, YsfPipeline)
from digiham_tpu_torch.pipeline.dmr import dmr_decode_frames
from digiham_tpu_torch.pipeline.fsk import (dstar_decode_frames,
                                            pocsag_decode_frames)
from digiham_tpu_torch.pipeline.nxdn import nxdn_decode_frames
from digiham_tpu_torch.pipeline.ysf import ysf_decode_frames
from digiham_tpu_torch.runtime import decode_graph, tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER
from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

import torch_bank

torch.set_num_threads(1)

# adapter -> (decode, symbol values, the pipeline of the bank a benchmark
# cell runs at its channels and block, or 256 channels of 4 centuries)
SITES = {
    "DmrAdapter": (dmr_decode_frames, 4,
                   lambda: DmrPipeline(256, n_centuries=16, device="cpu")),
    "YsfAdapter": (ysf_decode_frames, 4,
                   lambda: YsfPipeline(256, n_centuries=10, device="cpu")),
    "NxdnAdapter": (nxdn_decode_frames, 4,
                    lambda: NxdnPipeline(512, n_centuries=4, device="cpu")),
    "DstarAdapter": (dstar_decode_frames, 2,
                     lambda: FskPipeline(256, "dstar", n_centuries=4,
                                         device="cpu")),
    "PocsagAdapter": (pocsag_decode_frames, 2,
                      lambda: FskPipeline(256, "pocsag", n_centuries=4,
                                          device="cpu")),
}

# the fixture banks: adapter -> (stream, pipeline on the CPU)
FIXTURE_BANKS = {
    "DmrAdapter": (smoke.DMR_BANK, lambda C: DmrPipeline(
        C, sps=10, n_centuries=16, device="cpu")),
    "YsfAdapter": (smoke.YSF_BANK, lambda C: YsfPipeline(
        C, sps=10, n_centuries=10, device="cpu")),
    "NxdnAdapter": (smoke.NXDN_BANK, lambda C: NxdnPipeline(
        C, sps=20, n_centuries=4, device="cpu")),
    "DstarAdapter": (smoke.DSTAR_BANK, lambda C: FskPipeline(
        C, "dstar", n_centuries=smoke.DSTAR_BANK.n_centuries,
        device="cpu")),
    "PocsagAdapter": (smoke.POCSAG_BANK, lambda C: FskPipeline(
        C, "pocsag", n_centuries=smoke.POCSAG_BANK.n_centuries,
        sps=smoke.POCSAG_BANK.sps, device="cpu")),
}


def _round_frames(bank, values: int, fill: str) -> np.ndarray:
    """A round's padded batch: every row random, the first third random
    and the rest zero padding, or every row zero."""
    shape = (bank._batch, bank._frame_size + bank._lookahead)
    rng = np.random.default_rng(bank._batch + shape[1])
    frames = rng.integers(0, values, shape).astype(np.uint8)
    if fill == "padded":
        frames[shape[0] // 3:] = 0
    elif fill == "zeros":
        frames[:] = 0
    return frames


@pytest.mark.parametrize("fill", ["random", "padded", "zeros"])
@pytest.mark.parametrize("adapter", sorted(SITES))
def test_packed_fields_equal_the_eager_fetch(adapter, fill):
    """The graph's body (the decode, then every field packed into one
    uint8 buffer) split by its layout equals the eager path's one copy a
    field: keys in order, dtypes, shapes and values; each field starts
    aligned to its element size and the fields fill the buffer."""
    fn, values, make = SITES[adapter]
    pipe = make()
    bank = TrackedChannelBank(pipe, adapter=getattr(tracked_bank, adapter)(),
                              device="cpu")
    frames = _round_frames(bank, values, fill)
    want = tracked_bank._fetch(fn(torch.from_numpy(frames), pipe.tables()))
    packed, layout = decode_graph.pack(fn(torch.from_numpy(frames),
                                          pipe.tables()))
    assert packed.dtype == torch.uint8 and packed.dim() == 1
    assert sum(n for *_, n in layout) == packed.numel()
    for _, dtype, _, at, _ in layout:
        assert at % dtype.itemsize == 0
    got = decode_graph.unpack(packed.numpy().copy(), layout)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def _fixture_run(adapter: str, channels: int = 8):
    """The adapter's fixture bank on the CPU, run through: (bank, voice and
    events per channel, the fixture)."""
    stream, make = FIXTURE_BANKS[adapter]
    fx = smoke.load(stream)
    tile = np.arange(channels) % fx["tx_dibits"].shape[0]
    bank = TrackedChannelBank(make(channels),
                              adapter=getattr(tracked_bank, adapter)(),
                              device="cpu")
    with smoke.function_bits(fx):
        voice, events = torch_bank.run(
            bank, PipelineMetaWriter, smoke.bank_audio(stream, fx)[tile],
            fx["chunks"])
    return bank, (voice, events), fx, tile


@pytest.mark.parametrize("adapter", sorted(FIXTURE_BANKS))
def test_a_cpu_bank_never_graphs(adapter):
    """A bank on the CPU decodes every round eagerly: several rounds at
    one batch shape capture and replay nothing, keep no graph table for its
    pipeline, and give the fixture's bytes and events."""
    c = TRACER.counts
    before = (c.graph_captures, c.graph_replays, c.rounds)
    bank, (voice, events), fx, tile = _fixture_run(adapter)
    assert c.rounds - before[2] >= 3
    assert (c.graph_captures, c.graph_replays) == before[:2]
    assert bank.pipeline not in decode_graph._GRAPHS
    for ch, v in enumerate(tile):
        assert (voice[ch], events[ch]) == smoke.bank_expected(fx, v), ch


class _Uncopyable:
    """Stands in for a captured graph: neither pickles nor deep-copies."""

    def __init__(self):
        self.lock = threading.Lock()


def test_a_used_pipeline_snapshots_and_copies_without_its_graphs():
    """With an entry in the graph table for its pipeline (one that cannot
    be pickled or copied, as a captured graph cannot), a used bank still
    snapshots and restores to the same remainder, its pipeline deep-copies
    (as the mesh bank's shards are made) with no entry for the copy, and
    the entry goes with the pipeline."""
    stream, make = FIXTURE_BANKS["DmrAdapter"]
    fx = smoke.load(stream)
    audio = smoke.bank_audio(stream, fx)
    chunks = [int(n) for n in fx["chunks"]]
    bank = TrackedChannelBank(make(audio.shape[0]), device="cpu")
    torch_bank.run(bank, PipelineMetaWriter, audio, chunks[:3], flush=False)
    graphs = decode_graph._Graphs()
    graphs.captured["stand-in"] = _Uncopyable()
    decode_graph._GRAPHS[bank.pipeline] = graphs
    with pytest.raises(TypeError):
        pickle.dumps(graphs.captured)
    blob = bank.snapshot()
    twin = copy.deepcopy(bank.pipeline)
    assert twin not in decode_graph._GRAPHS
    rest = audio[:, sum(chunks[:3]):]
    want = torch_bank.run(bank, PipelineMetaWriter, rest, chunks[3:])
    second = TrackedChannelBank(twin, device="cpu")
    second.restore(blob)
    assert torch_bank.run(second, PipelineMetaWriter, rest,
                          chunks[3:]) == want
    assert second.pipeline not in decode_graph._GRAPHS
    n = len(decode_graph._GRAPHS)
    del bank
    gc.collect()
    assert len(decode_graph._GRAPHS) == n - 1


@pytest.mark.parametrize("adapter", sorted(SITES))
def test_decode_fields_off_the_card_is_the_eager_fetch(adapter):
    """The adapter's ``decode_fields`` on a CPU pipeline gives the eager
    path's dict, twice at one shape (the second use, where the card would
    capture), with one fetch a field each time."""
    fn, values, make = SITES[adapter]
    pipe = make()
    ad = getattr(tracked_bank, adapter)()
    bank = TrackedChannelBank(pipe, adapter=ad, device="cpu")
    frames = _round_frames(bank, values, "padded")
    want = tracked_bank._fetch(fn(torch.from_numpy(frames), pipe.tables()))
    for _ in range(2):
        fetches = TRACER.counts.fetches
        got = ad.decode_fields(frames, pipe)
        assert TRACER.counts.fetches - fetches == len(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
