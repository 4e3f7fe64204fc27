"""The tracked bank's sample store on the card
(``runtime/stream.py::DeviceSampleStore``): the DMR, YSF and NXDN fixture
banks on the card, which step views of the store uploaded from pinned
staging, give the bytes and events of the same banks on the CPU, with one
upload a push; many small pushes with no step between them, their uploads
queued behind the stream, reuse the two staging slots (waiting for a slot
still in flight) and leave in the store exactly the samples pushed.
Needs an NVIDIA GPU and nvcc (marker ``cuda``); without a card every test
here skips. Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_sample_store_cuda.py``
(``--noconftest``: the suite's conftest imports JAX)."""
import numpy as np
import pytest
import torch

from digiham_tpu_torch import smoke
from digiham_tpu_torch.pipeline import DmrPipeline, NxdnPipeline, YsfPipeline
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER
from digiham_tpu_torch.runtime.stream import DeviceSampleStore

import torch_bank

pytestmark = pytest.mark.cuda

# adapter -> (the fixture's stream, its pipeline at C channels on a device)
BANKS = {
    "DmrAdapter": (smoke.DMR_BANK, lambda C, d: DmrPipeline(
        C, sps=10, n_centuries=16, device=d)),
    "YsfAdapter": (smoke.YSF_BANK, lambda C, d: YsfPipeline(
        C, sps=10, n_centuries=10, device=d)),
    "NxdnAdapter": (smoke.NXDN_BANK, lambda C, d: NxdnPipeline(
        C, sps=20, n_centuries=4, device=d)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ only)")
    return torch.device("cuda")


def _uploads():
    return TRACER.counts.uploads, TRACER.counts.upload_waits


@pytest.mark.parametrize("adapter", sorted(BANKS))
def test_banks_on_card_equal_the_cpu_banks(dev, adapter):
    """The fixture's bank at 16 channels on the card and on the CPU: equal
    voice bytes and events, each the fixture's; on the card one upload a
    push, from pinned staging."""
    stream, make = BANKS[adapter]
    fx = smoke.load(stream)
    tile = np.arange(16) % fx["tx_dibits"].shape[0]
    audio = smoke.bank_audio(stream, fx)[tile]
    runs = {}
    for where in ("cpu", dev):
        bank = tracked_bank.TrackedChannelBank(
            make(16, where), adapter=getattr(tracked_bank, adapter)(),
            device=where)
        store, tails = bank.samples, []
        pending = bank._pending
        bank._pending = lambda: tails.append(pending()) or tails[-1]
        before = _uploads()
        runs[str(where)] = torch_bank.run(bank, PipelineMetaWriter, audio,
                                          fx["chunks"],
                                          tail=stream.flush_tail)
        uploads, _ = (a - b for a, b in zip(_uploads(), before))
        assert uploads == len(fx["chunks"])
        (rows,) = store._rows
        assert rows.data.device.type == torch.device(where).type
        if where != "cpu":
            assert all(s is not None and s.is_pinned() for s in rows.stage)
        (tail,) = tails  # the flush's: the stream's last samples
        assert np.array_equal(tail, audio[:, -stream.flush_tail:])
    assert runs["cuda"] == runs["cpu"]
    for c, v in enumerate(tile):
        assert (runs["cpu"][0][c], runs["cpu"][1][c]) == \
            smoke.bank_expected(fx, v), c


def test_small_pushes_reuse_the_staging_slots(dev):
    """Pushes of 960 samples with no step between them, made while the
    stream is held up: the third push finds its slot's upload still in
    flight and waits for it; the store then holds exactly what was pushed,
    in order, and its blocks equal a CPU store's."""
    C = 64
    rng = np.random.default_rng(5)
    chunks = [rng.normal(0, 1000, (C, 960)).astype(np.float32)
              for _ in range(12)]
    card = DeviceSampleStore(C, [(0, 32, dev), (32, C, dev)])
    host = DeviceSampleStore(C, [(0, C, "cpu")])
    before = _uploads()
    torch.cuda._sleep(200_000_000)  # hold the stream for ~0.1 s
    for x in chunks:
        card.push(x)
        host.push(x)
    uploads, waits = (a - b for a, b in zip(_uploads(), before))
    assert uploads == 3 * len(chunks)  # the card's two ranges, the CPU's one
    assert waits >= 1
    for r in card._rows:
        assert all(s.is_pinned() for s in r.stage)
        assert r.stage[0].numel() == (r.hi - r.lo) * 960
    want = np.concatenate(chunks, axis=1)
    assert np.array_equal(card.tail(), want)
    card.consume(2000)
    host.consume(2000)
    got = torch.cat([v.cpu() for v in card.view(5000)]).numpy()
    assert np.array_equal(got, host.view(5000)[0].numpy())
