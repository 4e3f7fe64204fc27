"""The D-Star receive site (``benchmark/configs/dstar_site.json`` under the
``busy`` mix) on the CPU: each kind of call its TX module sends decodes through the plain
reference (``benchmark/reference/dstar``) as that kind; the reference's
per-channel decoder equals the port's ``protocols.dstar.make_decoder`` on
the same bits; through the harness at 4 channels the port's bank equals
the reference, every compared number 0; the reference one precision
below the configuration's (bfloat16) fails the comparison; and the port's
D-Star counters count the headers the reference decodes, on the same
bits. The cell is BENCHMARK.json's ``dstar_site.busy``; its traffic sends
each bit as a rect pulse, as every mix of the one generator does."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, run  # noqa: E402
from benchmark.harness import spec  # noqa: E402
from benchmark.reference import stream  # noqa: E402
from benchmark.reference.dstar import header as ref_header  # noqa: E402
from benchmark.reference.dstar.phases import (HEADER_SYNC,  # noqa: E402
                                              VOICE_SYNC)
from benchmark.synth import dstar  # noqa: E402
from digiham_tpu_torch.pipeline import FskPipeline  # noqa: E402
from digiham_tpu_torch.protocols.dstar import make_decoder  # noqa: E402
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter  # noqa: E402
from digiham_tpu_torch.runtime.metrics import TRACER  # noqa: E402
from digiham_tpu_torch.runtime.tracked_bank import (  # noqa: E402
    DstarAdapter, TrackedChannelBank)

torch.set_num_threads(1)

CELL = "dstar_site.busy"
SEED = 2**31 + 24


def small_cell(**mix_over):
    """The cell at a size the CPU runs in seconds: 4 channels, loops of two
    1-3 s calls (variants 0 and 1) or four (every variant), every channel
    checked."""
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, channels=4)
    cell.mix = dict(cell.mix, calls_per_loop=2, call_seconds=[1.0, 3.0],
                    checked_channels=4, warm_up_blocks=2)
    cell.mix.update(mix_over)
    return cell


def _with_errors(rng, bits, rate=0.01):
    """``bits`` with ``rate`` of them replaced by random bits, noise bits
    around."""
    bits = bits.copy()
    hit = rng.choice(len(bits), int(rate * len(bits)), replace=False)
    bits[hit] = rng.integers(0, 2, len(hit))
    return np.concatenate([rng.integers(0, 2, 400), bits,
                           rng.integers(0, 2, 400)]).astype(np.uint8)


def _events(row):
    return [e.decode() for _, e in stream.decode_channel("dstar", row)[1]]


@pytest.mark.parametrize("variant", range(4))
def test_every_variant_decodes_as_its_kind(variant):
    """Without errors: every voice frame comes out (a late entry's after
    its second voice sync), and the events carry the call's kind: the RF
    header's callsigns and the message (0, 1), the D-PRS report and the
    GGA's coordinates (2), the header from slow data and the message with
    no RF header (3); the terminator resets the metadata."""
    rng = np.random.default_rng(SEED + variant)
    bits = dstar.call(rng, 3.0, variant)
    row = np.concatenate([np.zeros(200, np.uint8), bits,
                          np.zeros(200, np.uint8)])
    frames, _ = stream.decode_channel("dstar", row)
    events = _events(row)
    # the RF header's 739 bits before the frames; the terminator's frame
    # 24 bits longer than a frame; a late entry unvoiced up to its second
    # voice sync: the sync frame it locks on, the superframe, the next sync
    head = 0 if variant == 3 else len(dstar.PREAMBLE) + 15 + 660
    late = dstar.SUPERFRAME + 2 if variant == 3 else 0
    n = (len(bits) - head - 24) // dstar.FRAME_BITS - late
    assert [len(b) for _, b in frames] == [9] * n
    first = events[0]
    assert "ourcall:" in first and "yourcall:CQCQCQ" in first
    assert "departure:DIRECT" in first and "sync:voice" in first
    assert events[-1] == "protocol:DSTAR\n"
    if variant in (0, 1, 3):
        assert any("message:" in e and "via D-STAR" in e for e in events)
    if variant == 2:
        assert any("dprs:" in e and ">API705,DSTAR*:!" in e for e in events)
        assert any("lat:" in e and "lon:" in e for e in events)


def test_late_entry_sends_no_rf_header():
    """A late entry starts at a voice sync, with no header sync anywhere;
    the other kinds start with the preamble and the header sync."""
    rng = np.random.default_rng(SEED)
    bits = dstar.call(rng, 2.0, 3)
    windows = np.lib.stride_tricks.sliding_window_view(bits, 24)
    assert not (windows == HEADER_SYNC).all(1).any()
    assert (bits[72:96] == VOICE_SYNC).all()
    bits = dstar.call(rng, 2.0, 0)
    assert (bits[64 - 9:64 + 15] == HEADER_SYNC).all()


def _tx_rows(rate=0.01):
    """A call of every variant, ``rate`` of its bits replaced, twice."""
    rng = np.random.default_rng(SEED)
    return [_with_errors(rng, dstar.call(rng, 2.5, v % 4), rate)
            for v in range(8)]


def _port_decode(row):
    dec, events = make_decoder(), []
    dec.set_meta_writer(PipelineMetaWriter(events.append))
    return dec.process(row), events


@pytest.mark.parametrize("streams", ["host_synth", "tx"])
def test_decoder_equals_the_programs(streams):
    """Bytes and events of ``reference/dstar`` against the port's
    ``protocols.dstar.make_decoder``: on the port's fuzz streams (voice
    streams, voice-sync entries, lone headers, terminated calls) and on
    the benchmark's calls of every variant with errors."""
    if streams == "host_synth":
        from digiham_tpu_torch.bench import host_synth

        rng = np.random.default_rng(SEED)
        rows = [host_synth.synth_dstar(rng) for _ in range(12)]
    else:
        rows = _tx_rows()
    voiced = 0
    for row in rows:
        frames, events = stream.decode_channel("dstar", row)
        voice, ev = _port_decode(row)
        assert b"".join(b for _, b in frames) == voice
        assert [e for _, e in events] == ev
        voiced += bool(frames)
    assert voiced >= len(rows) // 2


def _run(cell, seed=SEED, seconds=2.0, trace=False):
    return run.measure(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), n_workers=1)


@pytest.mark.parametrize("calls", [2, 4])
def test_bank_equals_reference(calls):
    """Through the harness at 4 channels: the port's bank against the
    reference, symbols, frames and events, every number 0."""
    result, _ = _run(small_cell(calls_per_loop=calls))
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert result["attempted"] > 100 and result["failed"] == 0


def test_lower_precision_fails():
    numbers, frames, _ = control.control(small_cell(), 1, 8 * 48000, "cpu",
                                         n_workers=1)
    assert frames > 100
    assert any(v["value"] > v["limit"] for v in numbers.values()), numbers


class _RefCounts:
    """The reference's header decodes, counted by wrapping its header
    parsers: RF headers passed and failed, headers from slow data."""

    def __init__(self, monkeypatch):
        self.rf = []
        self.frame_data = []
        from_header = ref_header.Header.parse_from_header
        from_frame = ref_header.Header.parse_from_frame_data

        def rf(bits):
            h = from_header(bits)
            self.rf.append(h is not None)
            return h

        def frame(data):
            h = from_frame(data)
            self.frame_data.append(h is not None)
            return h

        monkeypatch.setattr(ref_header.Header, "parse_from_header",
                            staticmethod(rf))
        monkeypatch.setattr(ref_header.Header, "parse_from_frame_data",
                            staticmethod(frame))

    def counts(self):
        ok = sum(self.rf)
        # an RF header that passes went through parse_from_frame_data too
        return {"dstar_headers": ok,
                "dstar_header_fails": len(self.rf) - ok,
                "dstar_slow_headers": sum(self.frame_data) - ok}


def _bank_counts(rows, chunk):
    """The counters' change over one bank's push of ``rows`` in chunks of
    ``chunk`` bits, and flush; the header spans it recorded."""
    C = len(rows)
    bank = TrackedChannelBank(FskPipeline(C, "dstar", n_centuries=2,
                                          device="cpu"),
                              adapter=DstarAdapter(), device="cpu")
    n = min(len(r) for r in rows)
    bits = np.stack([r[:n] for r in rows])
    names = ("dstar_headers", "dstar_header_fails", "dstar_slow_headers")
    before = [getattr(TRACER.counts, k) for k in names]
    TRACER.start()
    try:
        for i in range(0, n, chunk):
            bank.push_dibits(bits[:, i:i + chunk])
    finally:
        TRACER.stop()
    spans = [s for s in TRACER.spans() if s.name == "bank.hunt.header"]
    got = {k: getattr(TRACER.counts, k) - b for k, b in zip(names, before)}
    return got, spans, bits


def test_counters_count_the_headers_the_reference_decodes(monkeypatch):
    """``dstar_headers``, ``dstar_header_fails`` and
    ``dstar_slow_headers`` over a bank's bits equal the reference's header
    decodes on the same bits; each RF header decode is one
    ``bank.hunt.header`` span under ``bank.hunt``."""
    rows = _tx_rows(0.002)
    # a call whose RF header is broken beyond repair
    rng = np.random.default_rng(SEED)
    bad = dstar.call(rng, 2.5, 0)
    bad[79 + rng.choice(660, 60, replace=False)] ^= 1
    rows.append(_with_errors(rng, bad, 0.0))
    got, spans, bits = _bank_counts(rows, 333)
    refs = _RefCounts(monkeypatch)
    for row in bits:
        stream.decode_channel("dstar", row)
    want = refs.counts()
    assert got == want
    assert want["dstar_headers"] >= 4 and want["dstar_slow_headers"] >= 2
    assert want["dstar_header_fails"] >= 1
    assert len(spans) == got["dstar_headers"] + got["dstar_header_fails"]
    by_id = {s.id: s for s in TRACER.spans()}
    assert {by_id[s.parent].name for s in spans} == {"bank.hunt"}
