"""The banks' tracer (``digiham_tpu_torch/runtime/metrics.py``): spans and
counters inside ``TrackedChannelBank`` and ``TimeShardedTrackedBank``.

On the DMR, YSF and D-Star bank fixtures: tracing on or off hands over the
same voice bytes and events and the same counts, and off records no span;
on, every span lies inside its parent, parents and step numbers agree, the
spans count the pushes and steps, the steps' counts sum to the counters,
and the self times of a push's spans sum to its duration; a D-Star hunt's
header decodes are ``bank.hunt.header`` spans, as many as the D-Star
header counters count. The anchor maps
a span onto Kineto's interval of the op it holds; the ring keeps the
newest spans; ``DIGIHAM_METRICS_EVERY`` reports the counters."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from digiham_tpu_torch import smoke
from digiham_tpu_torch.dsp.demod import demod_init, gfsk_demod_block
from digiham_tpu_torch.parallel.streaming import TimeShardedPipeline
from digiham_tpu_torch.pipeline import DmrPipeline, FskPipeline, YsfPipeline
from digiham_tpu_torch.runtime import metrics, tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import COUNTERS, TRACER
from digiham_tpu_torch.runtime.stream import StreamDriver

sys.path.insert(0, os.path.dirname(__file__))
import torch_bank  # noqa: E402
from torch_scale import port_mesh  # noqa: E402

torch.set_num_threads(1)

BANKS = {"dmr": (smoke.DMR_BANK, DmrPipeline, "DmrAdapter"),
         "ysf": (smoke.YSF_BANK, YsfPipeline, "YsfAdapter"),
         "dstar": (smoke.DSTAR_BANK, FskPipeline, "DstarAdapter")}
# each span's name -> the names its parent may have (None: the top)
PARENTS = {
    "bank.push": {None},
    "bank.flush": {None},
    "bank.buffer": {"bank.push"},
    "bank.step": {"bank.push"},
    "bank.launch": {"bank.step"},
    "bank.upload": {"bank.buffer"},
    "bank.fetch": {"bank.push", "bank.step", "bank.decode", "bank.flush"},
    "bank.hunt": {"bank.step", "bank.flush"},
    "bank.hunt.header": {"bank.hunt"},
    "bank.round": {"bank.step", "bank.flush"},
    "bank.round.pack": {"bank.round"},
    "bank.decode": {"bank.round"},
    "bank.track": {"bank.round"},
}
STEPS = ("bank.step", "bank.flush")  # the spans that carry counts


def _counts_since(before) -> dict:
    return dict(zip(COUNTERS, (a - b for a, b in
                               zip(TRACER.counts.values(), before))))


def _traced(run, trace: bool):
    """``run()`` with the tracer on or off: (its result, the counts it
    added, the spans it recorded; None when off, and then it records
    none)."""
    before = TRACER.counts.values()
    closed = TRACER.closed
    if trace:
        TRACER.start()
    try:
        out = run()
    finally:
        TRACER.stop()
    if not trace:
        assert TRACER.closed == closed  # off: no span recorded
    return out, _counts_since(before), TRACER.spans() if trace else None


def _fixture_bank(protocol):
    stream, kind, adapter = BANKS[protocol]
    fx = smoke.load(stream)
    audio = smoke.bank_audio(stream, fx)
    bank = tracked_bank.TrackedChannelBank(
        kind(channels=audio.shape[0], sps=stream.sps,
             n_centuries=stream.n_centuries, device="cpu"),
        adapter=getattr(tracked_bank, adapter)(), device="cpu")
    return bank, fx, audio


@pytest.fixture(scope="module", params=sorted(BANKS))
def runs(request):
    """The protocol's fixture bank pushed and flushed with the tracer off,
    then on: (fixture, {trace: (bank, outputs, counts, spans)})."""
    out = {}
    for trace in (False, True):
        bank, fx, audio = _fixture_bank(request.param)
        result, counts, spans = _traced(
            lambda: torch_bank.run(bank, PipelineMetaWriter, audio,
                                   fx["chunks"]), trace)
        out[trace] = (bank, result, counts, spans)
    return fx, out


def _enclosing_step(span, by_id):
    while span is not None and span.name not in STEPS:
        span = by_id.get(span.parent)
    return span


def test_tracing_changes_no_output(runs):
    fx, out = runs
    (_, off, off_counts, _), (_, on, on_counts, _) = out[False], out[True]
    assert on == off and on_counts == off_counts
    for v in range(fx["tx_dibits"].shape[0]):
        assert (on[0][v], on[1][v]) == smoke.bank_expected(fx, v), v


def test_spans_nest(runs):
    _, out = runs
    spans = out[True][3]
    by_id = {s.id: s for s in spans}
    assert sorted(by_id) == list(range(len(spans)))  # nothing dropped
    for s in spans:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) in PARENTS[s.name], s.name
        assert s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.id < s.id
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert parent.step <= s.step
        step = _enclosing_step(s, by_id)
        if step is not None:
            assert s.step == step.step, s.name
    numbers = [s.step for s in sorted(spans, key=lambda s: s.id)
               if s.name in STEPS]
    assert numbers == list(range(1, len(numbers) + 1))


def test_spans_count_pushes_steps_and_work(runs):
    fx, out = runs
    bank, _, counts, spans = out[True]
    names = [s.name for s in spans]
    assert names.count("bank.push") == len(fx["chunks"])
    assert names.count("bank.step") == bank.steps == counts["steps"] >= 5
    assert names.count("bank.flush") == 1
    assert names.count("bank.launch") == bank.steps
    # one upload a push into the sample store (every chunk holds samples)
    assert names.count("bank.upload") == counts["uploads"] \
        == len(fx["chunks"])
    assert counts["upload_waits"] == 0  # none on the CPU: no staging
    assert names.count("bank.fetch") == counts["fetches"]
    assert names.count("bank.decode") == counts["rounds"] > 0
    summed = dict.fromkeys(COUNTERS, 0)
    for s in spans:
        if s.name in STEPS:
            for k in COUNTERS:
                summed[k] += s.counts[k]
        else:
            assert s.counts is None
    assert summed == counts
    p = bank.pipeline
    assert counts["samples"] == bank.steps * bank.channels * (
        p.n_centuries * 100 * p.sps)
    assert 0 < counts["frames"] <= counts["rows_sent"]
    assert counts["rows_sent"] == counts["rounds"] * bank._batch
    assert 0 < counts["voice_frames"] <= counts["frames"]
    assert 0 < counts["fast_skips"] <= counts["hunting"]
    assert counts["locks"] > 0


def test_emb_lcs_counts_the_dmr_trackers_lc_checks(runs):
    """``emb_lcs``: each embedded LC a DMR tracker asks for at a
    superframe's last fragment; YSF has none."""
    _, out = runs
    bank, _, counts, _ = out[False]
    if isinstance(bank.adapter, tracked_bank.DmrAdapter):
        assert 0 < counts["emb_lcs"] <= counts["frames"]
    else:
        assert counts["emb_lcs"] == 0


def test_dstar_header_spans_and_counters(runs):
    """A ``bank.hunt.header`` span for each header decode of a D-Star
    hunt, which ``dstar_headers`` or ``dstar_header_fails`` counts (the
    fixture holds good headers and a broken one); the other protocols
    count none."""
    _, out = runs
    bank, _, counts, spans = out[True]
    headers = [s for s in spans if s.name == "bank.hunt.header"]
    decoded = counts["dstar_headers"] + counts["dstar_header_fails"]
    assert len(headers) == decoded
    if isinstance(bank.adapter, tracked_bank.DstarAdapter):
        assert counts["dstar_headers"] > 0 and counts["dstar_header_fails"] > 0
    else:
        assert decoded == counts["dstar_slow_headers"] == 0


def test_push_self_times_sum_to_its_duration(runs):
    _, out = runs
    spans = out[True][3]
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)

    def self_ns(s):
        own = (s.end_ns - s.start_ns
               - sum(c.end_ns - c.start_ns for c in children.get(s.id, ())))
        assert own >= 0, s.name  # siblings do not overlap their parent
        return own + sum(self_ns(c) for c in children.get(s.id, ()))

    for push in (s for s in spans if s.name == "bank.push"):
        total = push.end_ns - push.start_ns
        assert abs(self_ns(push) - total) <= 0.01 * total


def test_time_sharded_bank_spans():
    """The time-sharded bank gives the same output traced or not; each of
    its steps is a span with one launch under it."""
    fx = smoke.load(smoke.DMR_BANK)
    audio = smoke.bank_audio(smoke.DMR_BANK, fx)[:2]

    def run():
        bank = tracked_bank.TimeShardedTrackedBank(
            TimeShardedPipeline(port_mesh((2, 2)), 2, "dmr"), device="cpu")
        return bank, torch_bank.run(bank, PipelineMetaWriter, audio,
                                    fx["chunks"])

    (_, off), off_counts, _ = _traced(run, False)
    (bank, on), on_counts, spans = _traced(run, True)
    assert on == off and on_counts == off_counts and bank.steps >= 1
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "bank.step"]
    assert len(steps) == bank.steps == on_counts["steps"]
    launches = [by_id[s.parent] for s in spans if s.name == "bank.launch"]
    assert sorted(s.id for s in launches) == sorted(s.id for s in steps)
    assert sum(s.counts["steps"] for s in spans if s.counts) == bank.steps


def test_stream_driver_steps_are_counted():
    C, sps, nc = 2, 10, 2
    driver = StreamDriver(C, sps, gfsk_demod_block, demod_init(C, "cpu"),
                          n_centuries=nc, device="cpu")
    x = np.random.default_rng(0).normal(0, 1000, (C, 9000)).astype(
        np.float32)
    blocks, counts, spans = _traced(lambda: driver.push(x), True)
    assert len(blocks) == counts["steps"] >= 2
    assert counts["samples"] == counts["steps"] * C * nc * 100 * sps
    assert [s.name for s in spans] == ["stream.step"] * len(blocks)


def test_off_is_a_shared_no_op(monkeypatch):
    tracer = metrics.Tracer()

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(metrics.time, "perf_counter_ns", no_clock)
    first, second = tracer.span("a"), tracer.span("b", step=True)
    assert first is second
    with first as inside:
        assert inside is None
    assert tracer.closed == 0 and not tracer.spans()


def test_ring_keeps_the_newest_spans(tmp_path):
    tracer = metrics.Tracer(capacity=4)
    tracer.start()
    for i in range(5):
        with tracer.span("bank.step", step=True):
            with tracer.span("bank.hunt"):
                tracer.counts.hunting += i
    tracer.stop()
    kept = tracer.spans()
    assert [s.name for s in kept] == ["bank.hunt", "bank.step"] * 2
    assert [s.step for s in kept] == [4, 4, 5, 5]
    assert kept[-1].counts["hunting"] == 4 and kept[1].counts["hunting"] == 3
    path = tmp_path / "record.jsonl"
    tracer.write(str(path))
    header, *lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert header["spans"] == 4 and header["dropped"] == 6
    assert header["counts"]["hunting"] == 10
    assert header["anchor"] == list(tracer.anchor)
    assert header["anchor_end"][0] > header["anchor"][0]
    assert [x["id"] for x in lines] == [s.id for s in kept]
    assert lines[-1]["counts"] == kept[-1].counts
    assert lines[0]["parent"] == lines[1]["id"]


def test_anchor_maps_a_span_onto_kineto():
    """Kineto's events are in Unix time: a span around one op, mapped
    through the anchor, lies on that op's interval within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    tracer = metrics.Tracer()
    x = torch.randn(1024, 1024)
    (x @ x).sum()
    tracer.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("matmul"):
            x @ x
    tracer.stop()
    (span,) = tracer.spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 1
    start, end = ops[0].start_ns(), ops[0].start_ns() + ops[0].duration_ns()
    assert abs(tracer.unix_ns(span.start_ns) - start) < 1_000_000
    assert abs(tracer.unix_ns(span.end_ns) - end) < 1_000_000


def test_metrics_every_reports_the_counters(monkeypatch):
    lines = []
    monkeypatch.setattr(TRACER, "sink", lines.append)
    monkeypatch.setattr(TRACER, "report_every", None)
    bank, fx, audio = _fixture_bank("dmr")
    n = audio.shape[1] // 2
    monkeypatch.delenv("DIGIHAM_METRICS_EVERY", raising=False)
    bank.push(audio[:, :n])
    assert bank.steps and not lines  # no switch, no report
    TRACER.report()  # the interval starts here
    lines.clear()
    monkeypatch.setenv("DIGIHAM_METRICS_EVERY", "1e-9")  # after import
    steps = bank.steps
    bank.push(audio[:, n:])
    reports = [json.loads(x) for x in lines]
    assert len(reports) == bank.steps - steps >= 3
    for r in reports:
        assert r["report"] == "bank" and r["steps"] == 1
        assert r["channel_samples_per_s"] > 0
        assert set(r) == {"report", "seconds", "channel_samples_per_s",
                          "steps", "rounds", "frames", "sacch_sfs",
                          "graph_captures", "graph_replays",
                          "uploads", "upload_waits", "dstar_headers",
                          "dstar_header_fails", "dstar_slow_headers",
                          "fast_skip_ratio", "decode_fill_ratio"}
    assert sum(r["frames"] for r in reports) > 0
    assert sum(r["uploads"] for r in reports) == 1  # the push's one chunk
    assert sum(r["upload_waits"] for r in reports) == 0
    assert all(0 < r["decode_fill_ratio"] <= 1 for r in reports
               if r["decode_fill_ratio"] is not None)
