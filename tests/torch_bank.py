"""Helpers of the port's streaming-bank tests for YSF, NXDN, D-Star and
POCSAG (tests/test_torch_tracked_bank_{ysf,nxdn,dstar,pocsag}.py): push
chunks, noise seeds screened knife-edge free, a bank run that collects
every channel's voice bytes and event strings, the fixture build from the
JAX bank, the symbol-domain decoder path and the bank's ``push_dibits``
path (with and without device-gated hunting)."""
import os
import sys

import numpy as np

from digiham_tpu_torch import smoke
from torch_parity import audio_knife_edge_free


def chunks(n: int, seed: int, lo=500, hi=30_000) -> np.ndarray:
    """Uneven push chunk sizes summing to ``n``."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(lo, hi)))
    sizes[-1] -= sum(sizes) - n
    return np.asarray([s for s in sizes if s > 0], np.int64)


def screened_seeds(stream, design, fx_like: dict, first_seed: int,
                   mode="gfsk", invert=False) -> np.ndarray:
    """Per variant, the first noise seed whose audio is knife-edge free
    over every symbol of the stream (``design`` None: the audio is
    demodulated as it is, as a 2FSK pipeline without an RRC does)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from soak_classify import rrc_np

    n = int(fx_like["chunks"].sum())
    seeds = []
    for v in range(fx_like["tx_dibits"].shape[0]):
        seed = first_seed + 100 * v
        while True:
            one = {"tx_dibits": fx_like["tx_dibits"][v:v + 1],
                   "idle": fx_like["idle"][v:v + 1],
                   "noise_seeds": np.asarray([seed]),
                   "chunks": fx_like["chunks"]}
            x = smoke.bank_audio(stream, one)[0]
            filtered = x if design is None else rrc_np(x, design)
            if audio_knife_edge_free(filtered, n // stream.sps - 2,
                                     stream.sps, mode, invert):
                break
            seed += 1
        seeds.append(seed)
    return np.asarray(seeds, np.int64)


def run(bank, writer_type, samples, push_chunks, flush=True, tail=None):
    """Push ``samples`` [C, n] in ``push_chunks``, then flush (after
    checking that ``tail`` samples are left to it, when given). Returns
    (voice bytes per channel, event string per channel)."""
    C = samples.shape[0]
    outs = [b""] * C
    events = [[] for _ in range(C)]

    def on_output(c, data):
        outs[c] += data

    bank.on_output = on_output
    for c in range(C):
        writer = writer_type(lambda b, ev=events[c]: ev.append(b.decode()))
        if hasattr(bank, "set_meta_writer"):
            bank.set_meta_writer(c, writer)
        else:
            bank.decoders[c].set_meta_writer(writer)
    lo = 0
    for n in push_chunks:
        bank.push(samples[:, lo:lo + n])
        lo += n
    if tail is not None:
        assert bank.samples.fill == tail, (bank.samples.fill, tail)
    if flush:
        bank.flush()
    return outs, ["".join(ev) for ev in events]


def build_fixture(stream, design, tx_dibits, idle, push_chunks, jax_bank,
                  noise_seeds=None, first_seed=9000, mode="gfsk",
                  invert=False, extra=None) -> dict:
    """TX dibits, idle flags, push chunks, noise seeds and the voice bytes
    and event strings of ``jax_bank(channels)`` over the audio. Without
    seeds, draws per-variant seeds until the stream is knife-edge free.
    The JAX bank must leave ``stream.flush_tail`` samples to its flush.
    ``extra``: more fixture entries, in place while the JAX bank runs
    (``open_function_bits``: see smoke.function_bits)."""
    from digiham_tpu.runtime.meta import PipelineMetaWriter

    fx = {"tx_dibits": tx_dibits, "idle": idle, "chunks": push_chunks,
          **(extra or {})}
    fx["noise_seeds"] = (screened_seeds(stream, design, fx, first_seed,
                                        mode, invert)
                         if noise_seeds is None
                         else np.asarray(noise_seeds, np.int64))
    from digiham_tpu.protocols import pocsag as j_pocsag

    with smoke.function_bits(fx, j_pocsag):
        outs, events = run(jax_bank(tx_dibits.shape[0]), PipelineMetaWriter,
                           smoke.bank_audio(stream, fx), push_chunks,
                           tail=stream.flush_tail)
    for name, parts in (("voice", outs),
                        ("event", [e.encode() for e in events])):
        fx[f"{name}_bytes"] = np.frombuffer(b"".join(parts), np.uint8)
        fx[f"{name}_offsets"] = np.cumsum(
            [0] + [len(p) for p in parts]).astype(np.int64)
    return fx


def reference_path(make_decoder, writer_type, streams):
    """Per channel, a fresh symbol-domain ``make_decoder()`` over the whole
    dibit stream: (voice bytes, event string) per channel."""
    outs, metas = [], []
    for c in range(streams.shape[0]):
        dec = make_decoder()
        events = []
        dec.set_meta_writer(writer_type(
            lambda b, ev=events: ev.append(b.decode())))
        outs.append(dec.process(streams[c]))
        metas.append("".join(events))
    return outs, metas


def push_dibits(bank, writer_type, streams, chunk, sync_dense=None):
    """The bank's symbol-domain entry in ``chunk``-dibit pieces. With
    ``sync_dense`` (dibits [C, n] tensor -> dense sync distances, or the
    dict of a 2FSK step's ``sync_dist_<name>`` outputs), every piece long
    enough for a sync window goes through device-gated hunting as a
    pipeline step would. Returns (voice bytes, event string) per
    channel."""
    import torch

    C = streams.shape[0]
    outs = [b""] * C

    def on_output(c, data):
        outs[c] += data

    bank.on_output = on_output
    metas = [[] for _ in range(C)]
    for c in range(C):
        bank.set_meta_writer(c, writer_type(
            lambda b, ev=metas[c]: ev.append(b.decode())))
    for lo in range(0, streams.shape[1], chunk):
        blk = streams[:, lo:lo + chunk]
        if sync_dense is None:
            bank.push_dibits(blk)
            continue
        hits = np.ones(C, bool)
        if blk.shape[1] > bank.adapter.sync_len:
            dense = sync_dense(torch.from_numpy(blk))
            hits = bank.adapter.block_hits(
                dense if isinstance(dense, dict)
                else {"sync_dist_dense": dense})
        bank._consume_dibits(blk, hits)
    return outs, ["".join(m) for m in metas]
