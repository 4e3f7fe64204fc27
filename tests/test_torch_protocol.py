"""Each protocol's record (``digiham_tpu_torch.pipeline.PROTOCOLS``) against
the JAX package's own facts, and each sync's gate bound against the port's
host hunt.

The record is what the port's pipelines take their defaults from, what the
tracked bank's adapters read (frame geometry, sync outputs, the gate of
the fast skip, the decode), and what the flush, the serving, sharded,
bench and soak paths build from. The JAX package spells the same facts out
in its adapters, ``parallel.streaming._protocol_config``,
``parallel.sharded._gfsk_config`` and its pipelines' defaults.

The fast skip is exact only while the device gate (a distance within the
sync's ``bound`` anywhere in the block) sees every hit the host hunt would
lock on: the second test plants one sync at its bound and one past it and
asks the bank's own hunt.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from digiham_tpu import pipeline as j_pipeline
from digiham_tpu.parallel.sharded import _gfsk_config as j_gfsk_config
from digiham_tpu.parallel.streaming import \
    _protocol_config as j_protocol_config
from digiham_tpu.runtime import tracked_bank as j_tracked_bank
from digiham_tpu_torch.parallel.streaming import DEFAULT_CPS
from digiham_tpu_torch.pipeline import PROTOCOLS
from digiham_tpu_torch.runtime.decoder import Output
from digiham_tpu_torch.runtime.tracked_bank import ADAPTERS

NAMES = ("dmr", "ysf", "nxdn", "dstar", "pocsag")
J_ADAPTERS = {"dmr": "DmrAdapter", "ysf": "YsfAdapter",
              "nxdn": "NxdnAdapter", "dstar": "DstarAdapter",
              "pocsag": "PocsagAdapter"}
J_PIPELINES = {"dmr": "DmrPipeline", "ysf": "YsfPipeline",
               "nxdn": "NxdnPipeline"}


def test_every_protocol_has_one_record_and_adapter():
    assert tuple(PROTOCOLS) == tuple(ADAPTERS) == NAMES
    for name, spec in PROTOCOLS.items():
        assert spec.name == name and ADAPTERS[name].spec is spec


@pytest.mark.parametrize("name", NAMES)
def test_record_holds_the_jax_facts(name):
    """Frame geometry as the JAX adapter's; kind, sps, RRC taps, invert,
    sync outputs (each correlation equal on random symbols), decode and
    the time-sharding default as the JAX streaming config; the bulk
    step's config (4FSK) or the JAX FskPipeline's sps and invert (2FSK);
    and the port pipeline's defaults and outputs."""
    spec = PROTOCOLS[name]
    adapter = ADAPTERS[name]()
    j_adapter = getattr(j_tracked_bank, J_ADAPTERS[name])()
    for attr in ("frame_size", "sync_offset", "sync_len"):
        assert getattr(adapter, attr) == getattr(j_adapter, attr), attr
    assert adapter.lookahead == getattr(j_adapter, "lookahead", 0)
    assert adapter.frame_size == spec.frame_size

    cfg = j_protocol_config(name)
    assert (spec.kind, spec.sps, spec.invert) == (cfg.kind, cfg.sps,
                                                  cfg.invert)
    if cfg.design is None:
        assert spec.design is None
    else:
        assert spec.design.name == cfg.design.name
        assert spec.design.taps == cfg.design.taps
        assert spec.design.gain == cfg.design.gain
    assert spec.step_decodes == (cfg.frame_size is not None)
    if spec.step_decodes:
        assert spec.frame_size == cfg.frame_size
        assert spec.decode.__name__ == cfg.decode_fn.__name__
        assert math.lcm(100, spec.frame_size) // 100 == cfg.cps_quantum
    else:
        assert cfg.cps_quantum == 1
    assert DEFAULT_CPS[name] == cfg.default_cps
    assert [(s.key, s.length) for s in spec.syncs] == [
        (s.name, s.length) for s in cfg.syncs]
    levels = 4 if spec.kind == "gfsk" else 2
    symbols = np.random.default_rng(7).integers(
        0, levels, (2, 300)).astype(np.uint8)
    for s, j_sync in zip(spec.syncs, cfg.syncs):
        got = spec.correlate(torch.from_numpy(symbols),
                             torch.from_numpy(s.pattern))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_sync.fn(symbols)))

    if spec.kind == "gfsk":
        design, sps, frame_size, _, decode = j_gfsk_config(name)
        assert (spec.design.taps, spec.sps, spec.frame_size) == (
            design.taps, sps, frame_size)
        assert spec.decode.__name__ == decode.__name__
        j_default = inspect.signature(getattr(
            j_pipeline, J_PIPELINES[name])).parameters["sps"].default
    else:
        j_fsk = j_pipeline.FskPipeline(2, name)
        assert (spec.sps, spec.invert) == (j_fsk.sps, j_fsk.invert)
        j_default = j_fsk.sps
    pipe = spec.pipeline(2, n_centuries=1, device="cpu")
    assert pipe.spec is spec and pipe.sps == spec.sps == j_default
    assert pipe.rrc_design is spec.design
    assert isinstance(pipe.tables(), spec.tables)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 500, (2, 100 * pipe.sps + 3)).astype(np.float32))
    out, _ = pipe.step_symbols(x, pipe.init_state())
    assert set(out) == {"dibits"} | {s.key for s in spec.syncs}


def _hunt_hits(name, stream) -> bool:
    """Does the bank's own hunt for ``name`` lock on ``stream`` (or, for
    D-Star's header sync, begin its header decode)?"""
    adapter = ADAPTERS[name]()
    hunt = adapter.make_hunt(adapter.make_meta())
    out, buf = Output(), stream
    while len(buf) > hunt.required_data():
        nxt, consumed = hunt.process(buf, out)
        if nxt is not None or not getattr(hunt, "hunting", True):
            return True
        if consumed == 0:
            return False
        buf = buf[consumed:]
    return False


def _distances(windows, pattern) -> np.ndarray:
    """Bit distances of every window to the pattern."""
    x = windows ^ pattern
    return ((x & 1) + (x >> 1)).sum(-1)


def _planted(spec, sync, errors, levels, seed):
    """A random stream of 300 symbols with ``sync``'s first pattern at
    its place in a frame and ``errors`` of its bits flipped; the first
    seed from ``seed`` on whose filler has no other window within any
    sync's bound + 1 of any pattern."""
    pattern = np.atleast_2d(sync.pattern)[0]
    start = 40 + spec.sync_offset
    while True:
        rng = np.random.default_rng(seed)
        stream = rng.integers(0, levels, 300).astype(np.uint8)
        stream[start:start + sync.length] = pattern
        for i in range(errors):  # flip one bit of each of the first symbols
            stream[start + i] ^= 1
        clean = True
        for s in spec.syncs:
            windows = np.lib.stride_tricks.sliding_window_view(stream,
                                                               s.length)
            for p in np.atleast_2d(s.pattern):
                d = _distances(windows, p)
                d[start] = 99 if s is sync else d[start]
                clean &= not (d <= s.bound + 1).any()
        if clean:
            return stream
        seed += 1


@pytest.mark.parametrize("name", NAMES)
def test_gate_bound_is_the_hunts(name):
    """Each sync's gate bound is the constant the port's hunt reads, and
    the hunt locks on a sync exactly as the gate sees it: within the
    bound it locks, one bit past it it does not."""
    from digiham_tpu_torch.protocols import pocsag
    from digiham_tpu_torch.protocols.dmr import constants as dmr
    from digiham_tpu_torch.protocols.dstar import phases as dstar
    from digiham_tpu_torch.protocols.nxdn import constants as nxdn
    from digiham_tpu_torch.protocols.ysf import constants as ysf

    constants = {"dmr": (dmr.SYNC_BOUND,), "ysf": (ysf.SYNC_BOUND,),
                 "nxdn": (nxdn.SYNC_BOUND,),
                 "dstar": (dstar.HEADER_SYNC_BOUND, dstar.VOICE_SYNC_BOUND),
                 "pocsag": (pocsag.SYNC_BOUND,)}
    spec = PROTOCOLS[name]
    assert tuple(s.bound for s in spec.syncs) == constants[name]
    levels = 4 if spec.kind == "gfsk" else 2
    for sync in spec.syncs:
        at = _planted(spec, sync, sync.bound, levels, 11)
        past = _planted(spec, sync, sync.bound + 1, levels, 11)
        assert _hunt_hits(name, at), (sync.key, "within the bound")
        assert not _hunt_hits(name, past), (sync.key, "past the bound")
