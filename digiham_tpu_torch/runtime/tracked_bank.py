"""TrackedChannelBank: the acquisition/tracking split at scale (port of
``digiham_tpu/runtime/tracked_bank.py``).

The plain ChannelBank runs full symbol-domain phase machines per channel.
This bank moves the steady state onto the device: a host sync phase hunts
for frame lock per channel (vectorized numpy scan); once locked, the bank
extracts frame-aligned dibit windows for ALL locked channels, decodes
every frame's fields in ONE batched device call, and feeds a lightweight
fields-consuming frame machine per channel — no host FEC in the common
path.

Protocol specifics live in the adapter (``ADAPTERS`` by protocol name):
the protocol's record (``pipeline.Protocol``: frame geometry, the symbols
past a frame's end its fields read as ``lookahead``, the sync outputs and
their gate bounds, the batched decode), which the base :class:`Adapter`
reads, and the host hooks of :class:`DmrAdapter`, :class:`YsfAdapter` and
:class:`NxdnAdapter` over the three 4FSK pipelines, :class:`DstarAdapter`
and :class:`PocsagAdapter` over ``FskPipeline`` (bits for dibits). An
adapter whose tracker reads the frame's raw dibits besides its fields
(YSF's rare frame types) says so with ``tracker_takes_raw``; a hunt that
is partway through a multi-stage acquisition (a pending D-Star header
decode) says so by a false ``hunting``, and the device-gated fast skip
then keeps its exact stream position.
Output contract: byte- and event-identical to running the per-channel
symbol-domain Decoder, and to the JAX package's bank
(tests/test_torch_tracked_bank{,_ysf,_nxdn,_dstar,_pocsag}.py on
structured, corrupted and noise streams).

The pending samples live on the bank's devices
(``stream.DeviceSampleStore``; each shard of a mesh bank holds its rows on
its own device): every ``push`` copies its chunk once into pinned staging
and uploads it asynchronously on the current stream, a step's block is a
view of the store, and the RRC history of the rebase is copied on the
device. The cold paths (``snapshot``, ``flush``) fetch the pending tail
once, to host numpy. The time-sharded bank keeps the host ``SampleBuffer``
that ``TimeShardedPipeline.drive`` reads. Host <-> device traffic of one
``push`` step, each fetch a synchronisation: ``state.demod.pos`` comes
down before and after the step (and once more when ``push`` finds too few
samples left), the ``[C]`` block-hit flags and the dibits once each; every
decode round sends its frame batch up and fetches its dict of fields. On
the card a batch shape's second and later rounds replay a captured CUDA
graph of the decode and fetch every field in one packed copy
(``runtime/decode_graph.py``); a shape's first round, and every round off
the card, runs the decode eagerly and makes one blocking copy per field of
``dmr_decode_frames`` (16), ``ysf_decode_frames`` (6),
``nxdn_decode_frames`` (12), ``dstar_decode_frames`` (5) or
``pocsag_decode_frames`` (3). A 2FSK step fetches its ``[C]`` block-hit
flags the same way, reduced on the card from the dense distances of every
sync pattern. Every such copy goes through :func:`_host`, which counts it
in the tracer's ``fetches``, as the packed copy counts too.

Spans (``runtime/metrics.py``; recorded only while the tracer is on):
``bank.push`` holds ``bank.buffer`` (the sample store's bookkeeping and
the rebase; in it ``bank.upload``, the chunk's copy into pinned staging
and the call that queues its upload), the ``bank.fetch`` of the read
positions and each ``bank.step``; a step holds ``bank.launch``
(``step_symbols``), its ``bank.fetch`` copies, and the passes of the hunt
(``bank.hunt``; in it ``bank.hunt.header``, a D-Star hunt's 660-bit
header decode) and the decode rounds (``bank.round``: ``bank.round.pack``
builds the frame batch, ``bank.decode`` is the adapter's ``decode_fields``
with its field fetches, ``bank.track`` feeds the trackers, ``on_output``
and the metadata writers). ``flush`` is one ``bank.flush``, which carries
its counts as a step's span does.

The lines the hunts and trackers say on standard error (``runtime/diag.py``:
NXDN's ``FACCH1 message type``, D-Star's unknown slow data and simple data
lines) are held for the step and written in one call at its end, in the
order they came.
"""
from __future__ import annotations

import copy
import pickle

import numpy as np
import torch

from ..dsp.rrc import RrcState, rrc_filter_block
from ..parallel.sharded import row_bounds, tree_cat, tree_map
from ..pipeline import DMR, DSTAR, NXDN, POCSAG, YSF, Protocol
from . import decode_graph, diag
from .channel_bank import bank_device
from .checkpoint import load_state, save_state
from .decoder import Output
from .metrics import TRACER
from .stream import DeviceSampleStore, SampleBuffer, rrc_rebase_history


def _host(t: torch.Tensor) -> np.ndarray:
    """One blocking device-to-host copy, counted; a ``bank.fetch`` span
    while the tracer is on."""
    T = TRACER
    T.counts.fetches += 1
    if not T.on:
        return t.cpu().numpy()
    with T.span("bank.fetch"):
        return t.cpu().numpy()


def _fetch(fields: dict) -> dict:
    """A decode dict on the host: one blocking copy per field."""
    return {k: _host(v) for k, v in fields.items()}


def _decode_frames(fn, frames: np.ndarray, pipeline) -> dict:
    """``fn`` (a ``*_decode_frames``) on the round's [N, frame] numpy
    frames with the pipeline's tables, on its device; the fields as numpy.
    A repeated batch shape on the card replays a captured graph with one
    packed fetch; otherwise the decode runs eagerly, one fetch a field."""
    host = decode_graph.replayed(fn, frames, pipeline)
    if host is None:
        host = _fetch(fn(torch.from_numpy(frames).to(pipeline.device),
                         pipeline.tables()))
    return host


class Adapter:
    """What the bank reads of one protocol: its record ``spec`` (frame
    geometry, sync outputs and their gate bounds, the batched decode) and
    the host side the subclasses give (``make_hunt``, ``make_meta``,
    ``make_tracker``, ``field_row``). A tracker that reads the frame's raw
    symbols besides its fields says so with ``tracker_takes_raw``."""

    spec: Protocol
    tracker_takes_raw = False

    @property
    def frame_size(self) -> int:
        return self.spec.frame_size

    @property
    def lookahead(self) -> int:
        """Symbols past a frame's end that its fields read (D-Star: 24)."""
        return self.spec.lookahead

    @property
    def sync_offset(self) -> int:
        """The sync window begins ``sync_offset`` symbols into a frame and
        spans ``sync_len`` (device-gated hunting)."""
        return self.spec.sync_offset

    @property
    def sync_len(self) -> int:
        return self.spec.sync_len

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: does the step's dense correlation see a sync within
        its gate bound (the hunt's) anywhere in the block, over any of the
        protocol's syncs and patterns? Reduced on the card: only the [C]
        flags cross to the host, in one fetch."""
        hits = None
        for s in self.spec.syncs:
            hit = (outputs[s.key] <= s.bound).flatten(1).any(1)
            hits = hit if hits is None else hits | hit
        return _host(hits)

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        """One batched device decode of [N, frame_size + lookahead] frames
        with the pipeline's tables; every field moves to the host once, as
        numpy."""
        return _decode_frames(self.spec.decode, frames, pipeline)


class DmrAdapter(Adapter):
    spec = DMR

    def make_hunt(self, meta=None):
        from ..protocols.dmr.phases import SyncPhase
        return SyncPhase()

    def make_meta(self):
        from ..protocols.dmr.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.dmr.fields_phase import FieldsFramePhase
        t = FieldsFramePhase(meta)
        t.set_slot_filter(slot_filter)
        return t

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        host = super().decode_fields(frames, pipeline)
        # batch the per-row packbits (cheaper than packing in field_row)
        host["lc_packed"] = np.packbits(
            host["bptc_data"].astype(np.uint8), axis=-1)
        return host

    def field_row(self, host: dict, row: int):
        from ..protocols.dmr.fields_phase import FrameFields
        return FrameFields(
            tact_ok=bool(host["tact_ok"][row]),
            tact_slot=int(host["tact_slot"][row]),
            sync_type=int(host["sync_type"][row]),
            emb_ok=bool(host["emb_ok"][row]),
            emb_lcss=int(host["emb_lcss"][row]),
            emb_fragment=host["emb_fragment"][row].tobytes(),
            voice_payload=host["voice_payload"][row].tobytes(),
            slot_type_ok=bool(host["slot_type_ok"][row]),
            data_type=int(host["data_type"][row]),
            bptc_ok=bool(host["bptc_ok"][row]),
            lc_bytes=host["lc_packed"][row].tobytes(),
        )


class YsfAdapter(Adapter):
    """FICH and DCH decode in one launch of K5 on the card."""

    spec = YSF
    # the rare frame types (V/D1, VW, header) decode from the raw dibits
    tracker_takes_raw = True

    def make_hunt(self, meta=None):
        from ..protocols.ysf.phases import SyncPhase
        return SyncPhase()

    def make_meta(self):
        from ..protocols.ysf.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.ysf.fields_phase import YsfFieldsFramePhase
        return YsfFieldsFramePhase(meta)

    def field_row(self, host: dict, row: int):
        from ..protocols.ysf.fields_phase import YsfFrameFields
        return YsfFrameFields(
            sync_dist=int(host["sync_dist"][row]),
            fich_ok=bool(host["fich_ok"][row]),
            # int64 holding the unsigned 32-bit word, read from numpy
            fich_data=int(host["fich_data"][row]),
            vd2_voice=[host["vd2_voice"][row, i].tobytes()
                       for i in range(5)],
            vd2_dch_ok=bool(host["vd2_dch_ok"][row]),
            vd2_dch=host["vd2_dch"][row].tobytes(),
        )


class NxdnAdapter(Adapter):
    """SACCH and both FACCH1 slots decode in one launch of K5 on the
    card."""

    spec = NXDN

    def make_hunt(self, meta=None):
        from ..protocols.nxdn.phases import SyncPhase
        return SyncPhase()

    def make_meta(self):
        from ..protocols.nxdn.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.nxdn.fields_phase import NxdnFieldsFramePhase
        return NxdnFieldsFramePhase(meta)

    def field_row(self, host: dict, row: int):
        from ..protocols.nxdn.fields_phase import NxdnFrameFields
        return NxdnFrameFields(
            sync_dist=int(host["sync_dist"][row]),
            lich_ok=bool(host["lich_ok"][row]),
            lich_byte=int(host["lich_byte"][row]),
            sacch_structure=int(host["sacch_structure"][row]),
            sacch_bits=host["sacch_bits"][row].astype(np.int64),
            sacch_ok=bool(host["sacch_ok"][row]),
            voice=[host["voice0"][row].tobytes(),
                   host["voice1"][row].tobytes()],
            facch_mtype=[int(host["facch_mtype0"][row]),
                         int(host["facch_mtype1"][row])],
            facch_ok=[bool(host["facch_ok0"][row]),
                      bool(host["facch_ok1"][row])],
        )


class DstarAdapter(Adapter):
    """Bit-domain tracked adapter over ``FskPipeline(protocol="dstar")``.

    Frames are 96 bits (72 voice + 24 slow data) with a 24-bit lookahead
    so the device can score the full-length terminator
    (dstar_phase.cpp:94-101). The hunt handles sync AND the rare 660-bit
    header decode (see DstarHuntPhase); the steady state is batched
    tensor math + O(frames) host bookkeeping.
    """

    spec = DSTAR

    def make_hunt(self, meta=None):
        from ..protocols.dstar.fields_phase import DstarHuntPhase
        return DstarHuntPhase(meta)

    def make_meta(self):
        from ..protocols.dstar.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.dstar.fields_phase import DstarFieldsFramePhase
        return DstarFieldsFramePhase(meta, locked)

    def field_row(self, host: dict, row: int):
        from ..protocols.dstar.fields_phase import DstarFrameFields
        return DstarFrameFields(
            voice_bytes=host["voice"][row].tobytes(),
            data_bytes=host["data"][row].tobytes(),
            term_full=int(host["term_full"][row]),
            term_half=int(host["term_half"][row]),
            vsync_dist=int(host["vsync_dist"][row]),
        )


class PocsagAdapter(Adapter):
    """Bit-domain tracked adapter over ``FskPipeline(protocol="pocsag")``.

    Every 32-bit window is decoded both ways at once (BCH codeword + sync
    word distance); the host frame machine (PocsagFieldsFramePhase) picks
    per its position in the 16-codeword batch. This removes the
    per-codeword host BCH of the symbol path. No metadata stream
    (pocsag_decoder.cpp).
    """

    spec = POCSAG

    def make_hunt(self, meta=None):
        from ..protocols.pocsag import SyncPhase
        return SyncPhase()

    def make_meta(self):
        return None

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.pocsag import PocsagFieldsFramePhase
        return PocsagFieldsFramePhase()

    def field_row(self, host: dict, row: int):
        from ..protocols.pocsag import PocsagFrameFields
        return PocsagFrameFields(
            # int64 holding the unsigned 32-bit word, read from numpy
            word=int(host["word"][row]),
            ok=bool(host["ok"][row]),
            sync_dist=int(host["sync_dist"][row]),
        )


# protocol name -> its adapter
ADAPTERS = {a.spec.name: a for a in (DmrAdapter, YsfAdapter, NxdnAdapter,
                                     DstarAdapter, PocsagAdapter)}


def _hunting(hunt) -> bool:
    """False while a multi-stage hunt is partway (a pending D-Star header
    decode): the fast skip must then keep the exact stream position."""
    return getattr(hunt, "hunting", True)


class _Channel:
    __slots__ = ("buffer", "hunt", "tracker", "meta", "out")

    def __init__(self, adapter):
        self.buffer = np.zeros(0, np.uint8)
        self.meta = adapter.make_meta()
        self.hunt = adapter.make_hunt(self.meta)
        self.tracker = None
        self.out = Output()


class _Shard:
    """One channel shard of the bank: its pipeline, its rows and its device
    carry. An unsharded bank is one shard over every row, stepping the
    bank's own pipeline; a mesh bank's shards step copies of it."""

    __slots__ = ("pipeline", "lo", "hi", "state")

    def __init__(self, pipeline, lo: int, hi: int):
        self.pipeline, self.lo, self.hi = pipeline, lo, hi
        self.state = pipeline.init_state()


def _channel_shards(pipeline, mesh) -> list:
    """The bank's shards: the pipeline over every row without a mesh; per
    channel shard of ``mesh``, a copy of ``pipeline`` with the same tables,
    sized to the shard's rows and moved to the device of its first time
    slot (the time axis is replicated, as in the JAX mesh bank)."""
    if mesh is None:
        return [_Shard(pipeline, 0, pipeline.channels)]
    if not mesh.single_process:
        raise ValueError("a mesh bank needs every slot in this process")
    shards = []
    for i, (lo, hi) in enumerate(row_bounds(mesh, pipeline.channels)):
        pipe = copy.deepcopy(pipeline).to(mesh.device((i, 0)))
        pipe.channels = hi - lo
        shards.append(_Shard(pipe, lo, hi))
    return shards


class TrackedChannelBank:
    """Device pipeline -> batched field decode -> host trackers.

    pipeline: one of the bank pipelines (``DmrPipeline``,
        ``YsfPipeline``, ``NxdnPipeline``, ``FskPipeline``); the bank steps
        it through ``step_symbols`` (dibits or bits and dense sync
        distances) and decodes its own frames.
    adapter: the pipeline's protocol adapter (default DMR).
    device: ``None`` is the card; the pipeline must live there.
    mesh: optional ``parallel.Mesh`` — channel data parallelism over the
        mesh's channel axis: each channel shard's rows step and decode on
        the device of its slot, through a copy of ``pipeline`` sized to
        them, with the host trackers unchanged. Channel sharding is pure
        DP over independent per-channel math, so outputs are identical to
        the unsharded bank's. The channels must divide by the shards. A
        mesh may name one device several times.
    """

    def __init__(self, pipeline, on_output=None, slot_filter: int = 3,
                 adapter=None, device=None, mesh=None):
        self.device = bank_device(pipeline, device)
        self.adapter = adapter or DmrAdapter()
        self.pipeline = pipeline
        self.channels = pipeline.channels
        self.mesh = mesh
        self._shards = _channel_shards(pipeline, mesh)
        self.samples = self._new_store()
        self.on_output = on_output
        self.slot_filter = slot_filter
        self.chans = [_Channel(self.adapter) for _ in range(self.channels)]
        sps = pipeline.sps
        self._need = pipeline.n_centuries * (100 * sps + 1) + 2
        self._frame_size = self.adapter.frame_size
        self._lookahead = self.adapter.lookahead
        self.steps = 0  # device steps pushed
        self._max_frames = (pipeline.symbols_per_block
                            // self._frame_size + 2)
        self._batch = self.channels * self._max_frames

    def set_meta_writer(self, channel: int, writer) -> None:
        if self.chans[channel].meta is not None:
            self.chans[channel].meta.set_writer(writer)

    # ------------------------------------------------------------------
    def snapshot(self) -> bytes:
        """Serialize the full bank state — device carries (demod/RRC, as
        numpy), pending samples, and every channel's host state (dibit
        buffer, hunt, tracker, metadata) — for bit-exact resume via
        ``restore``. Meta writers (user callbacks) are NOT serialized;
        re-attach them after restoring."""
        writers = [ch.meta.writer if ch.meta is not None else None
                   for ch in self.chans]
        for ch in self.chans:
            if ch.meta is not None:
                ch.meta.writer = None
        try:
            chans_blob = pickle.dumps(self.chans)
        finally:
            for ch, w in zip(self.chans, writers):
                if ch.meta is not None:
                    ch.meta.writer = w
        return pickle.dumps({
            "pipeline_state": save_state(self.state),
            "chans": chans_blob,
            "samples": self._pending(),
        })

    def restore(self, blob: bytes) -> None:
        """Inverse of ``snapshot`` on a bank built with the same pipeline
        configuration, on this bank's device whichever device wrote the
        blob. Writers already attached to this bank's channels are carried
        over to the restored metadata collectors."""
        payload = pickle.loads(blob)
        self._resume(load_state(payload["pipeline_state"], "cpu"),
                     payload["samples"])
        prev = self.chans
        self.chans = pickle.loads(payload["chans"])
        for new, old in zip(self.chans, prev):
            if new.meta is not None and old.meta is not None:
                new.meta.writer = old.meta.writer

    def restore_jax(self, blob: bytes) -> None:
        """Take a JAX bank's ``snapshot()`` (its ``TrackedChannelBank``,
        ``TimeShardedTrackedBank`` or one shard of its ``MultiStreamBank``):
        the pipeline state through ``convert.from_jax_snapshot`` and the
        pending samples. The JAX host machines are pickled by class path and
        do not cross packages: this bank's own stay and re-acquire sync."""
        from ..convert import from_jax_snapshot

        state, samples = from_jax_snapshot(blob, "cpu")
        self._resume(self._jax_state(state), samples)

    def _resume(self, state, samples: np.ndarray) -> None:
        """Carry on from a state (any device) and the pending samples."""
        if samples.shape[0] != self.channels:
            raise ValueError(f"checkpoint has {samples.shape[0]} channels, "
                             f"bank has {self.channels}")
        self.state = state
        self.samples = self._new_store()
        if samples.shape[1]:
            self.samples.push(samples)
        # a restored stream is conservatively mid-stream: the zero-pad
        # branch of rrc_rebase_history must never fire on it (the real
        # left context lives in the restored RRC state, not this buffer)
        self.samples.consumed = 1

    def _new_store(self):
        """The sample store: each shard's rows on its device."""
        return DeviceSampleStore(self.channels, [
            (sh.lo, sh.hi, sh.pipeline.device) for sh in self._shards])

    def _pending(self) -> np.ndarray:
        """The pending samples [C, fill], a new host array."""
        return self.samples.tail()

    def _jax_state(self, state):
        """The part of a converted JAX state this bank carries: all of it,
        with an RRC history exactly when the pipeline filters."""
        if (state.rrc is None) != (getattr(self.pipeline, "rrc_design",
                                           None) is None):
            raise ValueError("the JAX snapshot's RRC state does not match "
                             "this bank's pipeline")
        return state

    @property
    def state(self):
        """Every channel's device carry as one state (a mesh bank's shards
        joined on the first shard's device)."""
        dev = self._shards[0].pipeline.device
        return tree_cat([tree_map(lambda t: t.to(dev), sh.state)
                         for sh in self._shards])

    @state.setter
    def state(self, state) -> None:
        """Place a whole-bank state (on any device) on the shards' devices,
        each shard's rows on its own."""
        for sh in self._shards:
            sh.state = tree_map(
                lambda t, sh=sh: t[sh.lo:sh.hi].to(sh.pipeline.device), state)

    # ------------------------------------------------------------------
    def _positions(self) -> np.ndarray:
        return np.concatenate([_host(sh.state.demod.pos)
                               for sh in self._shards])

    def _step(self, blocks: list):
        """One device step of the block (each shard's rows, a view of the
        store on its device): (block-hit flags, symbols) as numpy, every
        channel's."""
        hits, symbols = [], []
        for sh, x in zip(self._shards, blocks):
            with TRACER.span("bank.launch"):
                out, sh.state = sh.pipeline.step_symbols(x, sh.state)
            hits.append(self.adapter.block_hits(out))
            symbols.append(_host(out["dibits"]))
        return np.concatenate(hits), np.concatenate(symbols)

    def _rebase(self, blocks: list, base: int) -> None:
        """Move every carry's origin ``base`` samples on, rebuilding the
        RRC history from the block on each shard's device."""
        start = self.samples.consumed == 0
        for sh, block in zip(self._shards, blocks):
            rrc = rrc_rebase_history(sh.pipeline, sh.state, block, base,
                                     stream_start=start)
            if rrc is not None:
                sh.state.rrc = rrc
            # stays int32 on the device
            sh.state.demod.pos = sh.state.demod.pos - base

    # ------------------------------------------------------------------
    def push(self, samples: np.ndarray) -> None:
        if self.samples is None:
            raise RuntimeError("bank was flushed; create a new bank")
        T = TRACER
        with T.span("bank.push"):
            with T.span("bank.buffer"):
                self.samples.push(samples)
            while True:
                need = int(self._positions().max()) + self._need
                if self.samples.fill < need:
                    return
                with T.span("bank.buffer"):
                    blocks = self.samples.view(need)
                with T.span("bank.step", step=True):
                    hits, symbols = self._step(blocks)
                    self._consume_dibits(symbols, hits)
                    self.steps += 1
                    T.stepped(self.channels * self.pipeline.n_centuries
                              * 100 * self.pipeline.sps)
                base = int(self._positions().min())
                if base > 0:
                    with T.span("bank.buffer"):
                        self._rebase(blocks, base)
                        self.samples.consume(base)

    def push_dibits(self, dibits: np.ndarray) -> None:
        """Symbol-domain entry (bypasses the sample pipeline)."""
        self._consume_dibits(np.asarray(dibits, np.uint8))

    def flush(self) -> None:
        """End-of-stream: decode the buffered sample tail exactly as the
        reference would at EOF.

        The device pipeline consumes fixed-size blocks, so up to
        ~n_centuries*100 symbols of a finite recording stay buffered
        (a live stream never notices). This filters the remainder with
        the standalone RRC (kernel K4 on the card; a 2FSK pipeline without
        an RRC design has nothing to filter) and demodulates it
        with the reference-exact per-symbol host oracle
        (fsk_demodulator.cpp:25-111), seeded from the device carry —
        legal because the carry is century-aligned, where the
        reference's variance ring is empty and its volume ring equals
        ours — and feeds the symbols through the normal tracking path.
        Terminal: the bank accepts no further samples afterwards.
        """
        with TRACER.span("bank.flush", step=True):
            tail = self._pending()
            symbols = [sym for sh in self._shards
                       for sym in _flush_demod(sh.pipeline, sh.state.rrc,
                                               sh.state.demod,
                                               tail[sh.lo:sh.hi])]
            self._consume_dibits(symbols)
        self.samples = None  # further push() fails loudly

    # ------------------------------------------------------------------
    def _consume_dibits(self, dibits, block_hits=None) -> None:
        # the step's diagnostic lines go out in one write at its end
        with diag.batch():
            self._consume(dibits, block_hits)

    def _consume(self, dibits, block_hits) -> None:
        T = TRACER
        with T.span("bank.hunt"):
            hunting = skips = 0
            for c, ch in enumerate(self.chans):
                old_len = len(ch.buffer)
                ch.buffer = np.concatenate([ch.buffer, dibits[c]])
                if (block_hits is not None and ch.tracker is None
                        and _hunting(ch.hunt)):
                    hunting += 1
                    if not block_hits[c]:
                        skips += 1
                        self._fast_skip(ch, old_len)
            T.counts.hunting += hunting
            T.counts.fast_skips += skips
            for ch in self.chans:
                self._hunt(ch)
        # alternate batched frame decoding and hunting until quiescent
        while self._decode_round():
            with T.span("bank.hunt"):
                for ch in self.chans:
                    self._hunt(ch)

    def _fast_skip(self, ch: _Channel, old_len: int) -> None:
        """Device-gated hunting: the dense sync correlation saw no hit
        anywhere inside the appended block, so the only unscanned
        candidate offsets are those whose pattern window starts in the
        old carry region (it straddles the block boundary). Scan just
        those, then drop everything but the lookahead tail — identical
        outcome to a full numpy hunt at a fraction of the cost, which
        makes idle channels nearly free at large bank sizes."""
        so = self.adapter.sync_offset
        req = ch.hunt.required_data()
        # buffer offsets whose pattern window starts before the new block
        boundary = max(0, old_len - so)
        scanned = 0
        while (ch.tracker is None and scanned < boundary
               and len(ch.buffer) - scanned > req and _hunting(ch.hunt)):
            nxt, consumed = ch.hunt.process(
                ch.buffer[scanned:boundary + req], ch.out)
            scanned += consumed
            if nxt is not None:
                ch.tracker = self.adapter.make_tracker(
                    ch.meta, self.slot_filter, nxt)
                TRACER.counts.locks += 1
                break
            if consumed == 0:
                break
            req = ch.hunt.required_data()
        if ch.tracker is None and _hunting(ch.hunt):
            drop = max(scanned, len(ch.buffer) - req)
            ch.buffer = ch.buffer[drop:]
        else:
            # locked, or a multi-stage hunt (a pending D-Star header
            # decode): keep the exact stream position
            ch.buffer = ch.buffer[scanned:]

    def _decode_round(self) -> int:
        T = TRACER
        with T.span("bank.round"):
            with T.span("bank.round.pack"):
                frames, owners = self._pack()
            if not owners:
                return 0
            host = self._decode(frames, owners)
            with T.span("bank.track"):
                fed, voiced, losses = self._track(host, owners)
            counts = T.counts
            counts.rounds += 1
            counts.frames += len(owners)
            counts.voice_frames += voiced
            counts.losses += losses
            return fed

    def _pack(self):
        """The round's frame batch and its (channel, frame) owners."""
        FS = self._frame_size
        LA = self._lookahead  # symbols past the frame its fields read
        # padded to a fixed batch: the zero rows' fields are never read,
        # and the decode's launch count does not depend on how many
        # channels are locked
        frames = np.zeros((self._batch, FS + LA), np.uint8)
        owners: list[tuple[int, int]] = []
        idx = 0
        for c, ch in enumerate(self.chans):
            if ch.tracker is None:
                continue
            n = 0
            while (len(ch.buffer) - n * FS > FS + LA
                   and idx + 1 <= self._batch):
                frames[idx] = ch.buffer[n * FS:(n + 1) * FS + LA]
                owners.append((c, n))
                idx += 1
                n += 1
        return frames, owners

    def _track(self, host: dict, owners: list):
        """Feed the round's fields to the trackers, in stream order a
        channel. Returns (rows fed, voice frames handed over, trackers
        lost)."""
        FS = self._frame_size
        fed = voiced = losses = 0
        takes_raw = self.adapter.tracker_takes_raw
        per_chan: dict[int, list[tuple[int, int]]] = {}
        for row, (c, n) in enumerate(owners):
            per_chan.setdefault(c, []).append((row, n))
        for c, rows in per_chan.items():
            ch = self.chans[c]
            consumed_frames = 0
            for row, n in rows:
                f = self.adapter.field_row(host, row)
                voice, lost, keep_from = (
                    ch.tracker.process_fields(
                        f, ch.buffer[n * FS:(n + 1) * FS])
                    if takes_raw else ch.tracker.process_fields(f))
                if voice and self.on_output is not None:
                    self.on_output(c, voice)
                    voiced += 1
                fed += 1
                if lost:
                    # re-hunt keep_from dibits into the failing frame
                    # (NXDN's TX_RELEASE exits mid-frame; a full D-Star
                    # terminator eats the lookahead too)
                    ch.tracker = None
                    ch.hunt = self.adapter.make_hunt(ch.meta)
                    ch.buffer = ch.buffer[
                        consumed_frames * FS + keep_from:]
                    losses += 1
                    break
                consumed_frames += 1
            else:
                ch.buffer = ch.buffer[consumed_frames * FS:]
        return fed, voiced, losses

    def _decode(self, frames: np.ndarray, owners: list) -> dict:
        """The round's frames -> host field dict: one batched decode per
        shard that owns frames, on its device, padded to the shard's share
        of the batch (or to its frames, when one shard holds more of the
        round); an unsharded bank's share is the whole batch."""
        parts, row = [], 0
        share = self._batch // len(self._shards)
        for sh in self._shards:
            n = sum(sh.lo <= c < sh.hi for c, _ in owners)
            if n:
                padded = np.zeros((max(share, n),) + frames.shape[1:],
                                  frames.dtype)
                padded[:n] = frames[row:row + n]
                with TRACER.span("bank.decode"):
                    host = self.adapter.decode_fields(padded, sh.pipeline)
                TRACER.counts.rows_sent += len(padded)
                parts.append({k: v[:n] for k, v in host.items()})
            row += n
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _hunt(self, ch: _Channel) -> None:
        while ch.tracker is None \
                and len(ch.buffer) > ch.hunt.required_data():
            nxt, consumed = ch.hunt.process(ch.buffer, ch.out)
            ch.buffer = ch.buffer[consumed:]
            if nxt is not None:
                ch.tracker = self.adapter.make_tracker(
                    ch.meta, self.slot_filter, nxt)
                TRACER.counts.locks += 1
                return
            if consumed == 0:
                return


class TimeShardedTrackedBank(TrackedChannelBank):
    """The tracker bank over a (channel, time)-sharded STREAMING pipeline
    (``parallel/streaming.py::TimeShardedPipeline``).

    The device step runs the exact carry ring across time shards; the host
    side (hunt gating, trackers, metadata) is the parent class unchanged,
    so outputs and events are byte-identical to the unsharded
    TrackedChannelBank on the same sample stream. Differences from the
    parent are purely the consumption contract:

    - fixed stride: each step consumes exactly ``block_len`` samples per
      channel (plus the common-mode drift the driver folds back); the ±1 a
      century timing drift accumulates in the carried ``pos`` (asserted
      under ``drift_budget``) instead of the block size;
    - the buffer retains ``h_left`` raw left-edge samples (primed with
      zeros at stream start: the reference delay lines start zeroed) and
      waits for ``h_right`` lookahead before stepping.

    The state is the demod carry alone (a ``DemodState``): the RRC history
    is the left edge of the buffer.
    """

    def __init__(self, sharded_pipeline, on_output=None,
                 slot_filter: int = 3, adapter=None, device=None):
        super().__init__(sharded_pipeline, on_output=on_output,
                         slot_filter=slot_filter, adapter=adapter,
                         device=device)
        self.samples.push(np.zeros(
            (self.channels, sharded_pipeline.h_left), np.float32))

    def push(self, samples: np.ndarray) -> None:
        p = self.pipeline
        if self.samples is None:
            raise RuntimeError("bank was flushed; create a new bank")
        T = TRACER

        def step_fn(body, edges, state):
            with T.span("bank.step", step=True):
                with T.span("bank.launch"):
                    out, state = p.step(body, edges, state)
                self._consume_dibits(_host(out["dibits"]),
                                     self.adapter.block_hits(out))
                self.steps += 1
                T.stepped(self.channels * p.block_len)
            return out, state

        with T.span("bank.push"):
            with T.span("bank.buffer"):
                self.samples.push(np.asarray(samples, np.float32))
            _, self.state = p.drive(self.samples, self.state, step_fn)

    def _new_store(self):
        """The host store ``TimeShardedPipeline.drive`` reads its halos
        from."""
        return SampleBuffer(self.channels)

    def _pending(self) -> np.ndarray:
        return self.samples.data[:, :self.samples.fill].copy()

    def _jax_state(self, state):
        """A JAX time-sharded bank's state is its demod carry alone (3
        leaves, whatever the protocol)."""
        if state.rrc is not None:
            raise ValueError("a time-sharded bank's snapshot holds the "
                             "demod carry alone, not an RRC history")
        return state.demod

    def flush(self) -> None:
        """EOF parity with the parent: the buffered tail through the host
        oracle.

        The carried ``pos`` is relative to the retained body origin
        (``h_left`` into the buffer) and may be slightly negative (drift),
        so the oracle stream starts ``drift_budget`` raw samples earlier —
        exactly the headroom ``h_left`` reserves — and the RRC history
        (K4 on the card) comes from the ``ntaps-1`` raw samples before that
        point (index 0 of the buffer, by construction ``h_left = ntaps-1 +
        drift_budget``)."""
        p = self.pipeline
        with TRACER.span("bank.flush", step=True):
            tail = self.samples.data[:, :self.samples.fill]
            history = (RrcState(torch.from_numpy(tail[:, :p.nt1]).to(
                p.device)) if p.use_rrc else None)
            self._consume_dibits(_flush_demod(
                p, history, self.state, tail[:, p.nt1:],
                pos=p.drift_budget))
        self.samples = None  # further push() fails loudly


def _flush_demod(pipeline, rrc, demod, tail: np.ndarray,
                 pos: int = 0) -> list:
    """Demodulate a bank's buffered sample tail [C, fill] with the
    per-symbol host oracle of the pipeline's protocol, seeded from the
    device carry ``demod`` whose positions lie ``pos`` samples before the
    tail's origin. The pipeline's filter stage, if it has one
    (``rrc_design``; K4 on the card), first filters the tail from the
    history ``rrc``. Returns one uint8 symbol array per channel (lengths
    may differ — the oracle stops exactly where the reference's canProcess
    would)."""
    if pipeline.rrc_design is not None and tail.shape[1]:
        filtered, _ = rrc_filter_block(
            torch.from_numpy(tail).to(pipeline.device), rrc,
            pipeline.rrc_design, taps=pipeline.rrc_taps)
        tail = _host(filtered)
    positions = _host(demod.pos)
    offset = _host(demod.offset)
    ring = _host(demod.volume_ring)
    spec = pipeline.spec
    out = []
    for c in range(tail.shape[0]):
        o = spec.host_demod(pipeline.sps, invert=spec.invert)
        o.pos = int(positions[c]) + pos
        o.variance_offset = int(offset[c])
        o.volume_rb = ring[c].astype(np.float32).copy()
        out.append(o.process(tail[c]))
    return out

