"""TrackedChannelBank: the acquisition/tracking split at scale (port of
``digiham_tpu/runtime/tracked_bank.py``).

The plain ChannelBank runs full symbol-domain phase machines per channel.
This bank moves the steady state onto the device: a host sync phase hunts
for frame lock per channel (vectorized numpy scan); once locked, the bank
extracts frame-aligned dibit windows for ALL locked channels, decodes
every frame's fields in ONE batched device call, and feeds a lightweight
fields-consuming frame machine per channel — no host FEC in the common
path.

Protocol specifics live in the adapter: :class:`DmrAdapter`,
:class:`YsfAdapter` and :class:`NxdnAdapter` over the three 4FSK
pipelines, :class:`DstarAdapter` and :class:`PocsagAdapter` over
``FskPipeline`` (bits for dibits). An adapter whose tracker reads the
frame's raw dibits besides its fields (YSF's rare frame types) says so
with ``tracker_takes_raw``; one whose frames need symbols past their end
(D-Star's full-length terminator) gives the count as ``lookahead``; a hunt
that is partway through a multi-stage acquisition (a pending D-Star header
decode) says so by a false ``hunting``, and the device-gated fast skip
then keeps its exact stream position.
Output contract: byte- and event-identical to running the per-channel
symbol-domain Decoder, and to the JAX package's bank
(tests/test_torch_tracked_bank{,_ysf,_nxdn,_dstar,_pocsag}.py on
structured, corrupted and noise streams).

Host <-> device traffic of one ``push`` step, each a synchronisation: the
block goes up once; ``state.demod.pos`` comes down before and after the
step (and once more when ``push`` finds too few samples left), the
``[C]`` block-hit flags and the dibits once each; every decode round sends
its frame batch up and fetches its dict of fields, one blocking copy per
field of ``dmr_decode_frames`` (16), ``ysf_decode_frames`` (6),
``nxdn_decode_frames`` (12), ``dstar_decode_frames`` (5) or
``pocsag_decode_frames`` (3). A 2FSK step fetches its ``[C]`` block-hit
flags the same way, reduced on the card from the dense distances of every
sync pattern.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..dsp.demod import FskDemodNp, GfskDemodNp
from ..dsp.rrc import rrc_filter_block
from .channel_bank import bank_device
from .checkpoint import load_state, save_state
from .decoder import Output
from .metrics import REGISTRY
from .stream import SampleBuffer, rrc_rebase_history


def _fetch(fields: dict) -> dict:
    """A decode dict on the host: one blocking copy per field."""
    return {k: v.cpu().numpy() for k, v in fields.items()}


class DmrAdapter:
    frame_size = 144
    # symbols past a frame's end that its fields read (D-Star: 24)
    lookahead = 0
    # sync pattern window begins sync_offset symbols into a frame and
    # spans sync_len symbols (used for device-gated hunting)
    sync_offset = 66
    sync_len = 24
    # the tracker's process_fields takes the fields only
    tracker_takes_raw = False

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: does the device's dense correlation see any
        potential sync in this block? (<=3 over any of the 4 patterns)
        Reduced ON DEVICE: only the [C] flags cross to the host, not the
        dense [C, S, 4] distances."""
        d = outputs["sync_dist_dense"]
        return (d <= 3).flatten(1).any(1).cpu().numpy()

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
        """One batched device decode of [N, 144] frames with the
        pipeline's tables; every field moves to the host once, as numpy."""
        from ..pipeline.dmr import dmr_decode_frames
        host = _fetch(dmr_decode_frames(
            torch.from_numpy(frames).to(pipeline.device), pipeline.tables()))
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


class YsfAdapter:
    frame_size = 480
    lookahead = 0
    sync_offset = 0
    sync_len = 20
    # the rare frame types (V/D1, VW, header) decode from the raw dibits
    tracker_takes_raw = True

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: a sync distance <= 3 anywhere in the block, reduced
        on the card."""
        return (outputs["sync_dist_dense"] <= 3).any(1).cpu().numpy()

    def make_hunt(self, meta=None):
        from ..protocols.ysf.phases import SyncPhase
        return SyncPhase()

    def make_meta(self):
        from ..protocols.ysf.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.ysf.fields_phase import YsfFieldsFramePhase
        return YsfFieldsFramePhase(meta)

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        """One batched decode of [N, 480] frames (FICH and DCH in one
        launch of K5 on the card); every field moves to the host once."""
        from ..pipeline.ysf import ysf_decode_frames
        return _fetch(ysf_decode_frames(
            torch.from_numpy(frames).to(pipeline.device), pipeline.tables()))

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


class NxdnAdapter:
    frame_size = 192
    lookahead = 0
    sync_offset = 0
    sync_len = 10
    tracker_takes_raw = False

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: a sync distance <= 2 anywhere in the block, reduced
        on the card."""
        return (outputs["sync_dist_dense"] <= 2).any(1).cpu().numpy()

    def make_hunt(self, meta=None):
        from ..protocols.nxdn.phases import SyncPhase
        return SyncPhase()

    def make_meta(self):
        from ..protocols.nxdn.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.nxdn.fields_phase import NxdnFieldsFramePhase
        return NxdnFieldsFramePhase(meta)

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        """One batched decode of [N, 192] frames (SACCH and both FACCH1
        slots in one launch of K5 on the card); every field moves to the
        host once."""
        from ..pipeline.nxdn import nxdn_decode_frames
        return _fetch(nxdn_decode_frames(
            torch.from_numpy(frames).to(pipeline.device), pipeline.tables()))

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


class DstarAdapter:
    """Bit-domain tracked adapter over ``FskPipeline(protocol="dstar")``.

    Frames are 96 bits (72 voice + 24 slow data) with a 24-bit lookahead
    so the device can score the full-length terminator
    (dstar_phase.cpp:94-101). The hunt handles sync AND the rare 660-bit
    header decode (see DstarHuntPhase); the steady state is batched
    tensor math + O(frames) host bookkeeping.
    """

    frame_size = 96
    lookahead = 24
    sync_offset = 0
    sync_len = 24
    tracker_takes_raw = False

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: a header sync within 2 or a voice sync within 1
        anywhere in the block, reduced on the card."""
        return ((outputs["sync_dist_header_sync"] <= 2).any(1)
                | (outputs["sync_dist_voice_sync"] <= 1).any(1)).cpu().numpy()

    def make_hunt(self, meta=None):
        from ..protocols.dstar.fields_phase import DstarHuntPhase
        return DstarHuntPhase(meta)

    def make_meta(self):
        from ..protocols.dstar.meta import MetaCollector
        return MetaCollector()

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.dstar.fields_phase import DstarFieldsFramePhase
        return DstarFieldsFramePhase(meta, locked)

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        """One batched decode of [N, 120] frames; every field moves to the
        host once."""
        from ..pipeline.fsk import dstar_decode_frames
        return _fetch(dstar_decode_frames(
            torch.from_numpy(frames).to(pipeline.device), pipeline.tables()))

    def field_row(self, host: dict, row: int):
        from ..protocols.dstar.fields_phase import DstarFrameFields
        return DstarFrameFields(
            voice_bytes=host["voice"][row].tobytes(),
            data_bytes=host["data"][row].tobytes(),
            term_full=int(host["term_full"][row]),
            term_half=int(host["term_half"][row]),
            vsync_dist=int(host["vsync_dist"][row]),
        )


class PocsagAdapter:
    """Bit-domain tracked adapter over ``FskPipeline(protocol="pocsag")``.

    Every 32-bit window is decoded both ways at once (BCH codeword + sync
    word distance); the host frame machine (PocsagFieldsFramePhase) picks
    per its position in the 16-codeword batch. This removes the
    per-codeword host BCH of the symbol path. No metadata stream
    (pocsag_decoder.cpp).
    """

    frame_size = 32
    lookahead = 0
    sync_offset = 0
    sync_len = 32
    tracker_takes_raw = False

    def block_hits(self, outputs) -> np.ndarray:
        """[C] bool: a preamble within 3 anywhere in the block, reduced
        on the card."""
        return (outputs["sync_dist_preamble"] <= 3).any(1).cpu().numpy()

    def make_hunt(self, meta=None):
        from ..protocols.pocsag import SyncPhase
        return SyncPhase()

    def make_meta(self):
        return None

    def make_tracker(self, meta, slot_filter: int, locked=None):
        from ..protocols.pocsag import PocsagFieldsFramePhase
        return PocsagFieldsFramePhase()

    def decode_fields(self, frames: np.ndarray, pipeline) -> dict:
        """One batched decode of [N, 32] codewords; every field moves to
        the host once."""
        from ..pipeline.fsk import pocsag_decode_frames
        return _fetch(pocsag_decode_frames(
            torch.from_numpy(frames).to(pipeline.device), pipeline.tables()))

    def field_row(self, host: dict, row: int):
        from ..protocols.pocsag import PocsagFrameFields
        return PocsagFrameFields(
            # int64 holding the unsigned 32-bit word, read from numpy
            word=int(host["word"][row]),
            ok=bool(host["ok"][row]),
            sync_dist=int(host["sync_dist"][row]),
        )


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


class TrackedChannelBank:
    """Device pipeline -> batched field decode -> host trackers.

    pipeline: one of the bank pipelines (``DmrPipeline``,
        ``YsfPipeline``, ``NxdnPipeline``, ``FskPipeline``); the bank steps
        it through ``step_symbols`` (dibits or bits and dense sync
        distances) and decodes its own frames.
    adapter: the pipeline's protocol adapter (default DMR).
    device: ``None`` is the card; the pipeline must live there.
    """

    def __init__(self, pipeline, on_output=None, slot_filter: int = 3,
                 adapter=None, device=None):
        self.device = bank_device(pipeline, device)
        self.adapter = adapter or DmrAdapter()
        self.pipeline = pipeline
        self.channels = pipeline.channels
        self.state = pipeline.init_state()
        self.samples = SampleBuffer(self.channels)
        self.on_output = on_output
        self.slot_filter = slot_filter
        self.chans = [_Channel(self.adapter) for _ in range(self.channels)]
        sps = pipeline.sps
        self._need = pipeline.n_centuries * (100 * sps + 1) + 2
        self._frame_size = self.adapter.frame_size
        self._lookahead = self.adapter.lookahead
        self._meter = REGISTRY.meter(
            f"tracked_bank[{self.channels}ch]", "channel-samples")
        self._registry = REGISTRY
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
            "samples": self.samples.data[:, :self.samples.fill].copy(),
        })

    def restore(self, blob: bytes) -> None:
        """Inverse of ``snapshot`` on a bank built with the same pipeline
        configuration, on this bank's device whichever device wrote the
        blob. Writers already attached to this bank's channels are carried
        over to the restored metadata collectors."""
        payload = pickle.loads(blob)
        if payload["samples"].shape[0] != self.channels:
            raise ValueError(
                f"checkpoint has {payload['samples'].shape[0]} channels, "
                f"bank has {self.channels}")
        self.state = load_state(payload["pipeline_state"], self.device)
        prev = self.chans
        self.chans = pickle.loads(payload["chans"])
        for new, old in zip(self.chans, prev):
            if new.meta is not None and old.meta is not None:
                new.meta.writer = old.meta.writer
        self.samples = SampleBuffer(self.channels)
        if payload["samples"].shape[1]:
            self.samples.push(payload["samples"])
        # a restored stream is conservatively mid-stream: the zero-pad
        # branch of rrc_rebase_history must never fire on it (the real
        # left context lives in the restored RRC state, not this buffer)
        self.samples.consumed = 1

    # ------------------------------------------------------------------
    def push(self, samples: np.ndarray) -> None:
        if self.samples is None:
            raise RuntimeError("bank was flushed; create a new bank")
        self.samples.push(samples)
        while True:
            pos = self.state.demod.pos.cpu().numpy()
            need = int(pos.max()) + self._need
            if self.samples.fill < need:
                return
            block = self.samples.view(need)
            with self._meter.measure(
                    self.channels * self.pipeline.n_centuries * 100
                    * self.pipeline.sps):
                out, self.state = self.pipeline.step_symbols(
                    torch.from_numpy(block).to(self.device), self.state)
                hits = self.adapter.block_hits(out)
                self._consume_dibits(out["dibits"].cpu().numpy(), hits)
            self._registry.maybe_report()
            new_pos = self.state.demod.pos.cpu().numpy()
            base = int(new_pos.min())
            if base > 0:
                rrc = rrc_rebase_history(
                    self.pipeline, self.state, block, base,
                    stream_start=self.samples.consumed == 0)
                if rrc is not None:
                    self.state.rrc = rrc
                self.samples.consume(base)
                # stays int32 on the device
                self.state.demod.pos = self.state.demod.pos - base

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
        symbols = _flush_demod(self.pipeline, self.state, self.samples)
        self._consume_dibits(symbols)
        self.samples = None  # further push() fails loudly

    # ------------------------------------------------------------------
    def _consume_dibits(self, dibits, block_hits=None) -> None:
        for c, ch in enumerate(self.chans):
            old_len = len(ch.buffer)
            ch.buffer = np.concatenate([ch.buffer, dibits[c]])
            if (block_hits is not None and ch.tracker is None
                    and not block_hits[c] and _hunting(ch.hunt)):
                self._fast_skip(ch, old_len)
        # alternate hunting and batched frame decoding until quiescent
        while True:
            for ch in self.chans:
                self._hunt(ch)
            if self._decode_round() == 0:
                break

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
        if not idx:
            return 0

        host = self.adapter.decode_fields(frames, self.pipeline)

        fed = 0
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
                fed += 1
                if lost:
                    # re-hunt keep_from dibits into the failing frame
                    # (NXDN's TX_RELEASE exits mid-frame; a full D-Star
                    # terminator eats the lookahead too)
                    ch.tracker = None
                    ch.hunt = self.adapter.make_hunt(ch.meta)
                    ch.buffer = ch.buffer[
                        consumed_frames * FS + keep_from:]
                    break
                consumed_frames += 1
            else:
                ch.buffer = ch.buffer[consumed_frames * FS:]
        return fed

    def _hunt(self, ch: _Channel) -> None:
        while ch.tracker is None \
                and len(ch.buffer) > ch.hunt.required_data():
            nxt, consumed = ch.hunt.process(ch.buffer, ch.out)
            ch.buffer = ch.buffer[consumed:]
            if nxt is not None:
                ch.tracker = self.adapter.make_tracker(
                    ch.meta, self.slot_filter, nxt)
                return
            if consumed == 0:
                return


def _flush_demod(pipeline, state, samples) -> list:
    """Demodulate a bank's buffered sample tail with the per-symbol host
    oracle seeded from the device carry. Returns one uint8 symbol array
    per channel (lengths may differ — the oracle stops exactly where the
    reference's canProcess would)."""
    fill = samples.fill
    tail = samples.data[:, :fill]
    # replicate the pipeline's filter stage on the tail (same math/state).
    # Every pipeline exposes its filter design as the rrc_design attribute
    # (None = no filtering, the 2FSK default: no K4 then).
    design = getattr(pipeline, "rrc_design", None)
    if design is not None and fill:
        filtered, _ = rrc_filter_block(
            torch.from_numpy(tail).to(pipeline.device), state.rrc, design,
            taps=pipeline.rrc_taps)
        tail = filtered.cpu().numpy()
    pos = state.demod.pos.cpu().numpy()
    offset = state.demod.offset.cpu().numpy()
    ring = state.demod.volume_ring.cpu().numpy()
    if getattr(pipeline, "protocol", None) in ("dstar", "pocsag"):
        cls, invert = FskDemodNp, pipeline.invert
    else:
        cls, invert = GfskDemodNp, False
    out = []
    for c in range(tail.shape[0]):
        o = cls(pipeline.sps, invert=invert)
        o.pos = int(pos[c])
        o.variance_offset = int(offset[c])
        o.volume_rb = ring[c].astype(np.float32).copy()
        out.append(o.process(tail[c]))
    return out

