"""Streaming time-parallelism with an EXACT cross-shard carry chain (port of
``digiham_tpu/parallel/streaming.py``).

``sharded_pipeline_step`` (sharded.py) is bulk mode: each time shard
demodulates from a fresh state, fine for recorded archives but not
bit-exact for a continuous stream. This module is the streaming mode: the
demodulator's O(1) carry (pos / pending slew / volume ring,
fsk_demodulator.cpp:37,84-87) threads through the time shards, so a
time-sharded stream decodes byte-identically to the single-device pipeline
step chain, for all five protocols (only sps, the RRC design, the sync
patterns and the frame decode differ).

How the axes parallelize, and what cannot:

- **RRC FIR** (the bulk of per-sample FLOPs): time-parallel via
  overlap-save; each shard takes its left raw halo (``taps-1`` +
  drift-budget samples) from its neighbour. NXDN exchanges the narrow
  design's 160-sample halo; the 2FSK protocols (D-Star, POCSAG) run no RRC
  and exchange only the drift-budget halo. Kernel K4 on the card, once for
  the slots of a device.
- **Sync correlation + frame-field FEC decode**: time-parallel on the
  decoded symbol segments (a ``sync_len-1`` symbol right halo covers
  windows that straddle shard boundaries); K5 once a device for YSF.
- **The demod carry itself is a true sequential dependency**: symbol
  ``n``'s sample window depends on every ±1 timing slew before it, so
  shard ``t+1`` cannot demodulate before shard ``t``'s carry exists. The
  step runs the demod as a ring of ``n_time`` rounds: in round ``r`` only
  time shard ``r`` demodulates (K3, once for the channel rows of a device)
  and its carry hops to shard ``r+1``. The JAX step demodulates every shard
  in every round and keeps one; this is the same result with ``n_time``
  times less work. The final hop ``T-1 -> 0`` lands the stream carry where
  the next step's first segment needs it. The serialization is the
  reference's feedback loop, not a fault.

Semantics contract (``tests/test_torch_streaming_shards.py``): for any
number of time shards and consecutive steps, the symbol stream, every
dense sync-distance stream (valid region) and every decoded frame field
equal the single-device pipeline stream and the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dsp.demod import (CENTURY, DemodState, demod_init, fsk_demod_block,
                         gfsk_demod_block)
from ..pipeline import protocol_named
from .sharded import (LocalRows, Mesh, _taps, assemble, device_tables,
                      filter_with_halo, hop, per_device, row_bounds,
                      sync_patterns, take, tree_cat)


# centuries a time shard by default
DEFAULT_CPS = {"dmr": 36, "ysf": 24, "nxdn": 16, "dstar": 16, "pocsag": 8}


class TimeShardedPipeline:
    """(channel, time)-sharded streaming pipeline step, any protocol.

    Differences from the single-device ``*Pipeline`` classes:

    - fixed-stride consumption: every step consumes exactly
      ``block_len = n_time * centuries_per_shard * 100 * sps`` samples
      per channel; the per-channel ±1/century timing drift accumulates in
      the carried ``pos`` instead of the block size. ``drift_budget``
      bounds |pos| (halo headroom); the driver asserts it.
    - the caller supplies ``edges``: the ``h_left`` raw samples before
      the block and ``h_right`` after it (the stream driver keeps the
      tail / waits for the lookahead).

    Where the protocol decodes frame fields on the device (DMR, YSF),
    ``centuries_per_shard`` must keep segments frame-aligned (multiples of
    36 for DMR's 144, of 24 for YSF's 480). The devices are the mesh's
    (``make_mesh(devices=None)`` is the card); each slot's device holds its
    own copy of the protocol's tables. The state lives on the mesh's first
    device.
    """

    def __init__(self, mesh: Mesh, channels: int, protocol: str = "dmr",
                 sps: int | None = None,
                 centuries_per_shard: int | None = None,
                 use_rrc: bool = True, drift_budget: int = 24):
        if tuple(mesh.axis_names) != ("channel", "time"):
            raise ValueError("mesh needs ('channel', 'time') axes")
        self.spec = spec = protocol_named(protocol)
        self.protocol = protocol
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.channels = channels
        self.bounds = row_bounds(mesh, channels)
        self.sps = spec.sps if sps is None else sps
        if centuries_per_shard is None:
            centuries_per_shard = DEFAULT_CPS[protocol]
        self.centuries_per_shard = centuries_per_shard
        self.use_rrc = use_rrc and spec.design is not None
        # the filter the step applies (None: none), as the bank pipelines
        # expose it
        self.rrc_design = spec.design if self.use_rrc else None
        self.invert = spec.invert
        self.drift_budget = drift_budget
        self.seg_symbols = centuries_per_shard * CENTURY
        if spec.step_decodes and self.seg_symbols % spec.frame_size:
            quantum = math.lcm(CENTURY, spec.frame_size) // CENTURY
            raise ValueError(
                f"centuries_per_shard={centuries_per_shard} leaves segments "
                f"frame-misaligned ({self.seg_symbols} % {spec.frame_size} "
                f"!= 0); use a multiple of {quantum}")
        self.seg_len = self.seg_symbols * self.sps
        self.block_len = self.n_time * self.seg_len
        self.symbols_per_block = self.n_time * self.seg_symbols
        # total centuries per step (TrackedChannelBank sizing contract)
        self.n_centuries = self.n_time * centuries_per_shard
        self.nt1 = spec.design.ntaps - 1 if self.use_rrc else 0
        self.h_left = self.nt1 + drift_budget
        self.h_right = drift_budget + centuries_per_shard + 2
        if self.seg_len < max(self.h_left, self.h_right):
            raise ValueError(f"segments of {self.seg_len} samples are "
                             f"shorter than the halos {self.h_left} / "
                             f"{self.h_right}")
        self.max_sync = spec.sync_len

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    @property
    def rrc_taps(self) -> torch.Tensor | None:
        """The filter's taps on the first device (None: no filter)."""
        return _taps(self.rrc_design, str(self.device)) if self.use_rrc \
            else None

    def tables(self):
        """The protocol's decode tables on the first device (what the
        tracked bank's batched frame decode reads)."""
        return device_tables(self.spec.tables, str(self.device))

    def init_state(self) -> DemodState:
        return demod_init(self.channels, self.device)

    # ------------------------------------------------------------------
    def _demod(self, y, pos, offset, ring):
        """One segment's century demod (K3 on the card) from a carry whose
        pos is relative to the segment origin; y starts ``drift_budget``
        samples earlier. Returns (symbols, the carry rebased to the next
        segment's origin)."""
        D = self.drift_budget
        st = DemodState(pos + D, offset, ring)
        if self.spec.kind == "gfsk":
            sym, out = gfsk_demod_block(y, st, self.centuries_per_shard,
                                        self.sps)
        else:
            sym, out = fsk_demod_block(y, st, self.centuries_per_shard,
                                       self.sps, self.invert)
        return sym, (out.pos - D - self.seg_len, out.offset,
                     out.volume_ring)

    def _post(self, symbols, last: bool):
        """Sync correlation (marking the last shard's windows that run
        past the block invalid, 99) and the frame decode of a device's
        segments; ``last``: [rows] bool, the rows of the last time
        shard."""
        spec, seg_sym = self.spec, self.seg_symbols
        dev = str(symbols.device)
        out = {}
        win = torch.arange(seg_sym, device=symbols.device)
        for s, pattern in zip(spec.syncs, sync_patterns(spec, dev)):
            dist = spec.correlate(symbols, pattern)[:, :seg_sym]
            invalid = last[:, None] & (win > seg_sym - s.length)[None, :]
            invalid = invalid.reshape(invalid.shape + (1,) * (dist.dim() - 2))
            out[s.key] = torch.where(invalid, 99, dist)
        if spec.step_decodes:
            frames = symbols[:, :seg_sym].reshape(
                symbols.shape[0], seg_sym // spec.frame_size, spec.frame_size)
            out.update(spec.decode(frames, device_tables(spec.tables, dev)))
        return out

    def step(self, body, edges, state):
        """body: [C, block_len] raw samples; edges: [C, h_left+h_right]
        (the h_left raw samples before the block + h_right after); state:
        demod carry, pos relative to the block origin. Tensors or numpy;
        across processes each is this process's :class:`LocalRows`.

        Returns (outputs, new_state): outputs mirrors the single-device
        ``step`` (symbols [C, S], each dense sync-distance stream [C, S]
        with the final sync_len-1 columns invalid, frame fields
        [C, S/frame_size, ...] where the protocol has them) and
        new_state.pos is already relative to the NEXT block origin. Across
        processes: outputs hold this process's :class:`Shard` lists and
        new_state is :class:`LocalRows` of the channel rows whose first
        time shard is here (None if there are none)."""
        mesh, T, bounds = self.mesh, self.n_time, self.bounds
        HL, HR, seg, nt1 = self.h_left, self.h_right, self.seg_len, self.nt1
        n_c = mesh.shape["channel"]
        local = mesh.local
        x = {(i, j): take(body, bounds[i], (j * seg, (j + 1) * seg),
                          mesh.device((i, j))).float()
             for i, j in local}

        def rows(src, dst):
            return bounds[src[0]][1] - bounds[src[0]][0]

        # raw-sample halos: left from shard t-1, right from shard t+1; the
        # block edges at the ends
        lefts = hop(mesh, [((i, j), (i, j + 1)) for i in range(n_c)
                           for j in range(T - 1)],
                    {k: (v[:, seg - HL:],) for k, v in x.items()},
                    lambda s, d: [((rows(s, d), HL), torch.float32)])
        rights = hop(mesh, [((i, j + 1), (i, j)) for i in range(n_c)
                            for j in range(T - 1)],
                     {k: (v[:, :HR],) for k, v in x.items()},
                     lambda s, d: [((rows(s, d), HR), torch.float32)])
        xe = {}
        for (i, j), v in x.items():
            dev = v.device
            left = (lefts[(i, j)][0] if j > 0 else
                    take(edges, bounds[i], (0, HL), dev).float())
            right = (rights[(i, j)][0] if j < T - 1 else
                     take(edges, bounds[i], (HL, HL + HR), dev).float())
            xe[(i, j)] = torch.cat([left, v, right], dim=1)

        # RRC: time-parallel overlap-save (exact with the halo); y[0] is
        # the filtered stream sample at segment origin - drift_budget
        if self.use_rrc:
            y = per_device(mesh, local, lambda e: filter_with_halo(
                e[:, nt1:], e[:, :nt1], self.rrc_design), xe)
        else:
            y = xe

        # demod: the sequential ring; round r demodulates time shard r
        carry = {(i, 0): tuple(take(f, bounds[i], None, mesh.device((i, 0)))
                               for f in _fields(state))
                 for i in range(n_c) if mesh.is_local((i, 0))}
        symbols = {}
        for r in range(T):
            keys = [(i, r) for i in range(n_c) if mesh.is_local((i, r))]
            done = per_device(mesh, keys, lambda yy, st: self._demod(yy, *st),
                              y, carry)
            for key, (sym, _) in done.items():
                symbols[key] = sym
            if T > 1:
                carry = hop(
                    mesh, [((i, r), (i, (r + 1) % T)) for i in range(n_c)],
                    {k: st for k, (_, st) in done.items()},
                    lambda s, d: [((rows(s, d),), torch.int32),
                                  ((rows(s, d),), torch.int32),
                                  ((rows(s, d), CENTURY), torch.float32)])
            else:
                carry = {k: st for k, (_, st) in done.items()}

        # sync correlation: time-parallel with a symbol halo from shard t+1
        H = self.max_sync - 1
        halos = hop(mesh, [((i, j + 1), (i, j)) for i in range(n_c)
                           for j in range(T - 1)],
                    {k: (v[:, :H],) for k, v in symbols.items()},
                    lambda s, d: [((rows(s, d), H), torch.uint8)])
        padded, last = {}, {}
        for (i, j), sym in symbols.items():
            dh = (halos[(i, j)][0] if j < T - 1 else
                  torch.zeros((sym.shape[0], H), dtype=sym.dtype,
                              device=sym.device))
            padded[(i, j)] = torch.cat([sym, dh], dim=1)
            last[(i, j)] = torch.full((sym.shape[0],), j == T - 1,
                                      device=sym.device)
        post = per_device(mesh, local, self._post, padded, last)
        shape = (self.channels, self.block_len)
        outputs = {"dibits": assemble(mesh, symbols, shape)}
        for key in post[local[0]]:
            outputs[key] = assemble(mesh, {k: v[key] for k, v in post.items()},
                                    shape)

        # the stream carry sits on time shard 0 after the wrap hop
        firsts = sorted(carry)
        if mesh.single_process:
            dev = mesh.first_device
            new_state = DemodState(*(
                torch.cat([carry[k][f].to(dev) for k in firsts])
                for f in range(3)))
        elif firsts:
            lo, hi = bounds[firsts[0][0]][0], bounds[firsts[-1][0]][1]
            new_state = LocalRows(DemodState(*tree_cat(
                [carry[k] for k in firsts])), slice(lo, hi),
                (self.channels,))
        else:
            new_state = None
        return outputs, new_state

    def drive(self, buffer, state, step_fn):
        """Run the block loop over every full buffered block: the one
        encoding of the halo/consume/recenter contract shared by both
        drivers (TimeShardedStream and TimeShardedTrackedBank).
        ``step_fn(body, edges, state) -> (out, new_state)`` is the
        caller's device step plus any per-block host work. Returns
        ``(outs, state)``. Needs a mesh in one process (the carry is read
        on the host).

        Drift recentering: real streams carry clock skew (an SDR at ±20
        ppm slews the demod timing ~1 sample per 50 centuries), so under a
        strictly fixed stride the carried ``pos`` would drift without
        bound and trip the budget. When the worst |pos| passes half the
        budget, the common-mode drift (median over channels, truncated
        toward zero) is folded back into the stream consumption: consume
        ``block_len + delta`` and subtract delta from ``pos``, the
        unsharded driver's variable stride applied at block granularity,
        changing nothing about which samples any symbol reads."""
        if not self.mesh.single_process:
            raise ValueError("the stream drivers need every slot of the "
                             "mesh in this process")
        outs = []
        need = self.h_left + self.block_len + self.h_right
        while buffer.fill >= need:
            view = buffer.view(need)
            body = view[:, self.h_left:self.h_left + self.block_len]
            edges = np.concatenate(
                [view[:, :self.h_left],
                 view[:, self.h_left + self.block_len:]], axis=1)
            out, state = step_fn(body, edges, state)
            self.check_drift(state)
            outs.append(out)
            pos = state.pos.cpu().numpy()
            delta = 0
            if np.abs(pos).max() > self.drift_budget // 2:
                delta = int(np.median(pos))
            if delta:
                state = DemodState(state.pos - delta, state.offset,
                                   state.volume_ring)
            buffer.consume(self.block_len + delta)
        return outs, state

    def check_drift(self, state) -> None:
        """The carried pos must stay inside the halo budget the sharded
        layout reserved."""
        pos = state.pos.cpu().numpy()
        if np.abs(pos).max() >= self.drift_budget:
            raise RuntimeError(
                f"timing drift {pos.min()}..{pos.max()} exceeded the "
                f"halo budget ±{self.drift_budget}; raise drift_budget "
                "or re-acquire")


def _fields(state):
    """A carry's (pos, offset, volume_ring), or those of each process's
    :class:`LocalRows` of one."""
    if isinstance(state, LocalRows):
        return tuple(LocalRows(t, state.rows, state.shape)
                     for t in _fields(state.data))
    return state.pos, state.offset, state.volume_ring


class TimeShardedDmrPipeline(TimeShardedPipeline):
    """The DMR-specific entry point of the JAX package."""

    def __init__(self, mesh: Mesh, channels: int, sps: int | None = None,
                 centuries_per_shard: int | None = None,
                 use_rrc: bool = True, drift_budget: int = 24):
        super().__init__(mesh, channels, protocol="dmr", sps=sps,
                         centuries_per_shard=centuries_per_shard,
                         use_rrc=use_rrc, drift_budget=drift_budget)


class TimeShardedStream:
    """Host driver for :class:`TimeShardedPipeline`: keeps the raw
    left-edge tail, waits for ``h_right`` lookahead samples, consumes
    exactly ``block_len`` per step (plus the recentering), and asserts the
    carried drift stays inside the halo budget."""

    def __init__(self, pipeline: TimeShardedPipeline):
        from ..runtime.stream import SampleBuffer

        self.p = pipeline
        self.state = pipeline.init_state()
        self.buffer = SampleBuffer(pipeline.channels)
        # prime the left edge: stream start = zeros (reference delay lines
        # start zeroed)
        self.buffer.push(np.zeros((pipeline.channels, pipeline.h_left),
                                  np.float32))

    def push(self, samples: np.ndarray) -> list[dict]:
        self.buffer.push(samples)
        outs, self.state = self.p.drive(self.buffer, self.state,
                                        self.p.step)
        return outs


# the JAX package's DMR-specific name
TimeShardedDmrStream = TimeShardedStream
