"""(channel, time) sharding of the bank steps over devices (port of
``digiham_tpu/parallel/sharded.py``): the scale-out story.

The reference scales by running one Unix process per channel
(examples/*.sh). Here a :class:`Mesh` is a ``(channel, time)`` grid of
shard slots; each slot names a ``torch.device`` and the rank of the
process that owns it (always 0 in one process; ``parallel.distributed``
fills the ranks in across processes).

- **channel** is the data-parallel axis: a bank of independent RF channels
  shards embarrassingly; all per-channel state (RRC history, demod timing,
  frame machines) is local to its shard.
- **time** is the sequence-parallel axis for bulk/recorded workloads: one
  long capture splits along the sample axis. Convolutional stages need the
  trailing ``taps-1`` samples of the previous shard: an **overlap-save
  halo exchange**.

A grid may name one device several times (one H100 runs a (2, 2) mesh, as
the JAX tests run 8 virtual devices on one CPU). Between slots of one
process a collective is a tensor move: the halo hop, the carry ring of
``parallel/streaming.py`` and the sum over ``time``. Between processes the
hops go through ``torch.distributed.batch_isend_irecv`` and the sum
through ``all_reduce`` on the ranks of one channel row. Slots on the same
device are batched: their rows run through one launch of each kernel (K4
over the rows of every shard with its halo, K3, the frame decode), which
computes what one launch per shard computes.

Outputs have the JAX functions' shapes. Where every slot lies in this
process, the result is the assembled ``[C, ...]`` tensor on the first
slot's device; across processes it is the list of this process's
:class:`Shard` blocks, each with its index into the global array (the JAX
global array's ``addressable_shards``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..dsp.demod import demod_init, fsk_demod_block, gfsk_demod_block
from ..dsp.rrc import WIDE_RRC, RrcDesign, RrcState, rrc_filter_block
from ..pipeline import DMR, Protocol, protocol_named


@dataclasses.dataclass(frozen=True)
class Slot:
    """One shard of the grid: where it runs and which process runs it."""

    device: torch.device
    rank: int = 0


class Mesh:
    """A ``(channel, time)`` grid of :class:`Slot`. ``rank`` is this
    process's; ``row_groups`` maps a channel row whose slots span several
    processes to its ``torch.distributed`` group (the ranks that sum over
    ``time``)."""

    axis_names = ("channel", "time")

    def __init__(self, slots, rank: int = 0, row_groups=None):
        self.slots = [list(row) for row in slots]
        if not self.slots or not self.slots[0] or any(
                len(row) != len(self.slots[0]) for row in self.slots):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.rank = rank
        self.row_groups = dict(row_groups or {})

    @property
    def shape(self) -> dict:
        return {"channel": len(self.slots), "time": len(self.slots[0])}

    @property
    def devices(self) -> list:
        """The slots' devices, channel-major."""
        return [s.device for row in self.slots for s in row]

    def device(self, key) -> torch.device:
        return self.slots[key[0]][key[1]].device

    def rank_of(self, key) -> int:
        return self.slots[key[0]][key[1]].rank

    def is_local(self, key) -> bool:
        return self.rank_of(key) == self.rank

    @property
    def local(self) -> list:
        """This process's slots as (channel, time) keys, channel-major."""
        n_c, n_t = self.shape["channel"], self.shape["time"]
        return [(i, j) for i in range(n_c) for j in range(n_t)
                if self.is_local((i, j))]

    @property
    def single_process(self) -> bool:
        return all(s.rank == self.rank for row in self.slots for s in row)

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first slot: where assembled
        results and a driver's state live."""
        local = self.local
        if not local:
            raise ValueError(f"rank {self.rank} owns no slot of the mesh")
        return self.device(local[0])

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}, devices "
                f"{[str(d) for d in self.devices]})")


def make_mesh(n_channel_shards: int | None = None, n_time_shards: int = 1,
              devices=None) -> Mesh:
    """A (channel, time) mesh over ``devices``, channel-major, all owned by
    this process. ``devices=None`` is every visible CUDA device; it raises
    when there are fewer devices than shards (never packing shards onto
    fewer devices on its own: pass ``["cuda:0"] * 4`` for that)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "digiham_tpu_torch found no CUDA device for the mesh: pass "
                "devices= (for instance [\"cpu\"] * 4) to shard elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_channel_shards is None:
        n_channel_shards = len(devices) // n_time_shards
    need = n_channel_shards * n_time_shards
    if need < 1 or need > len(devices):
        raise ValueError(
            f"a ({n_channel_shards}, {n_time_shards}) mesh needs {need} "
            f"devices, {len(devices)} given")
    return Mesh([[Slot(devices[i * n_time_shards + j])
                  for j in range(n_time_shards)]
                 for i in range(n_channel_shards)])


# --- rows across processes ---------------------------------------------------

@dataclasses.dataclass
class LocalRows:
    """This process's rows of a global ``[C, ...]`` array: ``data`` holds
    global rows ``rows`` (a tensor, numpy array or a state dataclass of
    tensors); ``shape`` is the global array's."""

    data: object
    rows: slice
    shape: tuple


@dataclasses.dataclass
class Shard:
    """One block of a result computed by this process: ``data`` is the
    global array's ``[index]``."""

    index: tuple
    data: torch.Tensor


def take(x, rows: tuple[int, int], cols=None, device=None):
    """Global rows ``rows`` (and columns ``cols``) of ``x`` — a tensor, a
    numpy array or :class:`LocalRows` — as a tensor on ``device``."""
    lo, hi = rows
    if isinstance(x, LocalRows):
        start, stop = x.rows.start or 0, x.rows.stop
        if lo < start or hi > stop:
            raise ValueError(f"rows {lo}:{hi} are not in this process's "
                             f"rows {start}:{stop}")
        x, lo, hi = x.data, lo - start, hi - start
    block = x[lo:hi] if cols is None else x[lo:hi, cols[0]:cols[1]]
    return torch.as_tensor(block).to(device)


def row_bounds(mesh: Mesh, channels: int) -> list[tuple[int, int]]:
    """The channel rows of each channel shard; raises when they do not
    divide."""
    n_c = mesh.shape["channel"]
    if channels % n_c:
        raise ValueError(f"{channels} channels not divisible by the "
                         f"{n_c}-way 'channel' mesh axis")
    per = channels // n_c
    return [(i * per, (i + 1) * per) for i in range(n_c)]


# --- pytrees of tensors (a tensor, a tuple, a dict, a state dataclass) ------

def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_cat(trees: list, dim: int = 0):
    """Concatenate trees of one structure leaf by leaf."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees, dim=dim) if len(trees) > 1 else first
    if isinstance(first, dict):
        return {k: tree_cat([t[k] for t in trees], dim) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_cat([t[i] for t in trees], dim)
                           for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: tree_cat([getattr(t, f.name) for t in trees], dim)
            for f in dataclasses.fields(first)})
    if first is None:
        return None
    raise TypeError(f"not a tree of tensors: {type(first).__name__}")


def tree_rows(tree, lo: int, hi: int):
    return tree_map(lambda t: t[lo:hi], tree)


def per_device(mesh: Mesh, keys: list, fn, *inputs: dict) -> dict:
    """``fn`` once per device over the rows of every slot in ``keys`` that
    lies on it, concatenated in ``keys`` order; ``inputs`` map each key to
    a tree whose leaves lead with its rows. Returns key -> the key's rows
    of ``fn``'s output tree. Row-wise work gives what one call per slot
    gives, in one launch of each kernel."""
    groups: dict[str, list] = {}
    for key in keys:
        groups.setdefault(str(mesh.device(key)), []).append(key)
    out = {}
    for group in groups.values():
        sizes = [_rows_of(inputs[0][k]) for k in group]
        result = fn(*(tree_cat([inp[k] for k in group]) for inp in inputs))
        lo = 0
        for key, n in zip(group, sizes):
            out[key] = tree_rows(result, lo, lo + n)
            lo += n
    return out


def _rows_of(tree) -> int:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves[0].shape[0]


# --- collectives -------------------------------------------------------------

def hop(mesh: Mesh, pairs: list, values: dict, templates) -> dict:
    """Move a tuple of tensors from slot ``src`` to slot ``dst`` for each
    ``(src, dst)`` of ``pairs`` (every process lists the same pairs in the
    same order). ``values`` holds the tuple of each local ``src``;
    ``templates(src, dst)`` gives the ``(shape, dtype)`` of each tensor, for
    the receiving buffers. Inside the process a hop is a tensor move; across
    processes one ``batch_isend_irecv`` carries every hop. Returns dst ->
    tuple on dst's device, for the local ``dst`` of ``pairs``."""
    out, ops = {}, []
    for src, dst in pairs:
        src_local, dst_local = mesh.is_local(src), mesh.is_local(dst)
        if src_local and dst_local:
            out[dst] = tuple(t.to(mesh.device(dst)) for t in values[src])
        elif src_local:
            import torch.distributed as dist
            ops += [dist.P2POp(dist.isend, t.contiguous(), mesh.rank_of(dst))
                    for t in values[src]]
        elif dst_local:
            import torch.distributed as dist
            bufs = tuple(torch.empty(shape, dtype=dtype,
                                     device=mesh.device(dst))
                         for shape, dtype in templates(src, dst))
            ops += [dist.P2POp(dist.irecv, b, mesh.rank_of(src))
                    for b in bufs]
            out[dst] = bufs
    if ops:
        import torch.distributed as dist
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def halo_from_left(mesh: Mesh, x: dict, halo: int, bounds) -> dict:
    """Each slot's left neighbour's trailing ``halo`` samples; time shard 0
    receives zeros (stream start). x: key -> [rows, T_local]."""
    n_c, n_t = mesh.shape["channel"], mesh.shape["time"]
    pairs = [((i, j), (i, j + 1)) for i in range(n_c) for j in range(n_t - 1)]
    moved = hop(mesh, pairs, {k: (v[:, v.shape[1] - halo:],)
                              for k, v in x.items()},
                lambda src, dst: [((bounds[src[0]][1] - bounds[src[0]][0],
                                    halo), torch.float32)])
    left = {}
    for key, v in x.items():
        left[key] = (moved[key][0] if key[1] > 0 else
                     torch.zeros((v.shape[0], halo), dtype=v.dtype,
                                 device=v.device))
    return left


def psum_time(mesh: Mesh, parts: dict) -> dict:
    """Sum each channel row's per-slot tensors over the ``time`` axis: a
    tensor move inside the process, ``all_reduce`` on the row's group
    across processes. Returns channel row -> total, for the rows this
    process holds a slot of."""
    rows: dict[int, list] = {}
    for (i, j), t in parts.items():
        rows.setdefault(i, []).append(t)
    out = {}
    for i in sorted(rows):
        local = rows[i]
        total = local[0].clone()
        for t in local[1:]:
            total += t.to(total.device)
        group = mesh.row_groups.get(i)
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(total, group=group)
        out[i] = total
    return out


def local_blocks(mesh: Mesh, samples, seg: int, bounds) -> dict:
    """Each local slot's ``[rows, seg]`` block of the ``[C, T]`` samples,
    on its device."""
    return {(i, j): take(samples, bounds[i], (j * seg, (j + 1) * seg),
                         mesh.device((i, j))).float()
            for i, j in mesh.local}


def assemble(mesh: Mesh, blocks: dict, shape: tuple, time_axis: bool = True):
    """Blocks -> the global result. ``blocks`` maps each local slot (or,
    with ``time_axis=False``, each local channel row) to its tensor; along
    time the blocks lie side by side in dim 1. Single process: the
    assembled tensor on the first slot's device. Across processes: this
    process's :class:`Shard` list."""
    n_c, n_t = mesh.shape["channel"], mesh.shape["time"]
    per = shape[0] // n_c
    if mesh.single_process:
        dev = mesh.first_device
        if not time_axis:
            return torch.cat([blocks[i].to(dev) for i in range(n_c)])
        return torch.cat([torch.cat([blocks[(i, j)].to(dev)
                                     for j in range(n_t)], dim=1)
                          for i in range(n_c)])
    shards = []
    for key, data in sorted(blocks.items()):
        i = key if not time_axis else key[0]
        index = (slice(i * per, (i + 1) * per),)
        if time_axis:
            n = data.shape[1]
            index += (slice(key[1] * n, (key[1] + 1) * n),)
        index += (slice(None),) * (data.dim() - len(index))
        shards.append(Shard(index, data))
    return shards


@functools.lru_cache(maxsize=None)
def _taps(design: RrcDesign, device: str) -> torch.Tensor:
    return design.taps_tensor(torch.device(device))


@functools.lru_cache(maxsize=None)
def sync_patterns(spec: Protocol, device: str) -> tuple:
    """The protocol's sync patterns, one uint8 tensor a sync, on one
    device, made once."""
    return tuple(torch.as_tensor(s.pattern, dtype=torch.uint8,
                                 device=torch.device(device))
                 for s in spec.syncs)


@functools.lru_cache(maxsize=None)
def device_tables(tables_type: type, device: str):
    """A protocol's decode tables (its record's ``tables``) on one device,
    built once."""
    return tables_type.build(torch.device(device))


def filter_with_halo(x: torch.Tensor, left: torch.Tensor,
                     design: RrcDesign) -> torch.Tensor:
    """The overlap-save RRC of a block whose history is its left halo
    (kernel K4 on the card)."""
    y, _ = rrc_filter_block(x, RrcState(left), design,
                            taps=_taps(design, str(x.device)))
    return y


def _blocks(mesh: Mesh, samples, design: RrcDesign | None):
    """Each local slot's ``[rows, T/n_time]`` block of the ``[C, T]``
    samples on its device, overlap-save filtered with its left halo when
    ``design`` is given (K4 once a device); and the global shape."""
    shape = tuple(samples.shape)
    C, T = shape
    n_t = mesh.shape["time"]
    if T % n_t:
        raise ValueError(f"{T} samples not divisible by {n_t} time shards")
    seg = T // n_t
    bounds = row_bounds(mesh, C)
    x = local_blocks(mesh, samples, seg, bounds)
    if design is None:
        return x, shape
    halo = design.ntaps - 1
    if seg < halo:
        raise ValueError(f"time shards of {seg} samples are shorter than "
                         f"the {halo}-sample halo")
    left = halo_from_left(mesh, x, halo, bounds)
    return per_device(mesh, list(x), lambda xx, ll: filter_with_halo(
        xx, ll, design), x, left), shape


def sharded_rrc_filter(mesh: Mesh, samples,
                       design: RrcDesign = WIDE_RRC):
    """Overlap-save RRC over a (channel, time)-sharded sample block.

    samples: [C, T] float32 (C divisible by channel shards, T by time
    shards; across processes this process's :class:`LocalRows`). Output
    matches the single-device streaming filter run from zeroed state: the
    halo exchange provides exactly the ``taps-1`` cross-shard history."""
    return assemble(mesh, *_blocks(mesh, samples, design))


def _frames(symbols: torch.Tensor, spec: Protocol) -> torch.Tensor:
    """The block's aligned frames, each with the symbols past its end that
    its fields read: a [C, n, frame_size + lookahead] view (n may be 0)."""
    size = spec.frame_size
    n = max(0, (symbols.shape[1] - spec.lookahead) // size)
    row, col = symbols.stride()
    return symbols.as_strided((symbols.shape[0], n, size + spec.lookahead),
                              (row, size * col, col),
                              symbols.storage_offset())


def _bulk(mesh: Mesh, samples, design, local_fn):
    """The bulk-mode frame of every sharded step: each local slot's block
    (filtered when ``design`` is given), then ``local_fn(block) -> (blocks
    tree, hits [rows])`` batched per device; hits summed over time.
    Returns (output blocks by slot, hits by row, the global shape)."""
    y, shape = _blocks(mesh, samples, design)
    out = per_device(mesh, list(y), local_fn, y)
    blocks = {k: v[0] for k, v in out.items()}
    hits = psum_time(mesh, {k: v[1] for k, v in out.items()})
    return blocks, hits, shape


def sharded_pipeline_step(mesh: Mesh, samples, sps: int | None = None,
                          n_centuries: int = 2):
    """One multi-device DMR pipeline step.

    Axes in play: channel-DP for every stage; time-SP: the RRC FIR (K4)
    runs overlap-save with the halo hop; the demod (K3, from a fresh state
    per time shard: bulk/recorded mode) and the frame decode run per time
    shard, and the per-channel sync hits are summed over the time axis.

    samples: [C, T]; per time shard T_local must cover n_centuries
    centuries + lookahead: T_local >= n_centuries*(100*sps+1)+1.
    Returns (voice_payload [C, F_total, 27], sync_hits [C])."""
    sps = DMR.sps if sps is None else sps

    def local(y):
        dev = str(y.device)
        dibits, _ = gfsk_demod_block(y, demod_init(y.shape[0], y.device),
                                     n_centuries, sps)
        sync_dist = DMR.correlate(dibits, sync_patterns(DMR, dev)[0])
        fields = DMR.decode(_frames(dibits, DMR),
                            device_tables(DMR.tables, dev))
        # the JAX package's count: positions where any pattern is within 3
        hits = (sync_dist <= 3).any(-1).sum(-1, dtype=torch.int32)
        return fields["voice_payload"], hits

    blocks, hits, shape = _bulk(mesh, samples, DMR.design, local)
    return (assemble(mesh, blocks, shape),
            assemble(mesh, hits, shape, time_axis=False))


# the field of its frame decode that sharded_fsk_step returns (the JAX
# package's choice)
_FSK_STEP_FIELD = {"dstar": "voice", "pocsag": "ok"}


def sharded_fsk_step(mesh: Mesh, samples, protocol: str = "dstar",
                     n_centuries: int = 2):
    """Multi-device step for the bit-domain (2FSK) protocols.

    Same axis roles as :func:`sharded_pipeline_step` but no RRC stage
    (D-Star/POCSAG front ends feed the slicer directly).

    protocol "dstar": 10 sps; returns per-96-bit-frame voice bytes
    [C, F, 9] (LSB-first packed) and summed voice/header-sync hit counts
    [C]. protocol "pocsag": 40 sps inverted; returns per-32-bit-window BCH
    ok flags [C, W] and summed preamble hit counts [C]. A hit is a
    position where a sync is within its gate bound."""
    if protocol not in _FSK_STEP_FIELD:
        raise ValueError(
            f"unknown 2FSK protocol {protocol!r} (dstar or pocsag)")
    spec, field = protocol_named(protocol), _FSK_STEP_FIELD[protocol]

    def local(x):
        dev = str(x.device)
        bits, _ = fsk_demod_block(x, demod_init(x.shape[0], x.device),
                                  n_centuries, spec.sps, spec.invert)
        hit = None
        for s, pattern in zip(spec.syncs, sync_patterns(spec, dev)):
            h = spec.correlate(bits, pattern) <= s.bound
            hit = h if hit is None else hit | h
        fields = spec.decode(_frames(bits, spec),
                             device_tables(spec.tables, dev))
        return fields[field], hit.sum(-1, dtype=torch.int32)

    blocks, hits, shape = _bulk(mesh, samples, None, local)
    return (assemble(mesh, blocks, shape),
            assemble(mesh, hits, shape, time_axis=False))


def sharded_gfsk_step(mesh: Mesh, samples, protocol: str = "dmr",
                      n_centuries: int = 2):
    """Generalized multi-device 4FSK pipeline step: DMR, YSF, or NXDN.

    Same mesh pattern as :func:`sharded_pipeline_step` (which remains the
    DMR-specific entry point): channel-DP everywhere, overlap-save RRC
    with the halo hop over the time axis (NXDN exchanges the narrow
    design's 160-sample halo), per-shard demod + batched frame-field
    decode (K5 once for the YSF and NXDN fields of every slot on a
    device), sync statistics summed over time.

    samples: [C, T] float32. Returns (fields dict with [C, F_total, ...]
    tensors, sync_hits [C])."""
    spec = protocol_named(protocol)
    if spec.kind != "gfsk":
        raise ValueError(f"unknown 4FSK protocol {protocol!r}")

    def local(y):
        dev = str(y.device)
        dibits, _ = gfsk_demod_block(y, demod_init(y.shape[0], y.device),
                                     n_centuries, spec.sps)
        # the JAX package's count: every (position, pattern) within 3
        hit = spec.correlate(dibits, sync_patterns(spec, dev)[0]) <= 3
        fields = spec.decode(_frames(dibits, spec),
                             device_tables(spec.tables, dev))
        return fields, hit.reshape(hit.shape[0], -1).sum(
            -1, dtype=torch.int32)

    blocks, hits, shape = _bulk(mesh, samples, spec.design, local)
    keys = next(iter(blocks.values())).keys()
    fields = {k: assemble(mesh, {s: b[k] for s, b in blocks.items()}, shape)
              for k in keys}
    return fields, assemble(mesh, hits, shape, time_axis=False)
