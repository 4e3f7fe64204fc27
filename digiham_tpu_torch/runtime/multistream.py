"""Multi-process channel-bank driver (port of
``digiham_tpu/runtime/multistream.py``).

``MultiStreamBank`` shards one bank's channels over N worker processes,
each owning ``channels/n_procs`` channels with its whole stack (a
``TrackedChannelBank`` on its own device), outputs multiplexed back to the
caller. Every bank of the port is host-bound (its Python machines, its
fetches), so per-channel host work splits over the processes while their
device steps overlap on the card.

Reference anchor: the reference already scales by OS process — one
process per decoder *stage* wired with pipes (reference
examples/dmr-decoder.sh:13-29). This driver is the same operational idea
rotated 90°: one process per CHANNEL SHARD, each running the whole stack.

Semantics: byte-identical to one big TrackedChannelBank — channels are
independent (pure DP), so sharding them across processes changes nothing.
snapshot() / restore() compose the per-worker blobs, preserving the
mid-stream checkpoint contract (runtime/checkpoint.py) across the process
fan-out; restore_jax() takes the JAX package's composite the same way.

Workers start from the ``spawn`` context (CUDA cannot cross a ``fork``),
build their bank on ``device`` (``None`` is the card, resolved inside the
worker) and answer once they are ready. A worker that finds no card, or
whose kernel fails to build or launch, exits; the parent raises
:class:`WorkerDied` with the worker's error text, and never goes on on
another device. What crosses the pipes is bytes and numpy, so the parent
never initializes CUDA.

Not marshalled across workers: per-channel metadata *writers* (file
handles / fifos are process-local). Attach writers on the worker side via
``worker_init``; ``bank.first_channel`` there is the global id of the
worker's channel 0. Payload bytes and which-channel attribution flow back
to the parent.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np

from ..pipeline import protocol_named

_CLOSE_TIMEOUT = 30.0


class WorkerDied(RuntimeError):
    """A MultiStreamBank worker process exited. ``worker`` is its index,
    ``error`` the traceback it sent before exiting, if any.

    Raised to the caller in fail-stop mode (the default); consumed
    internally by the supervisor in ``supervise=True`` mode."""

    def __init__(self, worker: int, pid, exitcode, error: str | None = None):
        self.worker = worker
        self.error = error
        message = (f"MultiStreamBank worker {worker} (pid {pid}) died "
                   f"with exitcode {exitcode}")
        super().__init__(message + (f":\n{error}" if error else ""))


def _build_bank(protocol: str, channels: int, pipeline_kwargs: dict,
                slot_filter: int, on_output, device):
    """Build a TrackedChannelBank for `protocol` (worker-side)."""
    from .. import resolve_device
    from .tracked_bank import ADAPTERS, TrackedChannelBank

    device = resolve_device(device)
    pipe = protocol_named(protocol).pipeline(channels, device=device,
                                             **(pipeline_kwargs or {}))
    return TrackedChannelBank(pipe, on_output=on_output,
                              slot_filter=slot_filter,
                              adapter=ADAPTERS[protocol](), device=device)


def _worker(conn, first_channel, protocol, channels, pipeline_kwargs,
            slot_filter, worker_init, device):
    """Worker process body: one bank shard, an RPC loop. Every reply is
    ("ok", payload) or, before the worker exits with code 1,
    ("error", traceback)."""
    outputs = []
    try:
        import torch

        bank = _build_bank(protocol, channels, pipeline_kwargs, slot_filter,
                           lambda c, d: outputs.append((c, bytes(d))),
                           device)
        bank.first_channel = first_channel
        if worker_init is not None:
            worker_init(bank)
        conn.send(("ok", {"pid": os.getpid(), "device": str(bank.device),
                          "threads": torch.get_num_threads()}))
        while True:
            msg = conn.recv()
            op = msg[0]
            reply = None
            if op == "push":
                bank.push(msg[1])
                reply, outputs[:] = list(outputs), []
            elif op == "flush":
                bank.flush()
                reply, outputs[:] = list(outputs), []
            elif op == "snapshot":
                reply = bank.snapshot()
            elif op == "restore":
                bank.restore(msg[1])
            elif op == "restore_jax":
                bank.restore_jax(msg[1])
            conn.send(("ok", reply))
            if op == "close":
                return
    except (EOFError, KeyboardInterrupt):
        return
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1)


class MultiStreamBank:
    """N-process sharded TrackedChannelBank (see module docstring).

    protocol: one of dmr/ysf/nxdn/dstar/pocsag.
    channels: total channel count; must divide by n_procs.
    n_procs: worker process count.
    on_output(channel, payload): called in the parent with GLOBAL channel
        ids, in worker order then emission order (per-channel ordering is
        preserved; cross-channel ordering between shards is not defined,
        matching the reference's independent per-channel processes).
    pipeline_kwargs: forwarded to the protocol pipeline per shard
        (e.g. n_centuries).
    worker_init(bank): optional callable run once in each worker after
        bank construction (attach meta writers, warm caches); must be
        picklable (module-level function). ``bank.first_channel`` is the
        global id of the worker's channel 0.
    supervise: False (default) = fail-stop — a dead worker raises
        WorkerDied and the bank is unusable (the reference's semantics:
        a dead pipeline stage kills the shell pipeline). True = elastic:
        a dead worker is respawned, restored from the last parent-held
        composite snapshot, and the sample blocks pushed since are
        replayed with already-emitted bytes suppressed — the caller's
        output stream stays byte-identical.
    replay_limit: supervised mode re-snapshots every this-many pushes,
        bounding both parent memory and respawn replay cost.
    device: where every worker's pipeline and bank run; ``None`` is the
        card, resolved in each worker (the CPU tests pass ``"cpu"``).

    ``start_seconds[w]``: worker w's start, from spawn to its first reply;
    ``worker_info[w]``: its pid, device and torch thread count.
    """

    def __init__(self, protocol: str = "dmr", channels: int = 256,
                 n_procs: int = 4, on_output=None, slot_filter: int = 3,
                 pipeline_kwargs: dict | None = None, worker_init=None,
                 supervise: bool = False, replay_limit: int = 8,
                 device=None):
        protocol_named(protocol)  # raises for an unknown one
        if channels % n_procs:
            raise ValueError(
                f"{channels} channels not divisible by {n_procs} workers")
        self.protocol = protocol
        self.channels = channels
        self.n_procs = n_procs
        self.on_output = on_output
        self._per = channels // n_procs
        # a device name, never a torch.device: the parent touches no CUDA
        self.device = None if device is None else str(device)
        self._spawn_args = (protocol, self._per, pipeline_kwargs,
                            slot_filter, worker_init, self.device)
        self._ctx = mp.get_context("spawn")  # CUDA cannot cross a fork
        self._conns = [None] * n_procs
        self._procs = [None] * n_procs
        self._started = [0.0] * n_procs
        self.start_seconds = [None] * n_procs
        self.worker_info = [None] * n_procs
        try:
            for w in range(n_procs):  # all start at once
                self._spawn(w)
            for w in range(n_procs):
                self._ready(w)
        except BaseException:
            self._terminate()
            raise
        # -- supervision (opt-in elastic recovery; fail-stop otherwise) --
        # Parent-held recovery state: the last composite snapshot's
        # per-worker shards, the sample blocks pushed since, and how many
        # output bytes each channel already emitted since that snapshot
        # (replay after a respawn re-produces those bytes; the counters
        # suppress them so the caller-visible stream stays byte-identical).
        self.supervise = supervise
        self.replay_limit = replay_limit
        self._base_shards = None
        self._replay = []
        self._emitted = [[0] * self._per for _ in range(n_procs)]
        if supervise:
            self._base_shards = self._snapshot_shards()

    def _spawn(self, w: int) -> None:
        """(Re)start worker w; replaces its pipe + process slot."""
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker, args=(child, w * self._per, *self._spawn_args),
            daemon=True)
        self._started[w] = time.perf_counter()
        p.start()
        child.close()
        if self._conns[w] is not None:
            try:
                self._conns[w].close()
            except OSError:
                pass
        self._conns[w] = parent
        self._procs[w] = p

    def _ready(self, w: int) -> None:
        """Wait for worker w's first reply: its bank is built."""
        self.worker_info[w] = self._recv(w)
        self.start_seconds[w] = time.perf_counter() - self._started[w]

    # -- core ------------------------------------------------------------
    def _send(self, w, msg):
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError) as e:
            raise self._died(w) from e

    def _died(self, w, error=None) -> WorkerDied:
        proc = self._procs[w]
        proc.join(timeout=_CLOSE_TIMEOUT)
        return WorkerDied(w, proc.pid, proc.exitcode, error)

    def _recv(self, w):
        """recv from worker w, failing loudly if it died (a bare recv
        would block forever on a crashed worker's half-open pipe); a
        worker's error reply raises with its traceback."""
        conn, proc = self._conns[w], self._procs[w]
        while not conn.poll(1.0):
            if not proc.is_alive() and not conn.poll(0):
                raise self._died(w)
        try:
            status, payload = conn.recv()
        except (EOFError, ConnectionResetError, OSError):
            raise self._died(w) from None
        if status == "error":
            raise self._died(w, payload)
        return payload

    def _emit(self, w, outs):
        """Dispatch one worker's outputs with global channel ids,
        keeping the since-snapshot byte accounting current."""
        for local_ch, payload in outs:
            self._emitted[w][local_ch] += len(payload)
            if self.on_output is not None:
                self.on_output(w * self._per + local_ch, payload)

    def _shard_msg(self, msg, w):
        """Per-worker view of a broadcast message (push carries the full
        [channels, L] block; each worker gets only its channel rows)."""
        if msg[0] == "push":
            return ("push", msg[1][w * self._per:(w + 1) * self._per])
        return msg

    def _roundtrip(self, msg) -> None:
        """Send msg to every worker, then gather — the supervised path
        recovers any worker that dies at either end; fail-stop re-raises."""
        dead = []
        for w in range(self.n_procs):
            try:
                self._send(w, self._shard_msg(msg, w))
            except WorkerDied:
                if not self.supervise:
                    raise
                dead.append(w)
        for w in range(self.n_procs):
            if w in dead:
                continue
            try:
                self._emit(w, self._recv(w))
            except WorkerDied:
                if not self.supervise:
                    raise
                dead.append(w)
        for w in dead:
            self._recover(w, tail_msg=msg if msg[0] == "flush" else None)

    def push(self, samples: np.ndarray) -> None:
        """Feed [channels, L] float samples; all shards run CONCURRENTLY
        (this is the overlap the driver exists for)."""
        samples = np.asarray(samples)
        if samples.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} rows, got {samples.shape[0]}")
        if self.supervise:
            if len(self._replay) >= self.replay_limit:
                self._rebase()
            self._replay.append(samples)
        self._roundtrip(("push", samples))

    def flush(self) -> None:
        self._roundtrip(("flush",))

    def prewarm(self, block: int = 16384) -> None:
        """Absorb the first-execution costs (kernel builds and loads, the
        caching allocator's first blocks) at startup instead of on the
        first real push: push one silence block of the production size
        through every worker, then roll the bank back to its pre-push
        state. Invisible to the caller: outputs from the dummy block are
        suppressed and the snapshot/restore round-trip makes the state
        change un-happen."""
        snap = self.snapshot()
        saved, self.on_output = self.on_output, None
        try:
            self.push(np.zeros((self.channels, int(block)), np.float32))
        finally:
            self.on_output = saved
            self.restore(snap)

    # -- supervision --------------------------------------------------------
    def _snapshot_shards(self) -> list:
        """One shard blob per worker. Supervised mode is fault-aware: a
        worker dying mid-snapshot is recovered (replaying the current
        buffer) and re-asked, PER WORKER — naive retry would re-send the
        snapshot request to healthy workers whose replies are already
        queued, desyncing the pipe protocol."""
        if not self.supervise:
            for w in range(self.n_procs):
                self._send(w, ("snapshot",))
            return [self._recv(w) for w in range(self.n_procs)]
        shards = [None] * self.n_procs
        dead = []
        for w in range(self.n_procs):
            try:
                self._send(w, ("snapshot",))
            except WorkerDied:
                dead.append(w)
        for w in range(self.n_procs):
            if w in dead:
                continue
            try:
                shards[w] = self._recv(w)
            except WorkerDied:
                dead.append(w)
        for w in dead:
            self._recover(w)  # replay brings it to the current position
            self._send(w, ("snapshot",))
            shards[w] = self._recv(w)
        return shards

    def _rebase(self) -> None:
        """Fold the replay buffer into a fresh composite snapshot (bounds
        parent memory and respawn replay cost to ``replay_limit`` blocks)."""
        self._base_shards = self._snapshot_shards()
        self._replay = []
        self._emitted = [[0] * self._per for _ in range(self.n_procs)]

    def _recover(self, w: int, tail_msg=None) -> None:
        """Supervised respawn: restart worker w, restore its shard from
        the last composite snapshot, replay every sample block pushed
        since, and re-emit only the output bytes the caller has not seen.

        tail_msg: a non-push message (flush) the worker died on; re-sent
        after the replay brings its state back to the pre-flush point.

        Caveat: worker-side meta writers attached via ``worker_init`` see
        replayed blocks again; supervision is designed for payload-output
        deployments (or idempotent writers)."""
        lo, hi = w * self._per, (w + 1) * self._per
        self._spawn(w)
        self._ready(w)
        self._send(w, ("restore", self._base_shards[w]))
        self._recv(w)
        emitted = self._emitted[w]
        seen = [0] * self._per
        for block in self._replay:
            self._send(w, ("push", np.asarray(block)[lo:hi]))
            for local_ch, payload in self._recv(w):
                start = seen[local_ch]
                end = start + len(payload)
                seen[local_ch] = end
                if end > emitted[local_ch]:
                    fresh = payload[max(0, emitted[local_ch] - start):]
                    emitted[local_ch] = end
                    if self.on_output is not None:
                        self.on_output(lo + local_ch, fresh)
        if tail_msg is not None:
            self._send(w, tail_msg)
            self._emit(w, self._recv(w))

    # -- checkpoint contract ----------------------------------------------
    def snapshot(self) -> bytes:
        """Composite mid-stream checkpoint: one blob per worker shard."""
        return pickle.dumps({
            "protocol": self.protocol,
            "channels": self.channels,
            "n_procs": self.n_procs,
            "shards": self._snapshot_shards(),
        })

    def _check_header(self, d: dict) -> None:
        if (d.get("protocol", self.protocol), d["channels"],
                d["n_procs"]) != (self.protocol, self.channels,
                                  self.n_procs):
            raise ValueError(
                f"snapshot is {d.get('protocol')}/{d['channels']}ch/"
                f"{d['n_procs']}proc, bank is {self.protocol}/"
                f"{self.channels}ch/{self.n_procs}proc")

    def _restore_shards(self, op: str, shards: list) -> None:
        for w, shard in enumerate(shards):
            self._send(w, (op, shard))
        for w in range(self.n_procs):
            self._recv(w)

    def restore(self, blob: bytes) -> None:
        d = pickle.loads(blob)
        self._check_header(d)
        self._restore_shards("restore", d["shards"])
        if self.supervise:  # the restored state is the new recovery base
            self._base_shards = list(d["shards"])
            self._replay = []
            self._emitted = [[0] * self._per for _ in range(self.n_procs)]

    def restore_jax(self, blob: bytes) -> None:
        """Take the JAX package's ``MultiStreamBank.snapshot()`` shard by
        shard: each worker takes its JAX shard's pipeline state and pending
        samples (``TrackedChannelBank.restore_jax``; its host machines stay
        its own). In supervised mode the recovery base becomes the port's
        snapshot of the result."""
        from ..convert import multistream_shards_from_jax

        d = multistream_shards_from_jax(blob)
        self._check_header(d)
        self._restore_shards("restore_jax", d["shards"])
        if self.supervise:
            self._rebase()

    # -- lifecycle ---------------------------------------------------------
    def _terminate(self) -> None:
        for p in self._procs:
            if p is not None and p.is_alive():
                p.terminate()
        for p in self._procs:
            if p is not None:
                p.join(timeout=_CLOSE_TIMEOUT)
        for conn in self._conns:
            if conn is not None:
                conn.close()

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for conn in self._conns:
            try:
                if conn.poll(_CLOSE_TIMEOUT):
                    conn.recv()
            except (EOFError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=_CLOSE_TIMEOUT)
        self._terminate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
