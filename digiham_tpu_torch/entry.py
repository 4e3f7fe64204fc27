"""Entry points: one step of the flagship pipeline, a dry run over n
devices.

- :func:`entry` returns ``(fn, args)``: one step of the batched DMR
  pipeline (RRC FIR and century demod, kernel K2 on the card; dense sync
  correlation; the per-frame FEC field decode) over a small bank of FM
  audio channels, ``fn(*args)`` running it.
- :func:`dryrun_multichip` runs one of each scale-out path over a
  (channel, time) mesh of n devices: the bulk DMR step with its halo hop
  and time sum, the exact time-sharded DMR stream, the NXDN and POCSAG bulk
  steps (the narrow RRC's 160-sample halo; the 2FSK demod), a tracked bank
  sharded over the channel axis, and the time-sharded tracked bank with a
  snapshot restored into a fresh one mid-stream.

Both run on the card unless a device is named (``device="cpu"``); where
fewer cards than n exist, the mesh names the cards several times.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def entry(device=None):
    """(fn, (samples, state)): one ``DmrPipeline.step`` of 8 channels at
    sps 10 over 2 centuries, on seeded Gaussian FM audio."""
    from .pipeline import DmrPipeline

    dev = resolve_device(device)
    channels, sps, n_cent = 8, 10, 2
    pipe = DmrPipeline(channels=channels, sps=sps, n_centuries=n_cent,
                       device=dev)
    state = pipe.init_state()
    length = n_cent * (100 * sps + 1) + 8
    rng = np.random.default_rng(0)
    samples = torch.as_tensor(
        rng.normal(0, 100, (channels, length)).astype(np.float32),
        device=dev)

    def fn(samples, state):
        return pipe.step(samples, state)

    return fn, (samples, state)


def mesh_devices(n_devices: int, device=None) -> list:
    """n devices for a mesh: ``device`` n times when one is named, else the
    cards in turn (one card named n times on a one-card machine)."""
    if device is not None:
        return [torch.device(device)] * n_devices
    resolve_device(None)  # raises without a card
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of every scale-out path over an n-device (channel, time)
    mesh (2 time shards when n is even, so the halo hops and the time sum
    run); raises on a result of the wrong shape."""
    from .parallel import (TimeShardedDmrPipeline, TimeShardedDmrStream,
                           make_mesh, sharded_fsk_step, sharded_gfsk_step,
                           sharded_pipeline_step)
    from .parallel.streaming import TimeShardedPipeline
    from .pipeline import DmrPipeline
    from .runtime.tracked_bank import (TimeShardedTrackedBank,
                                       TrackedChannelBank)

    devices = mesh_devices(n_devices, device)
    bank_device = devices[0].type  # the banks' host machines follow it
    if n_devices % 2 == 0 and n_devices > 1:
        ch_shards, t_shards = n_devices // 2, 2
    else:
        ch_shards, t_shards = n_devices, 1
    mesh = make_mesh(ch_shards, t_shards, devices=devices)

    def noise(seed, shape):
        return np.random.default_rng(seed).normal(0, 100, shape).astype(
            np.float32)

    sps, n_cent = 10, 1
    t_local = n_cent * (100 * sps + 1) + 4
    C = ch_shards * 2
    voice, hits = sharded_pipeline_step(
        mesh, noise(0, (C, t_shards * t_local)), sps, n_cent)
    _check(voice.shape[0] == C and voice.shape[-1] == 27,
           f"voice payload of shape {tuple(voice.shape)}")
    _check(tuple(hits.shape) == (C,), f"hits of shape {tuple(hits.shape)}")

    # the streaming carry chain: the demod state hops the time shards
    sp = TimeShardedDmrPipeline(mesh, channels=C, sps=10,
                                centuries_per_shard=36)
    outs = TimeShardedDmrStream(sp).push(
        noise(1, (C, sp.block_len + sp.h_left + sp.h_right)))
    _check(len(outs) == 1, f"{len(outs)} time-sharded steps, want 1")
    _check(tuple(outs[0]["dibits"].shape) == (C, sp.symbols_per_block),
           f"time-sharded dibits of shape {tuple(outs[0]['dibits'].shape)}")

    # NXDN: the narrow RRC's 160-sample halo
    nx_sps, nx_cent = 20, 1
    nx_local = nx_cent * (100 * nx_sps + 1) + 4
    _, nx_hits = sharded_gfsk_step(mesh, noise(2, (C, t_shards * nx_local)),
                                   protocol="nxdn", n_centuries=nx_cent)
    _check(tuple(nx_hits.shape) == (C,), "NXDN hits")

    # POCSAG: the bit-domain step (inverted 2FSK, no RRC)
    po_sps, po_cent = 40, 1
    po_local = po_cent * (100 * po_sps + 1) + 4
    _, po_hits = sharded_fsk_step(mesh, noise(4, (C, t_shards * po_local)),
                                  protocol="pocsag", n_centuries=po_cent)
    _check(tuple(po_hits.shape) == (C,), "POCSAG hits")

    # a tracked bank sharded over the channel axis
    bank_mesh = make_mesh(n_devices, 1, devices=devices)
    Cb = n_devices * 2
    bank = TrackedChannelBank(
        DmrPipeline(channels=Cb, sps=10, n_centuries=1, device=devices[0]),
        on_output=lambda c, d: None, mesh=bank_mesh, device=bank_device)
    bank.push(noise(3, (Cb, 2 * (100 * 10 + 1) + 8)))
    _check(tuple(bank.state.demod.pos.shape) == (Cb,), "mesh bank state")

    # the time-sharded tracked bank, snapshot and restore mid-stream
    def timesharded():
        return TimeShardedTrackedBank(
            TimeShardedPipeline(mesh, channels=C, protocol="dmr",
                                centuries_per_shard=36),
            on_output=lambda c, d: None, device=bank_device)

    first = timesharded()
    block = first.pipeline
    first.push(noise(5, (C, block.block_len + block.h_left + block.h_right)))
    second = timesharded()
    second.restore(first.snapshot())
    second.push(noise(6, (C, block.block_len)))
    _check(tuple(second.state.pos.shape) == (C,), "time-sharded bank state")
