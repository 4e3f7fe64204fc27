"""Serving example, PyTorch/CUDA port: MultiStreamBank, N worker processes,
each owning a channel shard with its own TrackedChannelBank on the device.
The counterpart of examples/multistream_bank.py.

The sharded bank is byte-identical to one TrackedChannelBank (channels are
independent), and snapshot()/restore() compose per-worker blobs so
mid-stream checkpointing still works. The traffic is the package's DMR bank
fixture (``digiham_tpu_torch/data/dmr_bank_smoke.npz``), its stream
variants tiled over the channels; every channel's voice bytes are held to
the JAX package's bank on the same audio.

Usage (from the repo root, the package importable: PYTHONPATH=. or
installed):
       python examples/torch_multistream_bank.py [channels] [n_procs]
                                                 [--device DEVICE]
       (the device defaults to the card; each worker takes it)
"""
import argparse
import sys
import time

import numpy as np

from digiham_tpu_torch import smoke


def main(channels: int = 8, n_procs: int = 2, device=None) -> int:
    from digiham_tpu_torch.runtime.multistream import MultiStreamBank

    fx = smoke.load(smoke.DMR_BANK)
    variant = np.arange(channels) % fx["tx_dibits"].shape[0]
    samples = np.ascontiguousarray(
        smoke.bank_audio(smoke.DMR_BANK, fx)[variant])
    want = [smoke.bank_expected(fx, v)[0] for v in variant]

    decoded = {c: b"" for c in range(channels)}
    t0 = time.perf_counter()
    with MultiStreamBank("dmr", channels=channels, n_procs=n_procs,
                         on_output=lambda c, d: decoded.__setitem__(
                             c, decoded[c] + d),
                         pipeline_kwargs={"n_centuries": 2},
                         device=device) as bank:
        # mid-stream checkpoint: the composite blob restores into a fresh
        # bank of the same topology (another one is refused)
        half = samples.shape[1] // 2 // 8192 * 8192
        for lo in range(0, half, 8192):
            bank.push(samples[:, lo:lo + 8192])
        blob = bank.snapshot()
        print(f"checkpoint: {len(blob)} bytes across {n_procs} shards")
        for lo in range(half, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
        bank.flush()
    wall = time.perf_counter() - t0

    ok = sum(decoded[c] == want[c] for c in range(channels))
    print(f"{ok}/{channels} channels decoded the JAX bank's voice bytes "
          f"({n_procs} worker processes, {wall:.1f}s wall)")
    return 0 if ok == channels else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("channels", nargs="?", type=int, default=8)
    ap.add_argument("n_procs", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    sys.exit(main(a.channels, a.n_procs, a.device))
