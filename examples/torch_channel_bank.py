"""Many-channel decoding example, PyTorch/CUDA port: a protocol bank on one
card, production topology: device pipeline (filter + demod + batched
frame-field decode) feeding host trackers that do control flow only. Works
for all five protocols. The counterpart of examples/channel_bank.py.

The traffic is the package's bank fixture of the protocol
(``digiham_tpu_torch/data/<protocol>_bank_smoke.npz``: calls or pages with
their metadata, symbol errors, an idle channel), its stream variants tiled
over the channels and turned into FM audio; the JAX package's bank decoded
the same audio into the bytes the fixture keeps, which the run is held to
when it pushes the whole stream.

Usage (from the repo root, the package importable: PYTHONPATH=. or
installed):
       python examples/torch_channel_bank.py [protocol] [channels] [steps]
                                             [--device DEVICE]
       protocol in {dmr, ysf, nxdn, dstar, pocsag} (default dmr); about
       steps x 400 symbols a channel (the whole fixture stream at most); the
       device defaults to the card
"""
import argparse

import numpy as np

from digiham_tpu_torch import resolve_device, smoke
from digiham_tpu_torch.pipeline import PROTOCOLS
from digiham_tpu_torch.runtime import tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.runtime.metrics import TRACER

# protocol -> (bank fixture, centuries a step: the JAX example's geometry);
# the pipeline and the adapter are the protocol's own
BANKS = {
    "dmr": (smoke.DMR_BANK, 4),
    "ysf": (smoke.YSF_BANK, 10),
    "nxdn": (smoke.NXDN_BANK, 4),
    "dstar": (smoke.DSTAR_BANK, 4),
    "pocsag": (smoke.POCSAG_BANK, 4),
}


def main(protocol: str = "dmr", channels: int = 32, steps: int = 8,
         device=None) -> int:
    if protocol not in BANKS:
        raise SystemExit(f"unknown protocol {protocol!r}")
    device = resolve_device(device)
    stream, n_centuries = BANKS[protocol]
    fx = smoke.load(stream)
    variant = np.arange(channels) % fx["tx_dibits"].shape[0]
    audio = smoke.bank_audio(stream, fx)[variant]
    n = min(audio.shape[1], (steps * 400 + 200) * stream.sps)
    samples = np.ascontiguousarray(audio[:, :n])

    pipe = PROTOCOLS[protocol].pipeline(channels, n_centuries=n_centuries,
                                        device=device)
    voice = [b""] * channels
    events = [[] for _ in range(channels)]

    def on_output(c, data):
        voice[c] += data

    bank = tracked_bank.TrackedChannelBank(
        pipe, on_output=on_output,
        adapter=tracked_bank.ADAPTERS[protocol](), device=device)
    for c in range(channels):
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events[c]: ev.append(b.decode())))
    chunk = 4096
    with smoke.function_bits(fx):
        for lo in range(0, n, chunk):
            bank.push(samples[:, lo:lo + chunk])
        bank.flush()
    TRACER.report()  # the bank's counters, one JSON line on stderr
    decoded = sum(len(v) for v in voice)
    line = (f"[{protocol}] decoded {decoded} payload bytes across "
            f"{channels} channels on {device}")
    if n == audio.shape[1]:  # the whole stream: the JAX bank's output
        want = [smoke.bank_expected(fx, v) for v in variant]
        same = sum((voice[c], "".join(events[c])) == want[c]
                   for c in range(channels))
        line += f"; {same}/{channels} channels equal the JAX bank's output"
    print(line)
    return decoded


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("protocol", nargs="?", default="dmr")
    ap.add_argument("channels", nargs="?", type=int, default=32)
    ap.add_argument("steps", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(a.protocol, a.channels, a.steps, a.device)
