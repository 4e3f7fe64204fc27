"""End-to-end demo, PyTorch/CUDA port: raw IQ file -> DMR decode -> AMBE
frames (+ PCM when a codecserver is reachable) + metadata events. The
counterpart of examples/iq_to_audio.py; the PCM goes through the
digital-voice post-filter (kernel K6 on the card), as the dmr-decoder.sh
chain's digitalvoice_filter stage does.

Usage (from the repo root, the package importable: PYTHONPATH=. or
installed):
  python examples/torch_iq_to_audio.py <iq_file.cf32> [--meta meta.txt]
                                       [--ambe out.ambe]
                                       [--codecserver PATH]
                                       [--device DEVICE]

With no IQ file, it modulates a demo DMR transmission: the call of the
package's DMR bank fixture with the most voice. The device defaults to the
card.
"""
import argparse
import sys

import numpy as np
import torch

from digiham_tpu_torch import resolve_device, smoke
from digiham_tpu_torch.dsp import RrcState, WIDE_RRC, fm_discriminator, \
    rrc_filter
from digiham_tpu_torch.dsp.demod import demod_init, gfsk_demod_block
from digiham_tpu_torch.protocols.dmr import make_decoder
from digiham_tpu_torch.runtime.meta import FileMetaWriter, PipelineMetaWriter


def synth_demo_iq():
    """Clean 4FSK I/Q of the DMR bank fixture's longest call, 10 samples a
    symbol at 1944 Hz a level, as examples/iq_to_audio.py modulates."""
    fx = smoke.load(smoke.DMR_BANK)
    variant = int(np.diff(fx["voice_offsets"]).argmax())
    dibits = fx["tx_dibits"][variant]
    levels = np.asarray(smoke.LEVELS)
    freq = np.repeat(levels[dibits], 10) * 1944.0
    phase = 2 * np.pi * np.cumsum(freq) / 48000.0
    return np.exp(1j * phase).astype(np.complex64)


def decode(iq: np.ndarray, device) -> np.ndarray:
    """[n] complex64 I/Q -> the DMR dibits of one channel (numpy)."""
    re = torch.as_tensor(iq.real[None].copy(), device=device)
    im = torch.as_tensor(iq.imag[None].copy(), device=device)
    one = torch.ones(1, device=device)
    audio, _ = fm_discriminator(re, im, one, torch.zeros_like(one))
    filtered, _ = rrc_filter(audio * 5000,
                             RrcState.init(1, WIDE_RRC, device), WIDE_RRC)
    n_cent = (filtered.shape[1] // 10 - 2) // 100
    dibits, _ = gfsk_demod_block(filtered, demod_init(1, device), n_cent, 10)
    return dibits[0].cpu().numpy()


def synthesize(voice: bytes, path: str, device) -> bytes:
    """The voice frames through a codecserver at ``path``, the PCM through
    the digital-voice post-filter on ``device``: s16le bytes."""
    from digiham_tpu_torch.codec import MbeSynthesizer, TableMode
    from digiham_tpu_torch.dsp import DigitalVoiceState, digitalvoice_filter

    synth = MbeSynthesizer(path)
    try:
        synth.set_mode(TableMode(33))
        synth.process(voice)
        synth.drain()
        pcm = np.frombuffer(synth.read_pcm(), np.int16)
    finally:
        synth.close()
    if not pcm.size:
        return b""
    filtered, _ = digitalvoice_filter(
        torch.as_tensor(pcm[None].copy(), device=device),
        DigitalVoiceState.init(1, device))
    return filtered[0].cpu().numpy().astype("<i2").tobytes()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("iq_file", nargs="?", help="complex64 IQ file @48kS/s")
    ap.add_argument("--meta", help="metadata output file")
    ap.add_argument("--ambe", help="write packed voice frames here")
    ap.add_argument("--codecserver", help="synthesize PCM via codecserver")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.iq_file:
        iq = np.fromfile(args.iq_file, np.complex64)
    else:
        print("no IQ file given - synthesizing a demo DMR transmission",
              file=sys.stderr)
        iq = synth_demo_iq()

    dec = make_decoder()
    if args.meta:
        dec.set_meta_writer(FileMetaWriter(args.meta))
    else:
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b: sys.stderr.write("meta: " + b.decode())))
    voice = dec.process(decode(iq, device))
    print(f"decoded {len(voice)} voice payload bytes "
          f"({len(voice)//27} DMR bursts) on {device}", file=sys.stderr)

    if args.ambe:
        with open(args.ambe, "wb") as f:
            f.write(voice)
    if args.codecserver:
        sys.stdout.buffer.write(synthesize(voice, args.codecserver, device))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
