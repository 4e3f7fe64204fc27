"""The unscreened soak of the port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_soak.py [N] [seed0]
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_soak.py --alias[-copy] [reps] [seed]

Case ``i`` takes protocol ``PROTOCOLS[i % 5]`` and seed ``seed0 + i``: a
random stream of that protocol that no knife-edge screen has seen (voice
bursts or pages at random places, random symbols between them, sparse
symbol corruption, Gaussian noise of a random sigma on each channel,
clock drift up to 120 ppm; DMR as I/Q through random impairments of
``soak/impairments.py`` and the port's FM discriminator). The same audio
goes through the JAX package's ``TrackedChannelBank`` (the XLA path) and
the port's on ``device="cpu"``, pushed in the same random chunks, then
flushed. Every channel's bytes and metadata events are compared.

A channel whose outputs differ is classified by machine
(``digiham_tpu_torch/soak/classify.py``) on its exact stream: both banks'
symbol trajectories are recorded, the first symbol where they part is the
root, and the f32 host oracle's margins there (and at the century
boundaries feeding it) give the class: ``slicer-boundary``,
``flat-valley-tie`` or ``timing-settle``, the knife edges on which two
float32 sum orders may decide differently. A root the oracle calls
healthy, or outputs that differ while the symbols agree (a host machine),
is ``UNCLASSIFIED``: a real fault. The script exits 1 if any is found.
The banks hold two channels: a one-channel JAX bank is not deterministic
(``--alias``, :func:`alias_check`).
"""
import json
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp
from digiham_tpu import pipeline as jpipeline
from digiham_tpu.runtime import tracked_bank as j_tracked_bank
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu_torch import pipeline as ppipeline
from digiham_tpu_torch.dsp.fm import fm_discriminator
from digiham_tpu_torch.runtime import tracked_bank as p_tracked_bank
from digiham_tpu_torch.runtime.meta import PipelineMetaWriter
from digiham_tpu_torch.soak import classify, synth
from digiham_tpu_torch.soak.dmr_soak import Trajectory
from digiham_tpu_torch.soak.fuzz_timesharded import make_samples
from digiham_tpu_torch.soak.impairments import impair_bank

PROTOCOLS = ("dmr", "ysf", "nxdn", "dstar", "pocsag")
CHANNELS = 2
# protocol -> (pipeline class name, keyword arguments, adapter class name)
BANKS = {"dmr": ("DmrPipeline", dict(sps=10, n_centuries=4), None),
         "ysf": ("YsfPipeline", dict(sps=10, n_centuries=5), "YsfAdapter"),
         "nxdn": ("NxdnPipeline", dict(sps=20, n_centuries=3),
                  "NxdnAdapter"),
         "dstar": ("FskPipeline", dict(protocol="dstar", n_centuries=2),
                   "DstarAdapter"),
         "pocsag": ("FskPipeline", dict(protocol="pocsag", n_centuries=2),
                    "PocsagAdapter")}


# --- unscreened streams ------------------------------------------------------

def _dmr_symbols(rng):
    parts = [rng.integers(0, 4, int(rng.integers(20, 200)))]
    for _ in range(int(rng.integers(1, 3))):
        payload = rng.integers(0, 4, 108)
        parts += [synth.voice_frame(s % 2, payload, sync=True)
                  for s in range(int(rng.integers(8, 24)))]
        parts.append(rng.integers(0, 4, int(rng.integers(50, 300))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _ysf_symbols(rng):
    """A call of V/D2, V/D1 or VW frames, each drawn in turn."""
    parts = [rng.integers(0, 4, int(rng.integers(20, 300))),
             synth.header_frame(b"DEST", b"SRC ", b"DOWN", b"UP  ")]
    for i in range(int(rng.integers(4, 10))):
        kind = int(rng.integers(0, 3))
        parts.append(synth.vd2_frame(i % 8, b"SOAKTORCH!") if kind == 0
                     else synth.v1_frame(i % 8) if kind == 1
                     else synth.vw_frame(i % 8))
    parts += [synth.terminator_frame(),
              rng.integers(0, 4, int(rng.integers(50, 300)))]
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _nxdn_symbols(rng):
    units = synth.vcall_superframe_bytes(int(rng.integers(0, 8)),
                                         int(rng.integers(1, 1 << 16)),
                                         int(rng.integers(1, 1 << 16)))
    payload = rng.integers(0, 4, 72).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(20, 300)))]
    for i in range(int(rng.integers(4, 12))):
        slots = [synth.voice_slot_dibits(payload, 38),
                 synth.voice_slot_dibits(payload, 38 + 72)]
        parts.append(synth.nxdn_frame(
            (0b01, 0b10, 0b11), synth.encode_sacch_unit(i % 4, units[i % 4]),
            slots))
    if rng.random() < 0.5:  # the call ends with a FACCH1 TX_RELEASE
        parts.append(synth.nxdn_frame(
            (0b01, 0b10, 0b00),
            synth.encode_sacch_unit(0, np.zeros(18, np.uint8)),
            [synth.encode_facch1(0x08, 38), None]))
    parts.append(rng.integers(0, 4, int(rng.integers(100, 300))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _dstar_symbols(rng):
    parts = [rng.integers(0, 2, int(rng.integers(20, 300)))]
    parts += synth.full_voice_stream(int(rng.integers(20, 60)))
    parts.append(rng.integers(0, 2, int(rng.integers(100, 400))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def _pocsag_symbols(rng):
    parts = [rng.integers(0, 2, int(rng.integers(50, 200)))]
    for m in range(int(rng.integers(1, 4))):
        cws = [synth.address_codeword(int(rng.integers(1, 1 << 18)), 3)]
        cws += [synth.data_codeword(p)
                for p in synth.alpha_payloads(f"SOAK {m}")]
        parts.append(synth.build_stream(cws))
        parts.append(rng.integers(0, 2, int(rng.integers(60, 200))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


SYMBOLS = {"dmr": _dmr_symbols, "ysf": _ysf_symbols, "nxdn": _nxdn_symbols,
           "dstar": _dstar_symbols, "pocsag": _pocsag_symbols}


def _dmr_impaired(rng, symbols, channels):
    """DMR as I/Q: rect 4FSK, random impairments (each drawn on or off),
    one noise seed a channel, the port's FM discriminator times 5,000."""
    kw = {}
    if rng.random() < 0.5:
        kw["cfo_hz"] = float(rng.uniform(-600, 600))
    if rng.random() < 0.4:
        kw.update(mp_delay=int(rng.integers(1, 4)),
                  mp_gain=float(rng.uniform(0.1, 0.4)))
    if rng.random() < 0.3:
        kw["clip_level"] = float(rng.uniform(0.8, 1.5))
    if rng.random() < 0.5:
        kw["ppm"] = float(rng.uniform(-150, 150))
    kw["snr_db"] = float(rng.uniform(10, 30))
    seeds = rng.integers(0, 1 << 31, channels)
    re, im = impair_bank(synth.modulate(symbols), seeds, **kw)
    audio, _ = fm_discriminator(torch.from_numpy(re), torch.from_numpy(im),
                                torch.ones(channels), torch.zeros(channels))
    return (audio * 5000.0).numpy(), kw


def stream(proto: str, seed: int, channels: int = CHANNELS):
    """(audio [channels, n] float32, what was drawn) of one case."""
    rng = np.random.default_rng(seed)
    symbols = SYMBOLS[proto](rng)
    if proto == "dmr":
        return _dmr_impaired(rng, symbols, channels)
    return make_samples(rng, proto, channels, symbols), {}


# --- both banks ------------------------------------------------------------

class _Run:
    """One bank over the audio: bytes, events and the symbol trajectory
    of every channel."""

    def __init__(self, bank, writer_cls, channels):
        self.bytes = [b""] * channels
        self.events = [[] for _ in range(channels)]
        bank.on_output = self._on_output
        for c in range(channels):
            bank.set_meta_writer(c, writer_cls(
                lambda b, e=self.events[c]: e.append(b.decode())))
        self.traj = Trajectory(bank)
        self.bank = bank

    def _on_output(self, c, data):
        self.bytes[c] += bytes(data)


def banks(proto: str, channels: int = CHANNELS, **pipeline_kw):
    """(JAX bank, port bank on the CPU) for ``proto``; ``pipeline_kw``
    overrides the pipelines' arguments."""
    name, kw, adapter = BANKS[proto]
    kw = {**kw, **pipeline_kw}
    jb = j_tracked_bank.TrackedChannelBank(
        getattr(jpipeline, name)(channels=channels, **kw),
        adapter=getattr(j_tracked_bank, adapter)() if adapter else None)
    pb = p_tracked_bank.TrackedChannelBank(
        getattr(ppipeline, name)(channels=channels, device="cpu", **kw),
        adapter=getattr(p_tracked_bank, adapter)() if adapter else None,
        device="cpu")
    return _Run(jb, JWriter, channels), _Run(pb, PipelineMetaWriter, channels)


def drive(runs, audio, chunks):
    for lo, hi in zip(chunks[:-1], chunks[1:]):
        for r in runs:
            r.bank.push(audio[:, lo:hi])
    for r in runs:
        r.bank.flush()


def divergence(port_traj, jax_traj, samples, pipe) -> dict:
    """The machine verdict on one channel whose outputs differ: the first
    symbol where the two trajectories part, classified on the f32
    oracle's trace of the channel's filtered stream."""
    n = min(len(port_traj), len(jax_traj))
    diff = np.nonzero(port_traj[:n] != jax_traj[:n])[0]
    if len(diff) == 0 and len(port_traj) == len(jax_traj):
        return {"verdict": "UNCLASSIFIED",
                "why": "equal symbols, different outputs"}
    root = int(diff[0]) if len(diff) else n
    design = pipe.rrc_design
    filtered = (samples if design is None
                else classify.rrc_np(samples, design))
    mode = "fsk" if getattr(pipe, "protocol", None) in ("dstar", "pocsag") \
        else "gfsk"
    _, margins, cents = classify.oracle_trace(
        filtered, pipe.sps, mode, getattr(pipe, "invert", False))
    out = classify._verdict(margins, cents, root, root + 1)
    out["root_symbol"] = root
    return out


def run_case(proto: str, seed: int, channels: int = CHANNELS) -> dict:
    """One unscreened stream through both banks. Returns the case's
    record: equal channels, and each differing channel's verdict."""
    audio, drawn = stream(proto, seed, channels)
    j, p = banks(proto, channels)
    rng = np.random.default_rng((seed, 1))
    chunk = int(rng.integers(2048, 16384))
    chunks = list(range(0, audio.shape[1], chunk)) + [audio.shape[1]]
    drive((j, p), audio, chunks)
    out = {"proto": proto, "seed": seed, "samples": audio.shape[1],
           "chunk": chunk, "drawn": drawn, "channels": channels,
           "bytes": sum(map(len, j.bytes)),
           "events": sum(map(len, j.events)), "mismatches": []}
    for c in range(channels):
        if p.bytes[c] == j.bytes[c] and p.events[c] == j.events[c]:
            continue
        v = divergence(p.traj.channel(c), j.traj.channel(c), audio[c],
                       p.bank.pipeline)
        out["mismatches"].append({
            "channel": c, **v,
            "jax_bytes": len(j.bytes[c]), "port_bytes": len(p.bytes[c]),
            "jax_events": len(j.events[c]),
            "port_events": len(p.events[c])})
    return out


def campaign(n: int, seed0: int = 0, channels: int = CHANNELS,
             log=None) -> dict:
    """``n`` cases, protocols in turn."""
    records = []
    t0 = time.perf_counter()
    for i in range(n):
        r = run_case(PROTOCOLS[i % len(PROTOCOLS)], seed0 + i, channels)
        records.append(r)
        if log and r["mismatches"]:
            log(json.dumps(r, default=str))
        if (i + 1) % 10 == 0:
            # the JAX bank compiles a step for every block length it
            # meets; tools/fuzz_timesharded.py clears them as often
            jax.clear_caches()
            if log:
                log(f"{i + 1}/{n} cases, "
                    f"{sum(len(r['mismatches']) for r in records)} "
                    f"mismatching channels")
    kinds = [classify.verdict_class(m["verdict"])
             for r in records for m in r["mismatches"]]
    return {"cases": n, "seed0": seed0, "channels": channels,
            "channel_streams": n * channels,
            "equal_channels": n * channels - len(kinds),
            "bytes": sum(r["bytes"] for r in records),
            "events": sum(r["events"] for r in records),
            "mismatch_classes": {k: kinds.count(k)
                                 for k in sorted(set(kinds))},
            "unclassified": [dict(m, proto=r["proto"], seed=r["seed"])
                             for r in records for m in r["mismatches"]
                             if m["verdict"] == "UNCLASSIFIED"],
            "wall_s": time.perf_counter() - t0, "records": records}


def alias_check(reps: int = 32, seed: int = 12, copy: bool = False) -> dict:
    """The JAX package's one-channel bank against itself: the DMR call of
    ``soak/impaired.py`` at 12 frames with the ``clock+100ppm`` impairment
    (noise seed ``seed``), through the JAX ``fm_discriminator`` and a
    one-channel JAX ``TrackedChannelBank`` (2 centuries, pushes of 4,096,
    flush) beside the port's, ``reps`` times in one process. Returns how
    many distinct symbol trajectories the JAX bank gave over the
    repetitions, and the port's (1: deterministic). The JAX bank's
    ``rrc_rebase_history`` (digiham_tpu/runtime/stream.py:52-60) wraps a
    view of its sample buffer with ``jnp.asarray``, which on the CPU may
    alias it when the view is contiguous (one channel) and aligned, and
    ``consume`` then shifts the buffer under the next step's RRC
    history. ``copy``: hand that function a copy of the block in this
    process (the JAX package's file is not changed), which should make
    the JAX bank deterministic."""
    import digiham_tpu.runtime.stream as j_stream
    from digiham_tpu.dsp.fm import fm_discriminator as j_fm
    from digiham_tpu_torch.soak.impairments import impair

    rebase = j_stream.rrc_rebase_history
    if copy:
        j_stream.rrc_rebase_history = (
            lambda pipeline, state, block, base, stream_start=True: rebase(
                pipeline, state, np.array(block), base, stream_start))

    iq = impair(synth.modulate(synth.dmr_call(12)), ppm=100.0, seed=seed)
    a, _ = j_fm(jnp.asarray(iq[None, :]), jnp.ones((1,), jnp.complex64))
    audio = (np.asarray(a) * 5000.0).astype(np.float32)
    chunks = list(range(0, audio.shape[1], 4096)) + [audio.shape[1]]
    trajs = []
    try:
        for _ in range(reps):
            j, p = banks("dmr", 1, n_centuries=2)
            drive((j, p), audio, chunks)
            trajs.append((j.traj.channel(0), p.traj.channel(0)))
    finally:
        j_stream.rrc_rebase_history = rebase

    def distinct(k):
        return len({t[k].tobytes() for t in trajs})

    return {"reps": reps, "seed": seed, "copy": copy,
            "jax_distinct": distinct(0), "port_distinct": distinct(1),
            "symbols": len(trajs[0][0])}


def main(argv):
    torch.set_num_threads(1)
    if argv and argv[0] in ("--alias", "--alias-copy"):
        print(json.dumps(alias_check(*(int(a) for a in argv[1:3]),
                                     copy=argv[0] == "--alias-copy")))
        return 0
    n = int(argv[0]) if argv else 25
    seed0 = int(argv[1]) if len(argv) > 1 else 0
    result = campaign(n, seed0, log=print)
    result.pop("records")
    print(json.dumps(result, default=str))
    return 1 if result["unclassified"] else 0


if __name__ == "__main__":
    jnp.zeros(1)  # the JAX backend up front (JAX_PLATFORMS=cpu)
    sys.exit(main(sys.argv[1:]))
