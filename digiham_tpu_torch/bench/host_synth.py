"""The traffic of the host control-plane program (:mod:`.host_tracking`):
the port's copies of the tracked-bank test streams (``make_streams`` of
tests/test_tracked_bank.py, tests/test_tracked_bank_ysf.py and
tests/test_tracked_bank_nxdn.py) and of tools/fuzz_tracked.py's
``synth_dibit``, ``synth_dstar`` and ``synth_pocsag``, built on the TX
builders of :mod:`..soak.synth` and :mod:`.dmr_synth`. For the same numpy
generator every stream equals the JAX repo's, bit for bit
(``tests/test_torch_host_tracking.py``)."""
from __future__ import annotations

import numpy as np

from ..protocols.dstar.header import encode_header
from ..protocols.dstar.phases import HEADER_SYNC, TERMINATOR, VOICE_SYNC
from ..protocols.nxdn.components import (MESSAGE_TYPE_IDLE,
                                         MESSAGE_TYPE_TX_RELEASE)
from ..protocols.pocsag import IDLE_CODEWORD
from ..soak.synth import (address_codeword, alpha_payloads, bit_sync_preamble,
                          build_stream, data_codeword, dstar_voice_frame,
                          encode_facch1, encode_sacch_unit, full_voice_stream,
                          header_frame, make_header_bytes, nxdn_frame,
                          terminator_frame, v1_frame, vcall_superframe_bytes,
                          vd2_frame, voice_slot_dibits, vw_frame)
from .dmr_synth import data_frame, group_lc, voice_frame, voice_superframe

# the streams of tools/bench_host_tracking.py's ``_streams``: six
# transmissions a protocol from one generator, and each protocol's symbol
# rate
SEED = 12345
TRANSMISSIONS = 6
SYMBOL_RATES = {"dmr": 4800, "ysf": 4800, "nxdn": 2400, "dstar": 4800,
                "pocsag": 1200}


def _errors(rng, dibits: np.ndarray) -> np.ndarray:
    """Half the streams get 1% of their dibits replaced at random."""
    if rng.random() < 0.5:
        idx = rng.random(len(dibits)) < 0.01
        dibits = dibits.copy()
        dibits[idx] = rng.integers(0, 4, int(idx.sum()))
    return dibits


def _stack(streams: list) -> np.ndarray:
    n = min(len(s) for s in streams)
    return np.stack([s[:n] for s in streams])


def dmr_streams(seed: int, n_channels: int = 3) -> np.ndarray:
    """tests/test_tracked_bank.py's ``make_streams``: [C, n] dibits of
    noise, voice bursts, voice-LC data bursts and superframes with an
    embedded LC."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_channels):
        lc = group_lc(int(rng.integers(1, 1 << 24)),
                      int(rng.integers(1, 1 << 24)))
        payload = rng.integers(0, 4, 108)
        parts = [rng.integers(0, 4, int(rng.integers(50, 400)))]
        for _ in range(3):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts += [voice_frame(s % 2, payload, sync=True)
                          for s in range(int(rng.integers(3, 9)))]
            elif kind == 1:
                parts += [data_frame(s % 2, int(rng.integers(0, 11)), lc)
                          for s in range(4)]
            else:
                parts += voice_superframe(int(rng.integers(0, 2)), lc,
                                          payload)
        streams.append(_errors(rng, np.concatenate(
            [p.astype(np.uint8) for p in parts])))
    return _stack(streams)


def ysf_streams(seed: int, n_channels: int = 2) -> np.ndarray:
    """tests/test_tracked_bank_ysf.py's ``make_streams``: a header, V/D2,
    V/D1 and VW frames, a terminator, noise and a second call."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_channels):
        parts = [rng.integers(0, 4, int(rng.integers(30, 300)))]
        parts.append(header_frame(b"DEST", b"SRC", b"DOWN", b"UP"))
        for _ in range(int(rng.integers(3, 8))):
            kind = rng.integers(0, 3)
            fn = int(rng.integers(0, 8))
            if kind == 0:
                parts.append(vd2_frame(fn, b"TRACKYSF  "))
            elif kind == 1:
                parts.append(v1_frame(fn, rng.integers(0, 4, 36)))
            else:
                parts.append(vw_frame(
                    fn, rng.integers(0, 256, 18).astype(np.uint8)
                    .tobytes()))
        parts.append(terminator_frame())
        parts.append(rng.integers(0, 4, 100))
        for _ in range(int(rng.integers(2, 5))):
            parts.append(vd2_frame(int(rng.integers(0, 8)),
                                   b"SECONDTX  "))
        streams.append(_errors(rng, np.concatenate(
            [np.asarray(p, np.uint8) for p in parts])))
    return _stack(streams)


def nxdn_streams(seed: int, n_channels: int = 2) -> np.ndarray:
    """tests/test_tracked_bank_nxdn.py's ``make_streams``: SACCH
    superframes with voice and FACCH1 slots (some TX_RELEASE), RCCH and
    UDCH frames, a zero tail."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_channels):
        units = vcall_superframe_bytes(int(rng.integers(0, 8)),
                                       int(rng.integers(1, 1 << 16)),
                                       int(rng.integers(1, 1 << 16)))
        payload = rng.integers(0, 4, 72).astype(np.uint8)
        parts = [rng.integers(0, 4, int(rng.integers(30, 250)))]
        for i in range(int(rng.integers(4, 9))):
            option = int(rng.integers(0, 4))
            slots = []
            for s in range(2):
                if (option >> (1 - s)) & 1:
                    slots.append(voice_slot_dibits(payload, 38 + 72 * s))
                else:
                    mt = (MESSAGE_TYPE_TX_RELEASE
                          if rng.random() < 0.15 else MESSAGE_TYPE_IDLE)
                    slots.append(encode_facch1(mt, 38 + 72 * s))
            lich = (0b01, 0b10, option)
            if rng.random() < 0.15:
                lich = (0b00, 0b10, option) if rng.random() < 0.5 \
                    else (0b01, 0b01, option)
            parts.append(nxdn_frame(
                lich, encode_sacch_unit(i % 4, units[i % 4]), slots))
        parts.append(np.zeros(300, np.uint8))
        streams.append(_errors(rng, np.concatenate(
            [np.asarray(p, np.uint8) for p in parts])))
    return _stack(streams)


MAKE_STREAMS = {"dmr": dmr_streams, "ysf": ysf_streams,
                "nxdn": nxdn_streams}


def synth_dibit(protocol: str, rng) -> np.ndarray:
    """tools/fuzz_tracked.py's ``synth_dibit``: one channel of the
    protocol's ``make_streams``, seeded from ``rng``."""
    seed = int(rng.integers(0, 1 << 31))
    return MAKE_STREAMS[protocol](seed, n_channels=1)[0]


def synth_dstar(rng) -> np.ndarray:
    """tools/fuzz_tracked.py's ``synth_dstar``: bits of noise, voice
    streams, voice-sync entries, lone headers and terminated calls."""
    parts = [rng.integers(0, 2, int(rng.integers(30, 500)))]
    for _ in range(int(rng.integers(1, 4))):
        mode = rng.integers(0, 4)
        if mode == 0:
            parts += full_voice_stream(int(rng.integers(3, 50)))
        elif mode == 1:
            parts += [bit_sync_preamble(), VOICE_SYNC]
            parts += [dstar_voice_frame(raw_data24=VOICE_SYNC) if i % 21 == 20
                      else dstar_voice_frame(
                          voice9=rng.integers(0, 256, 9)
                          .astype(np.uint8).tobytes(),
                          data3=rng.integers(0, 256, 3)
                          .astype(np.uint8).tobytes())
                      for i in range(int(rng.integers(3, 45)))]
        elif mode == 2:
            parts += [bit_sync_preamble(), HEADER_SYNC,
                      encode_header(make_header_bytes(
                          voice=bool(rng.integers(0, 2))))]
        else:
            parts += full_voice_stream(int(rng.integers(3, 12)))
            parts.append(np.concatenate([
                np.unpackbits(rng.integers(0, 256, 9).astype(np.uint8),
                              bitorder="little"), TERMINATOR]))
        parts.append(rng.integers(0, 2, int(rng.integers(20, 300))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def synth_pocsag(rng) -> np.ndarray:
    """tools/fuzz_tracked.py's ``synth_pocsag``: bits of noise and batches
    of address, data, idle and alphanumeric codewords."""
    parts = [rng.integers(0, 2, int(rng.integers(30, 400)))]
    for _ in range(int(rng.integers(1, 4))):
        cws = []
        for _ in range(int(rng.integers(1, 20))):
            k = rng.integers(0, 4)
            if k == 0:
                cws.append(address_codeword(int(rng.integers(0, 1 << 18)),
                                            int(rng.integers(0, 4))))
            elif k == 1:
                cws.append(data_codeword(int(rng.integers(0, 1 << 20))))
            elif k == 2:
                cws.append(IDLE_CODEWORD)
            else:
                text = "".join(chr(32 + int(x)) for x in
                               rng.integers(0, 95, int(rng.integers(1, 30))))
                cws += [data_codeword(p) for p in alpha_payloads(text)]
        parts.append(build_stream(
            cws, preamble_bits=int(rng.integers(1, 4)) * 32))
        parts.append(rng.integers(0, 2, int(rng.integers(10, 200))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def protocol_streams(seed: int = SEED,
                     transmissions: int = TRANSMISSIONS) -> list:
    """tools/bench_host_tracking.py's ``_streams``: (protocol, one
    channel's symbols, symbols a second) for DMR, YSF, NXDN, D-Star and
    POCSAG, ``transmissions`` of each, in that order, from one
    generator."""
    rng = np.random.default_rng(seed)
    out = []
    for name in ("dmr", "ysf", "nxdn"):
        parts = [synth_dibit(name, rng) for _ in range(transmissions)]
        out.append((name, np.concatenate(parts), SYMBOL_RATES[name]))
    out.append(("dstar", np.concatenate(
        [synth_dstar(rng) for _ in range(transmissions)]),
        SYMBOL_RATES["dstar"]))
    out.append(("pocsag", np.concatenate(
        [synth_pocsag(rng) for _ in range(transmissions)]),
        SYMBOL_RATES["pocsag"]))
    return out
