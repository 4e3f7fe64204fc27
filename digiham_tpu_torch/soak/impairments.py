"""Channel impairment models for I/Q streams (the port's copy of
tools/impairments.py): the dominant effects a real capture carries,
applied to clean modulated I/Q.

- **CFO** (carrier frequency offset): receiver LO error. After the FM
  discriminator it is a DC offset on the audio, which the demodulator's
  min/max AGC absorbs.
- **Multipath**: a 2-ray static channel (delayed, attenuated,
  phase-rotated echo).
- **Clipping**: front-end saturation, a hard clamp of I and Q.
- **Sample-rate offset**: TX/RX clock skew in ppm (linear-interpolation
  resample), within the timing recovery's slew range (one sample a
  century: 1,000 ppm at sps 10).
- **AWGN** on I/Q at a calibrated SNR.

Every impairment is deterministic given its seed. Besides the complex
form of the JAX package's tool, :func:`impair_planes` takes and gives
float32 planes (the layout of ``DmrPipeline.step_iq_planes``) and
:func:`impair_bank` fills a bank of channels, one seed a channel, so that
any channel's exact stream can be rebuilt on its own.
"""
import numpy as np


def add_cfo(iq: np.ndarray, offset_hz: float, fs: float = 48000.0):
    n = np.arange(len(iq))
    return (iq * np.exp(2j * np.pi * offset_hz * n / fs)).astype(
        np.complex64)


def add_multipath(iq: np.ndarray, delay: int, gain: float,
                  phase_deg: float = 70.0):
    """2-ray channel: direct + (gain, phase)-weighted echo `delay`
    samples late."""
    echo = np.concatenate([np.zeros(delay, np.complex64), iq[:-delay]])
    rot = gain * np.exp(1j * np.deg2rad(phase_deg))
    return (iq + rot * echo).astype(np.complex64)


def clip_iq(iq: np.ndarray, level: float):
    """Hard-clamp I and Q at `level` x the rms magnitude."""
    lim = level * np.sqrt(np.mean(np.abs(iq) ** 2))
    return (np.clip(iq.real, -lim, lim)
            + 1j * np.clip(iq.imag, -lim, lim)).astype(np.complex64)


def resample_ppm(iq: np.ndarray, ppm: float):
    """Clock-skew resample by (1 + ppm*1e-6) via linear interpolation."""
    ratio = 1.0 + ppm * 1e-6
    t = np.arange(int(len(iq) / ratio)) * ratio
    i = np.interp(t, np.arange(len(iq)), iq.real)
    q = np.interp(t, np.arange(len(iq)), iq.imag)
    return (i + 1j * q).astype(np.complex64)


def add_awgn(iq: np.ndarray, snr_db: float, rng: np.random.Generator):
    p_sig = np.mean(np.abs(iq) ** 2)
    p_n = p_sig / (10 ** (snr_db / 10))
    n = (rng.normal(0, np.sqrt(p_n / 2), len(iq))
         + 1j * rng.normal(0, np.sqrt(p_n / 2), len(iq)))
    return (iq + n).astype(np.complex64)


def impair(iq: np.ndarray, *, cfo_hz: float = 0.0, mp_delay: int = 0,
           mp_gain: float = 0.0, clip_level: float = 0.0,
           ppm: float = 0.0, snr_db: float | None = None,
           seed: int = 0, fs: float = 48000.0) -> np.ndarray:
    """Compose impairments in physical order: propagation (multipath) ->
    receiver LO (CFO) -> front-end clipping -> ADC clock skew -> noise."""
    rng = np.random.default_rng(seed)
    if mp_delay and mp_gain:
        iq = add_multipath(iq, mp_delay, mp_gain)
    if cfo_hz:
        iq = add_cfo(iq, cfo_hz, fs)
    if clip_level:
        iq = clip_iq(iq, clip_level)
    if ppm:
        iq = resample_ppm(iq, ppm)
    if snr_db is not None:
        iq = add_awgn(iq, snr_db, rng)
    return iq


def impair_planes(re: np.ndarray, im: np.ndarray, **kw):
    """:func:`impair` on float32 planes [n]: returns (re, im) float32,
    the planes of the complex result."""
    iq = impair((np.asarray(re, np.float32)
                 + 1j * np.asarray(im, np.float32)).astype(np.complex64),
                **kw)
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


def impair_bank(iq: np.ndarray, seeds, **kw):
    """A bank of impaired channels: row ``c`` is ``impair(iq, seed=
    seeds[c], **kw)`` of the one TX stream ``iq`` [n] complex64 (every
    impairment but the noise is the same on every row). Returns (re, im)
    float32 planes [len(seeds), n'] (n' = n unless ``ppm`` resamples)."""
    rows = [impair(iq, seed=int(s), **kw) for s in seeds]
    re = np.stack([r.real for r in rows]).astype(np.float32)
    im = np.stack([r.imag for r in rows]).astype(np.float32)
    return re, im
