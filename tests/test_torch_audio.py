"""The digital-voice post-filter and the DC blocker of the port
(``digiham_tpu_torch/dsp/{audio,fm}.py``, kernel K6's plain versions in
``ops/recurrence.py``) on the CPU against the JAX package's
``digitalvoice_filter``, ``DigitalVoiceFilterNp`` and ``dc_block``.

Tolerances and why:

- ``digitalvoice_filter`` against the JAX function: the port sums the
  forward and feedback terms left to right with every product and sum
  rounded on its own; XLA sums ``xfull @ fw + yv @ fb`` in its own order
  (and may fuse multiply-adds), and the IIR carries the differences on. At
  speech level (sigma 3,000, chained blocks of uneven length, states
  carried across packages) they agree within 2 LSB, the JAX package's own
  bound against its oracle (tests/test_dsp.py:161-167). The difference
  grows with the input's amplitude (measured: 1 LSB at a peak of 8,000, 4
  LSB at 32,000): for input driven to full scale the bound is 1 LSB per
  4,096 of full scale, 8 LSB. A wrapping cast would differ by ~65,000.
- ``DigitalVoiceFilterNp``: the same code as the JAX package's, byte for
  byte, its wrapping cast included.
- ``dc_block``: the port runs the recurrence in sequence, the JAX package
  an associative scan plus ``alpha**n * y1``: within 1e-4 on unit-variance
  input over 600 samples in chained blocks (tests/test_dsp.py:213-224), and
  at 48,000 samples too.
- int32 PCM past the int16 range (sigma 20,000, peaks near 80,000), which
  the JAX function takes: within the full-scale bound, 8 LSB (measured 5-6);
  the carried outputs within 8 LSB of full scale.
- K6's plain versions against a numpy float32 loop in the kernel's order:
  equal. Against a numpy float32 emulation of the kernel's split order
  (per tile: the scaled inputs and forward sums first, then the chain with
  the feedback sum alone, then the conversion; the DC blocker's differences,
  then its chain): equal, state included.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu.dsp import audio as j_audio
from digiham_tpu.dsp import fm as j_fm
from digiham_tpu_torch import convert
from digiham_tpu_torch.dsp import audio, fm
from digiham_tpu_torch.ops import recurrence

torch.set_num_threads(1)

SPEECH_LSB = 2     # speech level, the JAX package's own bound
FULL_SCALE_LSB = 8  # 1 LSB per 4,096 of full scale
DC_ATOL = 1e-4


def _speech(seed, channels, n, sigma=3000.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, sigma, (channels, n)), -32768,
                   32767).astype(np.int16)


def _jax_state(channels):
    return j_audio.DigitalVoiceState.init(channels)


def _port_state(channels):
    return audio.DigitalVoiceState.init(channels, device="cpu")


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64)
                      - np.asarray(b).astype(np.int64)).max())


@pytest.mark.parametrize("seed,blocks", [
    (1, (2500, 3700, 2300)),
    (2, (1, 4099, 9, 3991)),
    (3, (8000,)),
])
def test_digitalvoice_filter_matches_jax_on_chained_blocks(seed, blocks):
    """Speech-level PCM in chained blocks: each block of the port, started
    from the JAX state of the block before (``convert``), within 2 LSB of
    the JAX block; the port chained on its own state too."""
    pcm = _speech(seed, 3, sum(blocks))
    js, ps, alone = _jax_state(3), _port_state(3), _port_state(3)
    worst, o = 0, 0
    for n in blocks:
        block = pcm[:, o:o + n]
        handed = convert.digitalvoice_state_from_jax(js.xv, js.yv, "cpu")
        got, ps = audio.digitalvoice_filter(torch.from_numpy(block), handed)
        chained, alone = audio.digitalvoice_filter(torch.from_numpy(block),
                                                   alone)
        want, js = j_audio.digitalvoice_filter(jnp.asarray(block), js)
        assert got.dtype == torch.int16 and got.shape == block.shape
        worst = max(worst, _lsb(got, want), _lsb(chained, want))
        np.testing.assert_allclose(ps.yv.numpy(), np.asarray(js.yv),
                                   atol=2 * SPEECH_LSB / 32767)
        o += n
    assert worst <= SPEECH_LSB, worst


@pytest.mark.parametrize("seed,blocks", [
    (11, (2500, 3700, 2800)),
    (12, (1, 999, 320, 4001)),
])
def test_digitalvoice_filter_takes_int32_past_the_int16_range(seed, blocks):
    """int32 PCM with peaks far past the int16 range, as the JAX function
    takes it, in chained blocks handed across packages: int16 out, within
    the full-scale bound of the JAX block."""
    rng = np.random.default_rng(seed)
    pcm = np.round(rng.normal(0, 20000, (3, sum(blocks)))).astype(np.int32)
    assert np.abs(pcm).max() > 65536
    js, alone = _jax_state(3), _port_state(3)
    worst, o = 0, 0
    for n in blocks:
        block = pcm[:, o:o + n]
        handed = convert.digitalvoice_state_from_jax(js.xv, js.yv, "cpu")
        got, ps = audio.digitalvoice_filter(torch.from_numpy(block), handed)
        chained, alone = audio.digitalvoice_filter(torch.from_numpy(block),
                                                   alone)
        want, js = j_audio.digitalvoice_filter(jnp.asarray(block), js)
        assert got.dtype == torch.int16 and got.shape == block.shape
        assert np.asarray(want).dtype == np.int16
        worst = max(worst, _lsb(got, want), _lsb(chained, want))
        np.testing.assert_allclose(ps.yv.numpy(), np.asarray(js.yv),
                                   atol=FULL_SCALE_LSB / 32767)
        o += n
    assert worst <= FULL_SCALE_LSB, worst


@pytest.mark.parametrize("half_period", [4, 6, 8])
def test_overdrive_saturates_as_jax_does(half_period):
    """A square wave at +-32,000 through the bandpass (peak gain about 5)
    drives the output far past the int16 range: the port saturates there
    as the JAX function does, where a wrapping cast flips sign."""
    t = np.arange(6000)
    sq = np.where((t // half_period) % 2, 32000, -32000).astype(np.int16)
    sq = np.stack([sq, -sq])
    want, _ = j_audio.digitalvoice_filter(jnp.asarray(sq), _jax_state(2))
    got, _ = audio.digitalvoice_filter(torch.from_numpy(sq), _port_state(2))
    want = np.asarray(want).astype(np.int64)
    got = got.numpy().astype(np.int64)
    rails = (want == 32767) | (want == -32768)
    assert rails.sum() > 100  # the case is overdriven
    assert _lsb(got, want) <= FULL_SCALE_LSB
    assert np.array_equal(np.sign(got[rails]), np.sign(want[rails]))
    assert got.max() == 32767 and got.min() == -32768


def test_saturating_cast_not_wrapping():
    """The conversion itself: y * SHRT_MAX of 40,000 / -40,000 / 70,000
    LSB gives the rails, not [-25536, 25536, 4464]."""
    y = torch.tensor([[40000.0, -40000.0, 70000.0, 1234.9, -1234.9]]) \
        / 32767.0
    out = (y * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)
    want = np.asarray(
        (jnp.asarray(y.numpy()) * 32767.0).astype(jnp.int16))
    assert out.tolist() == [[32767, -32768, 32767, 1234, -1234]]
    assert want.tolist() == out.tolist()


@pytest.mark.parametrize("seed", [4, 5])
def test_full_scale_noise_within_the_envelope(seed):
    """Full-scale noise (what a codec stand-in's echoed bytes look like as
    PCM): within 1 LSB per 4,096 of full scale."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (2, 5000)).astype(np.int16)
    want, _ = j_audio.digitalvoice_filter(jnp.asarray(pcm), _jax_state(2))
    got, _ = audio.digitalvoice_filter(torch.from_numpy(pcm), _port_state(2))
    assert _lsb(got, want) <= FULL_SCALE_LSB


@pytest.mark.parametrize("kind", ["speech", "overdrive"])
def test_numpy_oracle_equals_the_jax_oracle(kind):
    """DigitalVoiceFilterNp is copied as it is, wrap included: byte for byte
    with the JAX package's on the same chunks."""
    if kind == "speech":
        pcm = _speech(6, 1, 3000)[0]
    else:
        pcm = np.where((np.arange(3000) // 8) % 2, 32000,
                       -32000).astype(np.int16)
    ours, theirs = audio.DigitalVoiceFilterNp(), j_audio.DigitalVoiceFilterNp()
    for lo, hi in ((0, 1), (1, 1000), (1000, 3000)):
        a, b = ours.process(pcm[lo:hi]), theirs.process(pcm[lo:hi])
        assert a.dtype == b.dtype == np.int16
        assert a.tobytes() == b.tobytes()
    if kind == "overdrive":  # the oracle wraps where the filter saturates
        filtered, _ = audio.digitalvoice_filter(
            torch.from_numpy(pcm[None]), _port_state(1))
        assert _lsb(audio.DigitalVoiceFilterNp().process(pcm),
                    filtered[0]) > 30000


@pytest.mark.parametrize("blocks", [(150, 251, 199), (1, 599)])
def test_dc_block_matches_jax(blocks):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (3, sum(blocks))).astype(np.float32)
    js = j_fm.DcBlockState.init(3)
    ps = fm.DcBlockState.init(3, device="cpu")
    o, worst = 0, 0.0
    for n in blocks:
        want, js_next = j_fm.dc_block(jnp.asarray(x[:, o:o + n]), js)
        handed = convert.dc_block_state_from_jax(js.x1, js.y1, "cpu")
        got, _ = fm.dc_block(torch.from_numpy(x[:, o:o + n]), handed)
        chained, ps = fm.dc_block(torch.from_numpy(x[:, o:o + n]), ps)
        worst = max(worst, float(np.abs(got.numpy() - want).max()),
                    float(np.abs(chained.numpy() - want).max()))
        js = js_next
        o += n
    assert worst <= DC_ATOL, worst
    assert np.array_equal(ps.x1.numpy(), x[:, -1])


def test_dc_block_bound_at_48000_samples():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 48000)).astype(np.float32)
    want, _ = j_fm.dc_block(jnp.asarray(x), j_fm.DcBlockState.init(2))
    got, _ = fm.dc_block(torch.from_numpy(x), fm.DcBlockState.init(2, "cpu"))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= DC_ATOL


def _iir_numpy(pcm, xv, yv):
    """The kernel's order in numpy float32, one sample at a time."""
    fw, fb = audio._FORWARD, audio._FEEDBACK
    scale, gain = np.float32(audio.SHRT_MAX), np.float32(audio.GAIN)
    x, y = list(xv.T), list(yv.T)
    out = np.zeros(pcm.shape, np.int16)
    for t in range(pcm.shape[1]):
        xin = (pcm[:, t].astype(np.float32) / scale) / gain
        w = x[-10:] + [xin]
        f = fw[0] * w[0]
        for j in range(1, 11):
            f = f + fw[j] * w[j]
        b = fb[0] * y[-10]
        for j in range(1, 10):
            b = b + fb[j] * y[-10 + j]
        yt = f + b
        assert yt.dtype == np.float32
        x.append(xin)
        y.append(yt)
        out[:, t] = np.trunc(np.clip(yt * scale, -32768, 32767))
    return out, np.stack(x[-10:], 1), np.stack(y[-10:], 1)


@pytest.mark.parametrize("T", [0, 1, 9, 10, 11, 25, 331])
def test_iir_plain_equals_a_numpy_loop(T):
    rng = np.random.default_rng(T)
    pcm = rng.integers(-32768, 32768, (3, T)).astype(np.int16)
    xv = rng.normal(0, 0.05, (3, 10)).astype(np.float32)
    yv = rng.normal(0, 0.2, (3, 10)).astype(np.float32)
    got = recurrence.digitalvoice_iir(
        torch.from_numpy(pcm), torch.from_numpy(xv), torch.from_numpy(yv),
        audio._FORWARD, audio._FEEDBACK, audio.SHRT_MAX, audio.GAIN)
    if T == 0:
        want = (np.zeros((3, 0), np.int16), xv, yv)
    else:
        want = _iir_numpy(pcm, xv, yv)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def _dc_numpy(x, x1, y1, alpha):
    a = np.float32(alpha)
    y = np.zeros_like(x)
    xp, yp = x1.copy(), y1.copy()
    for t in range(x.shape[1]):
        yp = (x[:, t] - xp) + a * yp
        xp = x[:, t]
        y[:, t] = yp
    return y, xp, yp


@pytest.mark.parametrize("T", [1, 2, 161, 500])
def test_dc_block_plain_equals_a_numpy_loop(T):
    rng = np.random.default_rng(100 + T)
    x = rng.normal(0, 1, (4, T)).astype(np.float32)
    x1 = rng.normal(0, 1, 4).astype(np.float32)
    y1 = rng.normal(0, 1, 4).astype(np.float32)
    got = recurrence.dc_block(torch.from_numpy(x), torch.from_numpy(x1),
                              torch.from_numpy(y1), 0.999)
    for g, w in zip(got, _dc_numpy(x, x1, y1, 0.999)):
        assert np.array_equal(g.numpy(), w)


def _iir_split(pcm, xv, yv, tile):
    """The kernel's split order in numpy float32, tile by tile: the helpers'
    scaled inputs of a tile, the ten before it as its halo, and its forward
    sums; then the chain lane's feedback sum and add, one sample at a time;
    then the conversion of the tile's outputs."""
    fw, fb = audio._FORWARD, audio._FEEDBACK
    scale, gain = np.float32(audio.SHRT_MAX), np.float32(audio.GAIN)
    T = pcm.shape[1]
    halo, y = xv.copy(), list(yv.T)
    out = np.zeros(pcm.shape, np.int16)
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        xin = (pcm[:, t0:t0 + n].astype(np.float32) / scale) / gain
        row = np.concatenate([halo, xin], axis=1)
        f = fw[0] * row[:, 0:n]
        for j in range(1, recurrence.ORDER + 1):
            f = f + fw[j] * row[:, j:j + n]
        walked = np.empty_like(f)
        for t in range(n):
            b = fb[0] * y[-10]
            for j in range(1, recurrence.ORDER):
                b = b + fb[j] * y[-10 + j]
            y.append(f[:, t] + b)
            walked[:, t] = y[-1]
        assert walked.dtype == np.float32
        out[:, t0:t0 + n] = np.trunc(np.clip(walked * scale, -32768, 32767))
        halo = row[:, -recurrence.ORDER:]
    return out, halo, np.stack(y[-10:], 1)


def _dc_split(x, x1, y1, alpha, tile):
    """The DC blocker's split order: a tile's differences (the carried or
    the tile before's last input first), then the chain."""
    a = np.float32(alpha)
    y = np.zeros_like(x)
    prev, yp = x1.copy(), y1.copy()
    for t0 in range(0, x.shape[1], tile):
        block = x[:, t0:t0 + tile]
        d = block - np.concatenate([prev[:, None], block[:, :-1]], axis=1)
        for t in range(block.shape[1]):
            yp = d[:, t] + a * yp
            y[:, t0 + t] = yp
        prev = block[:, -1]
    return y, prev, yp


_SPLIT_T = [0, 1, 9, 10, 11, recurrence.TILE - 1, recurrence.TILE,
            recurrence.TILE + 1, 2 * recurrence.TILE + 7]


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("T", _SPLIT_T)
def test_iir_split_order_equals_the_plain_version(T, dtype):
    """The order the kernel takes (inputs and forward sums a tile at a time,
    then the chain, then the conversion) equals digitalvoice_iir_plain bit
    for bit, state included, over chained uneven blocks: T, 13, then T
    again."""
    rng = np.random.default_rng(200 + T)
    sigma = 9000 if dtype == np.int16 else 30000
    pcm = np.clip(np.round(rng.normal(0, sigma, (3, 2 * T + 13))),
                  np.iinfo(dtype).min, np.iinfo(dtype).max).astype(dtype)
    xv = rng.normal(0, 0.05, (3, 10)).astype(np.float32)
    yv = rng.normal(0, 0.2, (3, 10)).astype(np.float32)
    mine = plain = (xv, yv)
    o = 0
    for n in (T, 13, T):
        block = pcm[:, o:o + n]
        got = _iir_split(block, *mine, recurrence.TILE)
        want = recurrence.digitalvoice_iir_plain(
            torch.from_numpy(block), *map(torch.from_numpy, plain),
            audio._FORWARD, audio._FEEDBACK, audio.SHRT_MAX, audio.GAIN)
        want = [w.numpy() for w in want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        mine, plain = got[1:], want[1:]
        o += n


@pytest.mark.parametrize("T", _SPLIT_T)
def test_dc_block_split_order_equals_the_plain_version(T):
    rng = np.random.default_rng(300 + T)
    x = rng.normal(0, 1, (4, 2 * T + 13)).astype(np.float32)
    mine = plain = (rng.normal(0, 1, 4).astype(np.float32),
                    rng.normal(0, 1, 4).astype(np.float32))
    o = 0
    for n in (T, 13, T):
        if n == 0:
            continue  # the plain version takes no empty block's state
        block = x[:, o:o + n]
        got = _dc_split(block, *mine, 0.999, recurrence.TILE)
        want = [w.numpy() for w in recurrence.dc_block_plain(
            torch.from_numpy(block), *map(torch.from_numpy, plain), 0.999)]
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        mine, plain = got[1:], want[1:]
        o += n


@pytest.mark.parametrize("channels,rows", [
    (1, 1), (132, 1), (133, 2), (256, 2), (264, 2), (265, 3), (2111, 16),
    (2112, 16), (2113, 16), (100000, 16)])
def test_block_rows_spread_the_channels_over_the_sms(channels, rows):
    """The kernel's channels a block on a 132-SM card: one block an SM while
    the channels last (every chain warp on an SM of its own), then more
    channels a block, at most ROWS, then more blocks than SMs."""
    assert recurrence.block_rows(channels, 132) == rows
    assert recurrence.ROWS == 16


def test_wrappers_take_only_what_the_kernel_takes():
    xv = torch.zeros((2, 10))
    with pytest.raises(ValueError):  # float PCM is not converted
        recurrence.digitalvoice_iir(torch.zeros((2, 5)), xv, xv,
                                    audio._FORWARD, audio._FEEDBACK, 1, 1)
    with pytest.raises(ValueError):  # int64 PCM neither
        recurrence.digitalvoice_iir(torch.zeros((2, 5), dtype=torch.int64),
                                    xv, xv, audio._FORWARD, audio._FEEDBACK,
                                    1, 1)
    with pytest.raises(ValueError):  # a state of the wrong width
        audio.digitalvoice_filter(torch.zeros((2, 5), dtype=torch.int16),
                                  audio.DigitalVoiceState(xv[:, :9], xv))
    with pytest.raises(ValueError):  # no kernel for this device
        recurrence.dc_block(torch.zeros((1, 3), device="meta"),
                            torch.zeros(1, device="meta"),
                            torch.zeros(1, device="meta"), 0.5)
    assert recurrence.LAUNCHES == {"digitalvoice_iir": 0, "dc_block": 0}


def test_states_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio.DigitalVoiceState.init(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fm.DcBlockState.init(1)
