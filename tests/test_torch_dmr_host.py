"""The port's host control plane against the JAX package's, on the same
inputs made from a seed with numpy: the numpy FEC twins (``decode_np``,
BPTC ``decode_np``/``encode``, RS(12,9)), the small utilities, the DMR
frame components, the symbol-domain ``Decoder`` (``SyncPhase`` /
``FramePhase``) and the fields-consuming ``FieldsFramePhase``, on
``dmr_synth`` streams (clean, 1% dibit errors, noise). Everything here is
integer or byte work: equality is exact.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from digiham_tpu import utils as j_utils
from digiham_tpu.fec import bptc as j_bptc
from digiham_tpu.fec import codes as j_codes
from digiham_tpu.fec import rs129 as j_rs129
from digiham_tpu.fec.linear import BlockCode as JBlockCode
from digiham_tpu.fec.linear import decode_np as j_decode_np
from digiham_tpu.pipeline.dmr import dmr_decode_frames as j_decode_frames
from digiham_tpu.protocols.dmr import components as j_comp
from digiham_tpu.protocols.dmr import make_decoder as j_make_decoder
from digiham_tpu.protocols.dmr import phases as j_phases
from digiham_tpu.protocols.dmr.fields_phase import \
    FieldsFramePhase as JFieldsFramePhase
from digiham_tpu.protocols.dmr.meta import MetaCollector as JMetaCollector
from digiham_tpu.runtime.meta import PipelineMetaWriter as JWriter
from digiham_tpu.runtime.tracked_bank import DmrAdapter as JAdapter
from digiham_tpu_torch import utils
from digiham_tpu_torch.dsp.demod import FskDemodNp, GfskDemodNp
from digiham_tpu_torch.fec import bptc, codes, rs129
from digiham_tpu_torch.fec.linear import decode_np
from digiham_tpu_torch.pipeline import DmrPipeline
from digiham_tpu_torch.protocols.dmr import (components, constants,
                                             make_decoder, phases)
from digiham_tpu_torch.protocols.dmr.fields_phase import FieldsFramePhase
from digiham_tpu_torch.protocols.dmr.meta import MetaCollector
from digiham_tpu_torch.runtime.meta import (FileMetaWriter,
                                            PipelineMetaWriter,
                                            StringSerializer)
from digiham_tpu_torch.runtime.tracked_bank import DmrAdapter

sys.path.insert(0, os.path.dirname(__file__))
from dmr_synth import (data_frame, embedded_fragments,  # noqa: E402
                       group_lc, make_lc_bytes, voice_frame,
                       voice_superframe)

torch.set_num_threads(1)

CODES = [c.name.upper() for c in codes.ALL_CODES]


# --- FEC twins ------------------------------------------------------------

@pytest.mark.parametrize("name", CODES)
def test_decode_np_equals_jax(name):
    """Random words (valid codewords with 0-4 bit errors, and noise), as
    an array and one by one through the scalar path."""
    code, j_code = getattr(codes, name), getattr(j_codes, name)
    rng = np.random.default_rng(CODES.index(name))
    data = rng.integers(0, 1 << code.k, 400)
    words = code.encode(data)
    assert np.array_equal(words, j_code.encode(data))
    assert np.array_equal(code.generator_rows, j_code.generator_rows)
    for i in range(len(words)):
        for bit in rng.choice(code.n, int(rng.integers(0, 5)),
                              replace=False):
            words[i] ^= 1 << int(bit)
    words = np.concatenate([words, rng.integers(0, 1 << code.n, 200)])
    got, ok = decode_np(code, words)
    want, j_ok = j_decode_np(j_code, words)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ok, j_ok) and ok.any()
    if name not in ("HAMMING_7_4", "HAMMING_15_11"):  # perfect codes
        assert not ok.all()
    for w in words[:50]:
        assert decode_np(code, int(w)) == j_decode_np(j_code, int(w))
        assert decode_np(code, np.int64(w)) == j_decode_np(j_code,
                                                           np.int64(w))


def test_hamming_16_11_is_the_jax_package_s():
    assert codes.HAMMING_16_11.parity_rows == j_codes.HAMMING_16_11.parity_rows
    assert np.array_equal(codes.HAMMING_16_11.syndrome_table,
                          j_codes.HAMMING_16_11.syndrome_table)


@pytest.mark.parametrize("errors", [0, 3, 12])
def test_bptc_host_twins_equal_jax(errors):
    rng = np.random.default_rng(errors)
    data = rng.integers(0, 2, (64, 96))
    tx = bptc.encode(data)
    assert tx.dtype == np.int64 and np.array_equal(tx, j_bptc.encode(data))
    assert np.array_equal(bptc.encode(data[0]), tx[0])  # one frame
    rx = tx.copy()
    for row in rx:
        row[rng.choice(196, errors, replace=False)] ^= 1
    got, ok = bptc.decode_np(rx)
    want, j_ok = j_bptc.decode_np(rx)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ok, j_ok)
    if errors == 0:
        assert ok.all() and np.array_equal(got, data)
    # the device decode of the same bits agrees with the host twin
    t_got, t_ok = bptc.decode(torch.from_numpy(rx))
    assert np.array_equal(t_ok.numpy(), ok)
    assert np.array_equal(t_got.numpy()[ok], got[ok])


def test_rs129_equals_jax():
    rng = np.random.default_rng(12)
    assert rs129._gen_poly() == j_rs129._gen_poly() == [0x40, 0x38, 0x0E, 1]
    for _ in range(100):
        data = bytes(rng.integers(0, 256, 9).tolist())
        parity = rs129.encode(data)
        assert parity == j_rs129.encode(data)
        word = bytearray(data + parity)
        for pos in rng.choice(12, int(rng.integers(0, 3)), replace=False):
            word[int(pos)] ^= int(rng.integers(1, 256))
        for mask in (0, rs129.MASK_VOICE_LC_HEADER,
                     rs129.MASK_TERMINATOR_WITH_LC):
            assert rs129.check(bytes(word), mask=mask) == \
                j_rs129.check(bytes(word), mask=mask)
    assert rs129.MASK_VOICE_LC_HEADER == j_rs129.MASK_VOICE_LC_HEADER
    assert rs129.MASK_TERMINATOR_WITH_LC == j_rs129.MASK_TERMINATOR_WITH_LC


def test_utils_equal_jax():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 256, (2, 40)).astype(np.uint8)
    assert utils.hamming_distance(a, b) == j_utils.hamming_distance(a, b)
    c = utils.Coordinate(48.123456789, -11.5)
    assert c.format() == j_utils.Coordinate(48.123456789, -11.5).format()
    assert c == utils.Coordinate(48.123456789, -11.5) and c != 3
    assert repr(c) == repr(j_utils.Coordinate(48.123456789, -11.5))
    raw = bytes(range(160, 256))
    assert utils.convert_to_utf8(raw) == j_utils.convert_to_utf8(raw)
    assert not hasattr(utils, "env_flag")  # the port parses no env flags


def test_dump_hex(capsys):
    utils.dump_hex(bytes(range(40)), prefix="> ")
    ours = capsys.readouterr().err
    j_utils.dump_hex(bytes(range(40)), prefix="> ")
    assert ours == capsys.readouterr().err and ours.count("\n") == 3


# --- components -----------------------------------------------------------

def test_constants_are_the_jax_package_s():
    for name in ("SYNC_SIZE", "CACH_SIZE", "FRAME_SIZE", "SYNC_OFFSET"):
        assert getattr(constants, name) == getattr(j_phases, name)
        assert getattr(phases, name) == getattr(j_phases, name)
    for name in ("BS_DATA_SYNC", "BS_VOICE_SYNC", "MS_DATA_SYNC",
                 "MS_VOICE_SYNC"):
        assert np.array_equal(getattr(phases, name), getattr(j_phases, name))
        assert getattr(phases, name) is getattr(constants, name)
    assert np.array_equal(components.TACT_POSITIONS, j_comp.TACT_POSITIONS)
    assert components.TACT_POSITIONS is constants.TACT_POSITIONS
    public = [n for n in dir(j_comp) if n.isupper()
              and not isinstance(getattr(j_comp, n), JBlockCode)]
    assert public and all(
        np.array_equal(getattr(components, n), getattr(j_comp, n))
        for n in public)


def test_frame_components_equal_jax():
    """Cach, Emb, SlotType, Lc and EmbeddedCollector on random words."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        dib = rng.integers(0, 4, 12).astype(np.uint8)
        ours, ref = components.Cach.parse(dib), j_comp.Cach.parse(dib)
        assert ours.has_tact() == ref.has_tact()
        assert ours.payload == ref.payload
        if ours.has_tact():
            assert (ours.tact.slot(), ours.tact.is_busy(),
                    ours.tact.lcss()) == (ref.tact.slot(),
                                          ref.tact.is_busy(),
                                          ref.tact.lcss())
        w16 = int(rng.integers(0, 1 << 16))
        emb, j_emb = components.Emb.parse(w16), j_comp.Emb.parse(w16)
        assert (emb is None) == (j_emb is None)
        if emb is not None:
            assert (emb.color_code(), emb.lcss()) == (j_emb.color_code(),
                                                      j_emb.lcss())
        w20 = int(rng.integers(0, 1 << 20))
        st, j_st = (components.SlotType.parse(w20),
                    j_comp.SlotType.parse(w20))
        assert (st is None) == (j_st is None)
        if st is not None:
            assert (st.color_code(), st.data_type()) == (
                j_st.color_code(), j_st.data_type())
    seen = 0
    for i in range(60):
        lc9 = bytes(rng.integers(0, 256, 9).tolist())
        frags = embedded_fragments(lc9)
        ours, ref = components.EmbeddedCollector(), j_comp.EmbeddedCollector()
        for k, frag in enumerate(frags):
            if i % 3 == 1 and k == 2:  # corrupt some beyond correction
                frag = bytes(b ^ 0x5A for b in frag)
            elif i % 3 == 2 and k == 1:  # and some within it
                frag = bytes([frag[0] ^ 0x80]) + frag[1:]
            ours.collect(frag)
            ref.collect(frag)
        lc, j_lc = ours.get_lc(), ref.get_lc()
        assert (lc is None) == (j_lc is None)
        if lc is not None:
            seen += 1
            assert (lc.opcode(), lc.feature_set_id(), lc.source(),
                    lc.target(), lc.payload()) == (
                j_lc.opcode(), j_lc.feature_set_id(), j_lc.source(),
                j_lc.target(), j_lc.payload())
    assert 20 <= seen < 60


def _lc_matrix(block: bytes) -> list:
    """The 8 x 16 matrix of 16 interleaved embedded LC bytes: row k bit
    15-j is bit 7-k of byte j (rows 0-6 Hamming(16,11), row 7 parity)."""
    return [sum(((block[j] >> (7 - k)) & 1) << (15 - j) for j in range(16))
            for k in range(8)]


def _lc_interleave(matrix: list) -> bytes:
    return bytes(sum(((matrix[k] >> (15 - j)) & 1) << (7 - k)
                     for k in range(8)) for j in range(16))


def _lc_block(rng) -> tuple[bytes, bytes]:
    """(a seeded LC's 9 bytes, its 16 valid interleaved bytes)."""
    lc9 = bytes(rng.integers(0, 256, 9).tolist())
    return lc9, b"".join(embedded_fragments(lc9))


def _quarters(block: bytes, n: int = 4) -> list:
    return [block[4 * i:4 * i + 4] for i in range(n)]


ANY = object()  # a scenario whose outcome only has to equal JAX's


def _lc_scenarios(case: str, rng):
    """Yield (stale, fragments, want): ``stale``, 16 bytes a previous
    superframe left in the collector, or None; the fragments collected
    after a reset; ``want``, the LC's 9 bytes, None, or ANY."""
    if case == "single_flips":
        # every one of the 128 bits: a flip in rows 0-6 is corrected, one
        # in the parity row fails the column parity
        for _ in range(6):
            lc9, block = _lc_block(rng)
            for j in range(16):
                for k in range(8):
                    flipped = bytearray(block)
                    flipped[j] ^= 0x80 >> k
                    yield None, _quarters(flipped), lc9 if k < 7 else None
    elif case == "double_flips":
        for _ in range(2):
            _, block = _lc_block(rng)
            for k in range(8):
                for j1 in range(16):
                    for j2 in range(j1 + 1, 16):
                        flipped = bytearray(block)
                        flipped[j1] ^= 0x80 >> k
                        flipped[j2] ^= 0x80 >> k
                        yield None, _quarters(flipped), None
    elif case == "parity_row":
        # rows 0-6 valid, the parity row off in 1-16 bits
        for _ in range(200):
            lc9, block = _lc_block(rng)
            m = _lc_matrix(block)
            m[7] ^= int(rng.integers(1, 1 << 16))
            yield None, _quarters(_lc_interleave(m)), None
    elif case == "checksum":
        # every row a codeword and the parity right, one checksum bit
        # (bit 5 of rows 2-6) flipped and its row re-encoded
        for i in range(200):
            lc9, block = _lc_block(rng)
            m = _lc_matrix(block)
            row = 2 + i % 5
            m[row] = int(codes.HAMMING_16_11.encode((m[row] ^ 0x20) >> 5))
            m[7] = m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4] ^ m[5] ^ m[6]
            assert _lc_matrix(_lc_interleave(m)) == m
            yield None, _quarters(_lc_interleave(m)), None
    elif case == "offsets":
        # 0-5 fragments collected (a fifth is ignored); at 3 the fourth
        # fragment is what the previous superframe left: its own (decodes)
        # or another LC's (fails)
        for _ in range(40):
            lc9, block = _lc_block(rng)
            _, other = _lc_block(rng)
            for n in range(6):
                frags = _quarters(block + block[:4], n)
                short = None if n < 3 else ANY
                yield None, frags, lc9 if n >= 4 else short
                yield block, frags, lc9 if n >= 3 else None
                yield other, frags, lc9 if n >= 4 else short
    elif case == "random":
        for _ in range(20_000):
            yield (None, _quarters(bytes(rng.integers(0, 256, 16).tolist())),
                   ANY)


LC_CASES = {"single_flips": {True, False}, "double_flips": {False},
            "parity_row": {False}, "checksum": {False},
            "offsets": {True, False}, "random": {False}}


@pytest.mark.parametrize("case", sorted(LC_CASES))
def test_embedded_lc_equals_jax(case):
    """The table-driven ``EmbeddedCollector.get_lc`` against the JAX
    package's bit-by-bit one: the same None or the same 9 bytes."""
    rng = np.random.default_rng(sorted(LC_CASES).index(case))
    seen, n = set(), 0
    for stale, frags, want in _lc_scenarios(case, rng):
        ours, ref = components.EmbeddedCollector(), j_comp.EmbeddedCollector()
        for c in (ours, ref):
            if stale is not None:
                for frag in _quarters(stale):
                    c.collect(frag)
                c.reset()
            for frag in frags:
                c.collect(frag)
        lc, j_lc = ours.get_lc(), ref.get_lc()
        got = None if lc is None else lc.data
        assert got == (None if j_lc is None else j_lc.data)
        if want is not ANY:
            assert got == want
        seen.add(got is not None)
        n += 1
    assert n and LC_CASES[case] <= seen


@pytest.mark.parametrize("fmt", range(4))
def test_talker_alias_and_gps_equal_jax(fmt):
    rng = np.random.default_rng(fmt)
    for length in (3, 6, 13, 27):
        ours, ref = (components.TalkerAliasCollector(),
                     j_comp.TalkerAliasCollector())
        body = bytes(rng.integers(32, 127, 27).tolist())
        blocks = bytes([(fmt << 6) | ((length & 31) << 1)]) + body
        for b in range(4):
            for col in (ours, ref):
                col.set_block(b, blocks[b * 7:b * 7 + 7])
            assert ours.is_complete() == ref.is_complete()
            assert ours.get_contents() == ref.get_contents()
    payload = bytes(rng.integers(0, 256, 7).tolist())
    assert components.Gps.parse(payload).format() == \
        j_comp.Gps.parse(payload).format()


# --- the phase machines ---------------------------------------------------

def _traffic(seed: int) -> np.ndarray:
    """One channel of DMR dibits: calls with embedded LC, talker alias and
    GPS, data frames, runs of voice sync frames, junk in between; every
    third seed with 1% dibit errors; seed 7 is pure noise."""
    rng = np.random.default_rng(seed)
    if seed == 7:
        return rng.integers(0, 4, 9000).astype(np.uint8)
    lcs = [group_lc(int(rng.integers(1, 1 << 24)),
                    int(rng.integers(1, 1 << 24)), opcode=int(op))
           for op in rng.choice([0, 3], 2)]
    lcs += [make_lc_bytes(4, bytes([(1 << 6) | (6 << 1)]) + b"N0CALL"),
            make_lc_bytes(8, bytes(rng.integers(0, 256, 7).tolist())),
            make_lc_bytes(9)]  # an opcode nobody handles
    parts = [rng.integers(0, 4, int(rng.integers(50, 400)))]
    for _ in range(5):
        kind = rng.integers(0, 4)
        lc = lcs[int(rng.integers(0, len(lcs)))]
        payload = rng.integers(0, 4, 108)
        if kind == 0:
            parts += [voice_frame(s % 2, payload, sync=True, ms=bool(s % 3))
                      for s in range(int(rng.integers(3, 9)))]
        elif kind == 1:
            parts += [data_frame(s % 2, int(rng.integers(0, 12)), lc)
                      for s in range(4)]
        elif kind == 2:
            slot = int(rng.integers(0, 2))
            parts += ([data_frame(slot, 1, lc)]
                      + voice_superframe(slot, lc, payload)
                      + [data_frame(slot, 2, lc)])
        else:
            parts.append(rng.integers(0, 4, int(rng.integers(10, 300))))
    dibits = np.concatenate([np.asarray(p, np.uint8) for p in parts])
    if seed % 3 == 2:
        hit = rng.random(len(dibits)) < 0.01
        dibits[hit] = rng.integers(0, 4, int(hit.sum()))
    return dibits


def _decode(make, writer_type, dibits, chunk, slot_filter=3):
    dec = make()
    dec.set_slot_filter(slot_filter)
    events = []
    dec.set_meta_writer(writer_type(lambda b: events.append(b)))
    out = b"".join(dec.process(dibits[lo:lo + chunk])
                   for lo in range(0, len(dibits), chunk))
    return out, b"".join(events)


@pytest.mark.parametrize("seed", range(10))
def test_decoder_equals_jax(seed):
    """SyncPhase/FramePhase through the Decoder, whole and in
    chunks: voice bytes and serialized events equal the JAX package's."""
    dibits = _traffic(seed)
    want = _decode(j_make_decoder, JWriter, dibits, len(dibits))
    assert _decode(make_decoder, PipelineMetaWriter, dibits,
                   len(dibits)) == want
    assert _decode(make_decoder, PipelineMetaWriter, dibits, 977) == want
    if seed != 7:
        assert want[1]


@pytest.mark.parametrize("slot_filter", [1, 2])
def test_decoder_slot_filter_equals_jax(slot_filter):
    dibits = np.concatenate([_traffic(s) for s in (0, 1, 3)])
    want = _decode(j_make_decoder, JWriter, dibits, 1500, slot_filter)
    assert _decode(make_decoder, PipelineMetaWriter, dibits, 1500,
                   slot_filter) == want


def test_sync_helpers_equal_jax():
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 4, 108).astype(np.uint8)
    assert phases.pack_dibits(payload) == j_phases.pack_dibits(payload)
    for pattern in (phases.BS_DATA_SYNC, phases.MS_VOICE_SYNC):
        for flips in (0, 1, 2):
            w = pattern.copy()
            w[:flips] ^= 3  # 2 bits each
            assert phases.get_sync_type(w) == j_phases.get_sync_type(w)
    noise = rng.integers(0, 4, 24).astype(np.uint8)
    assert phases.get_sync_type(noise) == j_phases.get_sync_type(noise) == -1
    assert (phases.SYNCTYPE_DATA, phases.SYNCTYPE_VOICE) == (
        j_phases.SYNCTYPE_DATA, j_phases.SYNCTYPE_VOICE)


@pytest.mark.parametrize("seed", range(6))
def test_fields_frame_phase_equals_jax(seed):
    """The frames of a stream cut at its first sync, decoded to fields by
    each package's own ``dmr_decode_frames`` and adapter, through each
    package's FieldsFramePhase: the same voice bytes, lock losses and
    events frame by frame."""
    dibits = _traffic(seed)
    hunt = phases.SyncPhase()
    start = 0
    while start + hunt.required_data() < len(dibits):
        nxt, consumed = hunt.process(dibits[start:], None)
        start += consumed
        if nxt is not None:
            break
    n = (len(dibits) - start) // 144
    assert n >= 5
    frames = dibits[start:start + n * 144].reshape(n, 144)
    pipe = DmrPipeline(channels=1, device="cpu")
    host = DmrAdapter().decode_fields(frames, pipe)
    j_host = JAdapter().decode_fields(frames, jnp)
    assert sorted(host) == sorted(j_host)
    for k in host:
        assert host[k].dtype == j_host[k].dtype, k
        assert np.array_equal(host[k], j_host[k]), k
    direct = {k: np.asarray(v)
              for k, v in j_decode_frames(jnp.asarray(frames)).items()}
    assert np.array_equal(direct["bptc_ok"], host["bptc_ok"])

    events, j_events = [], []
    meta, j_meta = MetaCollector(), JMetaCollector()
    meta.set_writer(PipelineMetaWriter(events.append))
    j_meta.set_writer(JWriter(j_events.append))
    ours, ref = FieldsFramePhase(meta), JFieldsFramePhase(j_meta)
    for row in range(n):
        got = ours.process_fields(DmrAdapter().field_row(host, row))
        want = ref.process_fields(JAdapter().field_row(j_host, row))
        assert got == want, row
        assert events == j_events, row
        if got[1]:
            break


def test_meta_writers_and_serializer(tmp_path):
    data = {"b": 2, "a": "x", "protocol": "DMR"}
    assert StringSerializer.serialize(data) == b"a:x;b:2;protocol:DMR\n"
    path = tmp_path / "meta.fifo"
    writer = FileMetaWriter(str(path))
    writer.send_metadata(data)
    writer.close()
    assert path.read_bytes() == b"a:x;b:2;protocol:DMR\n"
    meta = MetaCollector()
    seen = []
    meta.set_writer(PipelineMetaWriter(seen.append))
    meta.with_slot(0, lambda s: s.set_sync(2))
    meta.with_slot(0, lambda s: s.set_sync(2))  # no change: no event
    meta.with_slot(1, lambda s: s.set_source(7))
    assert seen == [b"protocol:DMR;slot:0;sync:voice\n",
                    b"protocol:DMR;slot:1;source:7\n"]


@pytest.mark.parametrize("cls", [GfskDemodNp, FskDemodNp])
def test_host_demod_oracle_equals_jax(cls):
    from digiham_tpu.dsp import demod as j_demod

    rng = np.random.default_rng(4)
    levels = np.array([1, 3, -1, -3]) / 3 if cls is GfskDemodNp \
        else np.array([-1.0, 1.0])
    sym = rng.integers(0, len(levels), 450)
    x = (np.repeat(levels[sym], 10) * 900
         + rng.normal(0, 40, 4500)).astype(np.float32)
    ours = cls(10)
    ref = getattr(j_demod, cls.__name__)(10)
    for o in (ours, ref):
        o.pos, o.variance_offset = 3, 1
    assert np.array_equal(ours.process(x), ref.process(x))
    assert (ours.pos, ours.variance_offset) == (ref.pos, ref.variance_offset)
    assert np.array_equal(ours.volume_rb, ref.volume_rb)
    inv = FskDemodNp(10, invert=True).process(x)
    assert np.array_equal(inv, j_demod.FskDemodNp(10, invert=True).process(x))
