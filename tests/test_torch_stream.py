"""The port's single-stream codec against the JAX package's XLA codec.

``lzw_tpu_torch.ops.decode`` (pass 1, pass 2, ``decode_block``),
``lzw_tpu_torch.ops.encode.encode_stream_bytes`` and
``lzw_tpu_torch.ops.bitpack`` on CPU tensors (the kernels' plain versions)
against ``lzw_tpu.ops.decode`` / ``encode`` / ``bitpack`` on JAX's CPU
backend, on the same inputs made with numpy from a seed; then the
container's big-block route (``pass2="device"`` past ``MAX_BLOCK``)
against the JAX codec and the native runtime.  Every value is an integer:
tolerance 0, every output field compared whole.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.ops import bitpack as jbitpack
from lzw_tpu.ops import decode as jdecode
from lzw_tpu.ops import encode as jencode
from lzw_tpu.ops import reference as joracle
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import CodeSizeStrategy as JStrategy
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

import lzw_tpu_torch.parallel.block as block
from lzw_tpu_torch import (
    BlockParallelCodec, Endianness, MissingClearCodeError,
    TruncatedStreamError, UnexpectedCodeError, from_reference_spec,
)
from lzw_tpu_torch.kernels.decode import MAX_BLOCK
from lzw_tpu_torch.kernels.schedule import Schedule
from lzw_tpu_torch.native.runtime import NativeRuntime, get_runtime
from lzw_tpu_torch.ops import bitpack, decode, encode
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, MAX_WIDTH
from lzw_tpu_torch.utils.testdata import uninit_literal_stream

SPECS = {
    "gif2": JSpec.gif(2),
    "gif7": JSpec.gif(7),
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
    # VariableCodec with the early-change strategy.
    "var4_be_tiff": JSpec.variable(4, JEndianness.BIG, JStrategy.TIFF),
}
# The reference's crafted corrupt TIFF stream (`decoder.rs:758-769`).
CORRUPT_TIFF = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60,
                      0x54])


def _random(spec, n, seed):
    hi = (1 << spec.code_size) if spec.variable else 256
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n).astype(np.uint8).tobytes()


def _missing_clear_stream():
    """tests/test_decode_jax.py's table overflow without a CLEAR."""
    codes = [(0, 9)]
    width, next_index = 9, 258
    for _ in range(4096 - 258 + 2):
        codes.append((1, width))
        next_index += 1
        if next_index == (1 << width) and width < 12:
            width += 1
    return joracle.pack_codes(codes, JEndianness.LITTLE)


def _streams(name):
    """(label, stream, spec) cases of one flavor: lengths 0, 1, around
    powers of two, a run-heavy (KwKwK) one, several CLEARs, and its
    truncations."""
    spec = SPECS[name]
    out = []
    for n in (0, 1, 255, 256, 257, 1000):
        out.append((f"n{n}", joracle.encode_bytes(_random(spec, n, n), spec)))
    runs = bytes([1] * 400 + [2] * 200 + [1, 2, 3] * 100)
    out.append(("kwkwk", joracle.encode_bytes(runs, spec)))
    # Random bytes of the full alphabet fill the table: resets (CLEARs) in
    # the variable flavors, a frozen table in the fixed one.
    many = joracle.encode_bytes(_random(spec, 40000, 7), spec)
    out.append(("clears", many))
    out.append(("truncated", many[: len(many) // 2]))
    return out


def _jax_pass1(stream, n_valid, spec, M):
    buf = np.zeros(M, np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)
    return buf, jdecode.decode_pass1(jnp.asarray(buf), jnp.int32(n_valid),
                                     spec)


def _rows(bufs, n_valid):
    return (torch.from_numpy(np.stack(bufs)),
            torch.tensor(n_valid, dtype=torch.int32))


def _assert_pass1_equal(jax_p1, port_p1, row):
    for key, want in jax_p1.items():
        got = port_p1[key][row].numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _bucket(n):
    """A power-of-two row width >= n (>= 256), as the JAX facade pads."""
    b = 256
    while b < n:
        b <<= 1
    return b


@pytest.mark.parametrize("name", list(SPECS))
def test_pass1_matches_jax(name):
    spec = SPECS[name]
    port_spec = from_reference_spec(spec)
    rng = np.random.default_rng(len(name))
    for label, stream in _streams(name):
        M = _bucket(len(stream) + 1)
        buf, want = _jax_pass1(stream, len(stream), spec, M)
        # Garbage past n_valid must not matter.
        buf[len(stream):] = rng.integers(0, 256, M - len(stream))
        got = decode.decode_pass1(*_rows([buf], [len(stream)]), port_spec)
        _assert_pass1_equal(want, got, 0)
        assert got["total_len"].dtype == torch.int64, label


def _wire_codes(stream, jspec):
    """The codes the JAX reference decoder reads from a clean stream, in
    order, without its CLEARs and EOI: one a word."""
    if not jspec.variable:
        return joracle.unpack_codes_fixed(stream, MAX_WIDTH, jspec.endianness)
    read = []
    cursor = joracle._BitCursor.read

    def recording(self, width):
        read.append(cursor(self, width))
        return read[-1]

    joracle._BitCursor.read = recording
    try:
        joracle.decode_bytes(stream, jspec)
    finally:
        joracle._BitCursor.read = cursor
    return [c for c in read if c not in (jspec.clear_code, jspec.end_code)]


@pytest.mark.parametrize("name", list(SPECS))
def test_pass1_out_code_is_the_wire_code(name):
    # out_code, which the JAX pass 1 lacks, against the reference decoder's
    # reads: each word's code, 0 at the slots without a word; a literal
    # after a CLEAR that reads an entry never inserted keeps its code
    # where glocal[out_g] names 0.
    spec = SPECS[name]
    port_spec = from_reference_spec(spec)
    cases = [(label, s) for label, s in _streams(name)
             if label != "truncated"]
    if spec.variable:
        cases.append(("uninit", uninit_literal_stream(port_spec, 3000)[0]))
    for label, stream in cases:
        M = _bucket(len(stream) + 1)
        buf = np.zeros(M, np.uint8)
        buf[: len(stream)] = np.frombuffer(stream, np.uint8)
        got = decode.decode_pass1(*_rows([buf], [len(stream)]), port_spec)
        assert got["out_code"].dtype == torch.int16, label
        words = got["out_len"][0] > 0
        codes = got["out_code"][0]
        assert codes[words].tolist() == _wire_codes(stream, spec), label
        assert not codes[~words].any(), label
        if label == "uninit":
            literal = torch.nonzero(words)[-1, 0]
            assert codes[literal] == (1 << port_spec.initial_width) - 1
            assert got["glocal"][0][got["out_g"][0][literal]] == 0


@pytest.mark.parametrize("name", ["gif7", "tiff", "fixed_be"])
def test_pass1_rows_are_independent(name):
    # One batched call equals the JAX function row by row.
    spec = SPECS[name]
    cases = [s for _, s in _streams(name)]
    M = _bucket(max(len(s) for s in cases))
    bufs, wants = [], []
    for s in cases:
        buf, want = _jax_pass1(s, len(s), spec, M)
        bufs.append(buf)
        wants.append(want)
    got = decode.decode_pass1(*_rows(bufs, [len(s) for s in cases]),
                              from_reference_spec(spec))
    for i, want in enumerate(wants):
        _assert_pass1_equal(want, got, i)


ERROR_CASES = {
    "unexpected_code": (CORRUPT_TIFF, JSpec.tiff()),
    "truncated": (joracle.encode_bytes(bytes([1] * 100), JSpec.gif(2))[:-1],
                  JSpec.gif(2)),
    "missing_clear": (_missing_clear_stream(),
                      JSpec.variable(8, JEndianness.LITTLE)),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_streams_match_jax(case):
    # tests/test_decode_jax.py:94-147: pass 1, pass 2 and decode_block.
    stream, spec = ERROR_CASES[case]
    port_spec = from_reference_spec(spec)
    M = len(stream)
    buf, want = _jax_pass1(stream, M, spec, M)
    got = decode.decode_pass1(*_rows([buf], [M]), port_spec)
    _assert_pass1_equal(want, got, 0)
    out_bound = 64
    jres = jdecode.decode_block(jnp.asarray(buf), jnp.int32(M), spec,
                                out_bound)
    pres = decode.decode_block(*_rows([buf], [M]), port_spec, out_bound)
    for key in ("out", "total_len", "error", "error_code"):
        np.testing.assert_array_equal(pres[key][0].numpy(),
                                      np.asarray(jres[key]), err_msg=key)
    if case == "unexpected_code":
        assert int(pres["error"][0]) == decode.ERR_UNEXPECTED_CODE
        assert int(pres["error_code"][0]) == 258


@pytest.mark.parametrize("case", ["golden", "corrupt_chain", "clipped",
                                  "clears"])
def test_pass2_matches_jax(case, lorem_ipsum_encoded):
    spec = {"golden": JSpec.gif(7), "corrupt_chain": JSpec.tiff(),
            "clipped": JSpec.gif(7), "clears": JSpec.gif(2)}[case]
    stream = {"golden": lorem_ipsum_encoded, "corrupt_chain": CORRUPT_TIFF,
              "clipped": lorem_ipsum_encoded,
              "clears": joracle.encode_bytes(_random(spec, 9000, 3), spec)
              }[case]
    M = _bucket(len(stream))
    buf, jp1 = _jax_pass1(stream, len(stream), spec, M)
    p1 = decode.decode_pass1(*_rows([buf], [len(stream)]),
                             from_reference_spec(spec))
    total = int(jp1["total_len"])
    out_bound = {"corrupt_chain": 64, "clipped": total // 3}.get(
        case, max(total, 1))
    keys = ("gprefix", "gsuffix", "glocal", "out_g", "out_len", "out_off",
            "out_lit")
    want = jdecode.decode_pass2(*(jp1[k] for k in keys), out_bound,
                                spec.alphabet_size)
    got = decode.decode_pass2(*(p1[k] for k in keys), out_bound,
                              spec.alphabet_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    if case == "corrupt_chain":
        assert int(got[1][0]) < decode.NO_ERROR_STEP
    else:
        assert int(got[1][0]) == decode.NO_ERROR_STEP


def test_pass1_step_bound_matches_jax():
    for spec in SPECS.values():
        for n in (0, 1, 7, 4096, 1 << 20):
            assert decode.pass1_step_bound(
                n, from_reference_spec(spec)) == jdecode.pass1_step_bound(
                    n, spec)
    assert (decode.ERR_NONE, decode.ERR_UNEXPECTED_CODE,
            decode.ERR_MISSING_CLEAR, decode.ERR_TRUNCATED) == (
        jdecode.ERR_NONE, jdecode.ERR_UNEXPECTED_CODE,
        jdecode.ERR_MISSING_CLEAR, jdecode.ERR_TRUNCATED)


def test_wrappers_reject_other_devices_and_shapes():
    spec = from_reference_spec(JSpec.gif(7))
    meta = torch.empty((1, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode.decode_pass1(meta, torch.empty(1, dtype=torch.int32,
                                              device="meta"), spec)
    with pytest.raises(ValueError, match="rows"):
        decode.decode_pass1(torch.zeros((2, 8), dtype=torch.uint8),
                            torch.zeros(3, dtype=torch.int32), spec)
    with pytest.raises(TypeError):
        decode.decode_pass1(torch.zeros((1, 8), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), spec)


def test_check_offsets():
    decode.check_offsets(torch.tensor([0, 2**31 - 1]))
    with pytest.raises(ValueError, match="i32 word offsets"):
        decode.check_offsets(torch.tensor([5, 2**31]))


# ---- bitpack ----------------------------------------------------------------

@pytest.mark.parametrize("width", range(2, 13))
@pytest.mark.parametrize("endian", ["little", "big"])
def test_bitpack_matches_jax(endian, width):
    jend = JEndianness(endian)
    end = Endianness(endian)
    rng = np.random.default_rng(5)
    widths = rng.integers(0, width + 1, 500)
    widths[rng.random(500) < 0.2] = 0  # holes
    codes = rng.integers(0, 1 << 16, 500)  # bits past the width are masked
    n_bits = int(widths.sum())
    out_bytes = (n_bits + 7) // 8 + 5
    want, want_n = jbitpack.pack_codes_jax(
        jnp.asarray(codes, jnp.int32), jnp.asarray(widths, jnp.int32), jend,
        out_bytes)
    got, got_n = bitpack.pack_codes_torch(torch.from_numpy(codes),
                                          torch.from_numpy(widths), end,
                                          out_bytes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)
    np_bytes = bitpack.pack_codes_np(codes, widths, end)
    np.testing.assert_array_equal(
        np_bytes, jbitpack.pack_codes_np(codes, widths, jend))
    np.testing.assert_array_equal(np_bytes, got.numpy()[: int(got_n)])
    assert bitpack.packed_size(n_bits) == jbitpack.packed_size(n_bits)
    data = rng.integers(0, 256, 301).astype(np.uint8)
    n_codes = (8 * len(data)) // width
    want = jbitpack.unpack_fixed_jax(jnp.asarray(data), width, jend, n_codes)
    got = bitpack.unpack_fixed_torch(torch.from_numpy(data), width, end,
                                     n_codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        bitpack.unpack_fixed_np(data, width, end),
        jbitpack.unpack_fixed_np(data, width, jend))


@pytest.mark.parametrize("width", range(2, 13))
@pytest.mark.parametrize("endian", ["little", "big"])
def test_bit_order_helpers_match_jax(endian, width):
    """The bit order of ``ops.bitpack``'s helpers, at every shift in a
    byte, on Python ints, numpy and torch, against the JAX package's
    ``pack_codes_np`` and ``unpack_fixed_np``."""
    little = endian == "little"
    jend = JEndianness(endian)
    rng = np.random.default_rng(width)
    values = rng.integers(0, 1 << width, 16)
    for sh in range(8):
        # The bytes of a symbol ``sh`` bits into its first byte: a zero
        # code of ``sh`` bits before it (a hole at 0), three bytes in all.
        want = np.stack([
            np.pad(jbitpack.pack_codes_np(np.array([0, v]),
                                          np.array([sh, width]), jend),
                   (0, 3))[:3] for v in values]).astype(np.int64)
        for i, v in enumerate(values):
            window = bitpack.place_symbol(int(v), sh, width, little)
            assert bitpack.split_lanes(window, little) == tuple(want[i])
            assert bitpack.join_lanes(tuple(int(b) for b in want[i]),
                                      little) == window
            assert bitpack.read_symbol(window, sh, width, little) == v
        for as_array in (np.asarray, torch.from_numpy):
            v = as_array(values)
            window = bitpack.place_symbol(v, sh, width, little)
            lanes = bitpack.split_lanes(window, little)
            np.testing.assert_array_equal(
                np.stack([np.asarray(b) for b in lanes], 1), want)
            assert (bitpack.join_lanes(lanes, little) == window).all()
            got = bitpack.join_lanes(
                tuple(as_array(b) for b in want.T.copy()), little)
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(window))
            np.testing.assert_array_equal(
                np.asarray(bitpack.read_symbol(got, sh, width, little)),
                values)
    # Whole fixed-width streams: a code at every multiple of the width.
    data = rng.integers(0, 256, 301)
    bit = np.arange((8 * len(data)) // width) * width
    padded = np.pad(data, (0, 2))
    b0 = bit >> 3
    window = bitpack.join_lanes((padded[b0], padded[b0 + 1], padded[b0 + 2]),
                                little)
    np.testing.assert_array_equal(
        bitpack.read_symbol(window, bit & 7, width, little),
        jbitpack.unpack_fixed_np(data.astype(np.uint8), width, jend))
    if width == 12:
        # A fixed-12 code pair is one window of two 12-bit lanes.
        pair = rng.integers(0, 1 << 12, (16, 2))
        want = np.stack([jbitpack.pack_codes_np(p, np.array([12, 12]), jend)
                         for p in pair]).astype(np.int64)
        lanes = bitpack.split_lanes(
            bitpack.join_lanes((pair[:, 0], pair[:, 1]), little, bits=12),
            little)
        np.testing.assert_array_equal(np.stack(lanes, 1), want)
        codes = bitpack.split_lanes(
            bitpack.join_lanes(tuple(want.T.copy()), little), little, n=2,
            bits=12)
        np.testing.assert_array_equal(np.stack(codes, 1), pair)


# ---- encode -----------------------------------------------------------------

def _jax_encode(data, spec, fix):
    B = _bucket(max(1, len(data)))
    blk = np.zeros(B, np.uint8)
    blk[: len(data)] = np.frombuffer(data, np.uint8)
    res = jencode.encode_block(jnp.asarray(blk), jnp.int32(len(data)), spec,
                               fix_eoi_width=fix)
    buf, n = jbitpack.pack_codes_jax(res["codes"], res["widths"],
                                     spec.endianness,
                                     jencode.packed_bound(B, spec))
    return bytes(np.asarray(buf)[: int(n)])


def _quirk_input(spec):
    """A short seeded input whose stream has the EOI width quirk, and whose
    bytes the wider EOI changes (in LSB order the extra bit may fall in
    the last byte's padding)."""
    port = from_reference_spec(spec)
    for seed in range(20):
        for n in range(2, 600):
            data = _random(spec, n, seed)
            if oracle.eoi_width_quirk(oracle.encode_codes(data, port),
                                      port) and (
                    _jax_encode(data, spec, False)
                    != _jax_encode(data, spec, True)):
                return data
    raise AssertionError("no quirk input found")


@pytest.mark.parametrize("fix", [False, True], ids=["salzweg", "fix_eoi"])
@pytest.mark.parametrize("name", ["gif2", "gif7", "tiff", "fixed_le",
                                  "var4_be_tiff"])
def test_encode_stream_bytes_matches_jax(name, fix):
    spec = SPECS[name]
    port_spec = from_reference_spec(spec)
    datas = [_random(spec, n, n) for n in (0, 1, 2, 257, 3000)]
    if spec.variable:
        datas.append(_quirk_input(spec))
    for data in datas:
        got = encode.encode_stream_bytes(data, port_spec, fix_eoi_width=fix,
                                         device="cpu")
        assert got == _jax_encode(data, spec, fix), len(data)
    if spec.variable:
        # The quirk case is where the two settings differ.
        quirk = datas[-1]
        assert (_jax_encode(quirk, spec, False)
                != _jax_encode(quirk, spec, True))
        assert encode.encode_stream_bytes(
            quirk, port_spec, device="cpu") == oracle.encode_bytes(
                quirk, port_spec)


def _walked_schedule(spec, n_max):
    """The wire schedule by a walk over every ordinal: the encoder's width
    and next index per data code, a CLEAR where the table fills."""
    widths, clear_after = np.empty(n_max, np.int64), np.zeros(n_max, bool)
    nxt_of, epoch_start = np.empty(n_max, np.int64), np.empty(n_max, np.int64)
    width, nxt, start = spec.initial_width, spec.first_free_code, 0
    for m in range(n_max):
        widths[m], nxt_of[m], epoch_start[m] = width, nxt, start
        new_index, nxt = nxt, nxt + 1
        if new_index == (1 << width) - spec.strategy.increment:
            if width < MAX_WIDTH:
                width += 1
            else:
                clear_after[m] = True
                width, nxt, start = spec.initial_width, spec.first_free_code, (
                    m + 1)
    return widths, clear_after, nxt_of, epoch_start, width


@pytest.mark.parametrize("name", ["gif2", "gif7", "tiff", "var4_be_tiff"])
def test_schedule_tables_equal_the_walk_over_every_ordinal(name):
    spec = from_reference_spec(SPECS[name])
    # Data codes in one epoch of a full table.
    period = MAX_TABLE_SIZE - spec.strategy.increment - (
        spec.first_free_code) + 1
    for n_max in (1, 2, period - 1, period, period + 1, 3 * period + 17):
        sched = Schedule(spec, n_max)
        widths, clear_after, nxt_of, epoch_start, last = _walked_schedule(
            spec, n_max)
        np.testing.assert_array_equal(sched.widths, widths)
        np.testing.assert_array_equal(sched.clear_after, clear_after)
        np.testing.assert_array_equal(sched.nxt_of, nxt_of)
        np.testing.assert_array_equal(sched.epoch_start, epoch_start)
        assert sched.next_width[n_max] == last, n_max
        assert sched.bit_off[-1] == spec.initial_width + int(
            (widths + MAX_WIDTH * clear_after).sum())


def test_encode_stream_bytes_errors():
    spec = from_reference_spec(JSpec.gif(2))
    with pytest.raises(UnexpectedCodeError) as ei:
        encode.encode_stream_bytes(bytes([0, 1, 8, 3]), spec, device="cpu")
    assert (ei.value.code, ei.value.code_size) == (8, 2)


def test_encoder_helpers_match_jax():
    for bs in (0, 1, 4096, 1 << 20):
        assert encode.encoder_output_slots(bs) == jencode.encoder_output_slots(
            bs)
        for spec in SPECS.values():
            assert encode.packed_bound(bs, from_reference_spec(
                spec)) == jencode.packed_bound(bs, spec)


# ---- big-block container on the CPU ---------------------------------------

BIG = 1 << 18  # 256 KiB, past MAX_BLOCK


def _fail_native(monkeypatch):
    """Make every call of the native runtime's decode entry points fail."""
    def host_called(*args, **kwargs):
        raise AssertionError("the big-block route called the native runtime")

    for name in ("decode", "decode_blocks", "apply_words"):
        monkeypatch.setattr(NativeRuntime, name, host_called)


@pytest.fixture
def no_host(monkeypatch):
    _fail_native(monkeypatch)


def _big_container(spec, data):
    payloads = get_runtime().encode_blocks(data, spec, BIG)
    return framing.pack_frame(spec, BIG, len(data), payloads), payloads


@pytest.mark.parametrize("name", ["gif7", "tiff", "fixed_le"])
def test_big_block_container_matches_jax_and_native(name, tokyo_pixels):
    spec = SPECS[name]
    port_spec = from_reference_spec(spec)
    assert BIG > MAX_BLOCK
    data = (tokyo_pixels * 2)[: BIG + 5000]  # a full block and a short one
    if spec.variable:
        data = bytes(b % port_spec.alphabet_size for b in data)
    container, payloads = _big_container(port_spec, data)
    assert get_runtime().decode_blocks(payloads, port_spec, BIG) == data
    if name == "gif7":  # the JAX codec's lax decode, ~15 s a container
        assert JaxCodec(spec, block_size=BIG).decode(container) == data
    stages = {}
    codec = BlockParallelCodec(port_spec, block_size=BIG, device="cpu",
                               pass2="device", stage_times=stages)
    with pytest.MonkeyPatch.context() as mp:
        _fail_native(mp)
        assert codec.decode(container) == data
        assert codec.decode_range(container, 1, 2) == data[BIG:]
    assert "dec_stream" in stages


def test_big_blocks_auto_without_runtime(monkeypatch, no_host, tokyo_pixels):
    spec = from_reference_spec(JSpec.gif(7))
    data = bytes(b % 128 for b in tokyo_pixels[: BIG + 10])
    payloads = [oracle.encode_bytes(data[:BIG], spec),
                oracle.encode_bytes(data[BIG:], spec)]
    container = framing.pack_frame(spec, BIG, len(data), payloads)

    def cannot_build():
        raise OSError("g++: not found")

    monkeypatch.setattr(block, "get_runtime", cannot_build)
    codec = BlockParallelCodec(spec, block_size=BIG, device=["cpu", "cpu"])
    assert codec.decode(container) == data


def test_big_blocks_raise_in_block_order(no_host, tokyo_pixels):
    spec = from_reference_spec(JSpec.tiff())
    data = tokyo_pixels[: 3 * BIG]
    rt = get_runtime()
    good = rt.encode_blocks(data, spec, BIG)
    codec = BlockParallelCodec(spec, block_size=BIG, device=["cpu"] * 2,
                               pass2="device")
    # Block 2 (second range) is truncated, block 1 (first range) corrupt.
    cut = good[:2] + [good[2][: len(good[2]) // 2]]
    with pytest.raises(TruncatedStreamError):
        codec.decode(framing.pack_frame(spec, BIG, len(data), cut))
    bad = [good[0], CORRUPT_TIFF] + cut[2:]
    with pytest.raises(UnexpectedCodeError) as ei:
        codec.decode(framing.pack_frame(spec, BIG, len(data), bad))
    assert ei.value.code == 258
    # A payload that decodes to another length than the frame's.
    short = framing.pack_frame(spec, BIG, len(data), good[:1] + [
        rt.encode(data[BIG : 2 * BIG - 1], spec), good[2]])
    with pytest.raises(framing.FramingError, match="block 1"):
        codec.decode(short)
    missing = _missing_clear_stream()
    with pytest.raises(MissingClearCodeError):
        BlockParallelCodec(from_reference_spec(JSpec.variable(
            8, JEndianness.LITTLE)), block_size=BIG, device="cpu",
            pass2="device").decode(framing.pack_frame(
                from_reference_spec(JSpec.variable(8, JEndianness.LITTLE)),
                BIG, 10, [missing]))


def test_big_blocks_host_route_keeps_decode_blocks(monkeypatch, tokyo_pixels):
    spec = from_reference_spec(JSpec.gif(7))
    data = bytes(b % 128 for b in tokyo_pixels[: BIG + 3])
    container, _ = _big_container(spec, data)
    calls = []
    real = NativeRuntime.decode_blocks

    def counted(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(NativeRuntime, "decode_blocks", counted)
    for route in ("host", "auto"):
        codec = BlockParallelCodec(spec, block_size=BIG, device="cpu",
                                   pass2=route)
        assert codec.decode(container) == data
    assert len(calls) == 2
