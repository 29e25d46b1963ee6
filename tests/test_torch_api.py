"""The port's single-stream facades against the JAX package's.

Mirrors tests/test_api.py and tests/test_streaming.py for the port's two
backends, "native" (the C++ runtime) and "oracle" (the port's copy of the
scalar oracle): the reference's doctest vectors, the golden file, every
error type and message, the stream API at several chunk sizes and the
bounded decoder.  Bytes are compared exactly with ``lzw_tpu.api`` on the
same inputs for every flavor.
"""

import io

import numpy as np
import pytest

from lzw_tpu import api as japi
from lzw_tpu.ops import reference as joracle
from lzw_tpu.spec import CodeSizeStrategy as JStrategy
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

import lzw_tpu_torch
import lzw_tpu_torch.api as api
from lzw_tpu_torch import (
    CodeSizeError, CodeSizeStrategy, Endianness, FixedCodec, GifCodec,
    LzwCodec, LzwSpec, MissingClearCodeError, TiffCodec,
    TruncatedStreamError, UnexpectedCodeError, VariableCodec,
    from_reference_spec,
)
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.ops import reference as oracle

# The reference's crafted corrupt TIFF stream (`decoder.rs:758-769`).
CORRUPT_TIFF = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60,
                      0x54])
REF_SPECS = {
    **{f"gif{cs}": JSpec.gif(cs) for cs in (2, 5, 7, 8)},
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
    "var4be_tiff": JSpec.variable(4, JEndianness.BIG, JStrategy.TIFF),
}


@pytest.fixture(params=["native", "oracle"])
def backend(request):
    return request.param


def _missing_clear_stream():
    codes = [(0, 9)]
    width, next_index = 9, 258
    for _ in range(4096 - 258 + 2):
        codes.append((1, width))
        next_index += 1
        if next_index == (1 << width) and width < 12:
            width += 1
    return oracle.pack_codes(codes, Endianness.LITTLE)


class TestDoctestContracts:
    def test_gif(self, backend):
        codec = GifCodec(2, backend=backend)
        assert codec.encode(bytes([0, 0, 1, 3])) == bytes([0x04, 0x32, 0x05])
        assert codec.decode(bytes([0x04, 0x32, 0x05])) == bytes([0, 0, 1, 3])

    def test_tiff(self, backend):
        codec = TiffCodec(backend=backend)
        wire = bytes([0x80, 0x00, 0x00, 0x00, 0x10, 0x1C, 0x04])
        assert codec.encode(bytes([0, 0, 1, 3])) == wire
        assert codec.decode(wire) == bytes([0, 0, 1, 3])

    def test_fixed(self, backend):
        codec = FixedCodec(Endianness.LITTLE, backend=backend)
        wire = bytes([0x00, 0x00, 0x00, 0x01, 0x30, 0x00])
        assert codec.encode(bytes([0, 0, 1, 3])) == wire
        assert codec.decode(wire) == bytes([0, 0, 1, 3])

    def test_variable(self, backend):
        codec = VariableCodec(2, Endianness.LITTLE, backend=backend)
        assert codec.encode(bytes([0, 0, 1, 3])) == bytes([0x04, 0x32, 0x05])


class TestGolden:
    def test_round_trip_golden(self, backend, lorem_ipsum,
                               lorem_ipsum_encoded):
        codec = GifCodec(7, backend=backend)
        assert codec.encode(lorem_ipsum) == lorem_ipsum_encoded
        assert codec.decode(lorem_ipsum_encoded) == lorem_ipsum

    def test_backends_agree_on_corpus(self, tokyo_pixels):
        data = tokyo_pixels[:30000]
        for make in (lambda b: GifCodec(7, backend=b),
                     lambda b: TiffCodec(backend=b),
                     lambda b: FixedCodec(Endianness.BIG, backend=b)):
            assert make("native").encode(data) == make("oracle").encode(data)


@pytest.mark.parametrize("name", list(REF_SPECS))
def test_bytes_equal_the_jax_facades(name, backend, tokyo_pixels):
    ref = REF_SPECS[name]
    spec = from_reference_spec(ref)
    data = bytes(b % spec.alphabet_size if spec.variable else b
                 for b in tokyo_pixels[5000:17000])
    want = japi.LzwCodec(ref, backend="oracle").encode(data)
    codec = LzwCodec(spec, backend=backend)
    assert codec.encode(data) == want
    assert codec.decode(want) == data


def _jax_error(fn):
    try:
        fn()
    except Exception as exc:  # the JAX facade's error, to compare with
        return exc
    raise AssertionError("the JAX facade raised nothing")


class TestErrors:
    def test_code_size_validated_at_construction(self):
        for cs in (10, 1):
            with pytest.raises(CodeSizeError) as ei:
                GifCodec(cs)
            assert str(ei.value) == str(_jax_error(lambda: japi.GifCodec(cs)))

    def test_encode_unexpected_code(self, backend):
        codec = VariableCodec(2, Endianness.BIG, backend=backend)
        with pytest.raises(UnexpectedCodeError) as exc:
            codec.encode(bytes([0, 1, 8, 3]))
        assert exc.value.code == 8
        assert exc.value.code_size == 2
        assert str(exc.value) == str(_jax_error(
            lambda: japi.VariableCodec(2, JEndianness.BIG, backend="oracle")
            .encode(bytes([0, 1, 8, 3]))))

    def test_decode_unexpected_code(self, backend):
        with pytest.raises(UnexpectedCodeError) as exc:
            TiffCodec(backend=backend).decode(CORRUPT_TIFF)
        assert exc.value.code == 258
        assert str(exc.value) == str(_jax_error(
            lambda: japi.TiffCodec(backend="oracle").decode(CORRUPT_TIFF)))

    def test_decode_truncated(self, backend):
        codec = GifCodec(2, backend=backend)
        enc = codec.encode(bytes([1] * 64))
        with pytest.raises(TruncatedStreamError) as exc:
            codec.decode(enc[:-1])
        assert str(exc.value) == str(_jax_error(
            lambda: japi.GifCodec(2, backend="oracle").decode(enc[:-1])))

    def test_decode_missing_clear(self, backend):
        enc = _missing_clear_stream()
        with pytest.raises(MissingClearCodeError) as exc:
            VariableCodec(8, Endianness.LITTLE, backend=backend).decode(enc)
        assert str(exc.value) == str(_jax_error(
            lambda: japi.VariableCodec(8, JEndianness.LITTLE,
                                       backend="oracle").decode(enc)))

    def test_error_classes_are_the_packages(self):
        assert api.CodeSizeStrategy is CodeSizeStrategy
        assert lzw_tpu_torch.LzwCodec is LzwCodec


class TestStreamApi:
    def test_stream_round_trip(self, backend):
        codec = GifCodec(7, backend=backend)
        src = io.BytesIO(b"the quick brown fox jumps over the lazy dog " * 20)
        comp = io.BytesIO()
        codec.encode_stream(src, comp)
        comp.seek(0)
        out = io.BytesIO()
        codec.decode_stream(comp, out)
        assert out.getvalue() == src.getvalue()

    def test_ndarray_input(self, backend):
        codec = FixedCodec(backend=backend)
        arr = np.arange(256, dtype=np.uint8)
        assert codec.decode(codec.encode(arr)) == arr.tobytes()
        with pytest.raises(TypeError, match="uint8"):
            codec.encode(np.arange(4, dtype=np.int32))

    def test_sizes_around_powers_of_two(self, backend):
        codec = GifCodec(7, backend=backend)
        for n in (0, 1, 255, 256, 257, 511, 513):
            data = bytes(i % 128 for i in range(n))
            assert codec.decode(codec.encode(data)) == data


class TestBackendDispatch:
    def test_auto_is_native_when_it_builds(self, lorem_ipsum,
                                           lorem_ipsum_encoded):
        auto = GifCodec(7)
        assert auto.backend == "native"
        assert auto.encode(lorem_ipsum) == lorem_ipsum_encoded
        assert auto.decode(lorem_ipsum_encoded) == lorem_ipsum

    def test_auto_is_the_oracle_without_the_runtime(self, monkeypatch,
                                                    lorem_ipsum_encoded):
        monkeypatch.setattr(api, "native_available", lambda: False)
        codec = TiffCodec()
        assert codec.backend == "oracle"
        assert GifCodec(7).decode(lorem_ipsum_encoded)

    def test_jax_backend_is_not_ported(self):
        with pytest.raises(ValueError, match="does not port"):
            GifCodec(7, backend="jax")

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="unknown backend"):
            GifCodec(7, backend="cuda")


# ---- streaming (tests/test_streaming.py) ------------------------------

CHUNKS = [1, 7, 64, 1000, 1 << 20]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_encode_matches_golden(lorem_ipsum, lorem_ipsum_encoded, chunk,
                                      backend):
    codec = GifCodec(7, backend=backend)
    dst = io.BytesIO()
    n = codec.encode_stream(io.BytesIO(lorem_ipsum), dst, chunk_size=chunk)
    assert dst.getvalue() == lorem_ipsum_encoded
    assert n == len(lorem_ipsum_encoded)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_decode_matches_golden(lorem_ipsum, lorem_ipsum_encoded, chunk,
                                      backend):
    codec = GifCodec(7, backend=backend)
    dst = io.BytesIO()
    n = codec.decode_stream(io.BytesIO(lorem_ipsum_encoded), dst,
                            chunk_size=chunk)
    assert dst.getvalue() == lorem_ipsum
    assert n == len(lorem_ipsum)


@pytest.mark.parametrize("make_codec", [
    lambda: GifCodec(7, backend="native"),
    lambda: TiffCodec(backend="native"),
    lambda: FixedCodec(Endianness.LITTLE, backend="native"),
    lambda: FixedCodec(Endianness.BIG, backend="native"),
], ids=["gif7", "tiff", "fixed_le", "fixed_be"])
def test_stream_matches_batch_all_flavors(make_codec, lorem_ipsum):
    data = lorem_ipsum * 2
    codec = make_codec()
    enc = io.BytesIO()
    codec.encode_stream(io.BytesIO(data), enc, chunk_size=333)
    assert enc.getvalue() == codec.encode(data)
    dec = io.BytesIO()
    codec.decode_stream(io.BytesIO(enc.getvalue()), dec, chunk_size=77)
    assert dec.getvalue() == data


def test_stream_empty_input(backend):
    codec = GifCodec(7, backend=backend)
    enc = io.BytesIO()
    codec.encode_stream(io.BytesIO(b""), enc)
    assert enc.getvalue() == codec.encode(b"")
    dec = io.BytesIO()
    codec.decode_stream(io.BytesIO(enc.getvalue()), dec)
    assert dec.getvalue() == b""


def test_stream_truncated_raises(backend):
    codec = GifCodec(7, backend=backend)
    full = codec.encode(b"hello world" * 40)
    with pytest.raises(TruncatedStreamError):
        codec.decode_stream(io.BytesIO(full[: len(full) // 2]), io.BytesIO())


def test_stream_corrupt_raises_unexpected_code(backend):
    with pytest.raises(UnexpectedCodeError) as ei:
        TiffCodec(backend=backend).decode_stream(io.BytesIO(CORRUPT_TIFF),
                                                 io.BytesIO())
    assert ei.value.code == 258


def test_decoder_stream_bounded_output():
    """Tiny out_cap forces the save/restore re-feed path repeatedly."""
    data = (b"abcd" * 3000)[:9999]  # highly compressible -> big expansion
    comp = GifCodec(7, backend="native").encode(data)
    dec = get_runtime().decoder_stream(LzwSpec.gif(7))
    pieces = list(dec.feed(comp, out_cap=1))  # clamped to the 8 KiB minimum
    dec.finish()
    assert b"".join(pieces) == data
    assert len(pieces) > 1 and max(map(len, pieces)) <= 8192
    with pytest.raises(ValueError, match="finished"):
        dec.finish()


def test_encoder_stream_fix_eoi_matches_encode(lorem_ipsum):
    rt = get_runtime()
    spec = LzwSpec.gif(7)
    enc = rt.encoder_stream(spec, fix_eoi=True)
    out = b"".join(enc.feed(lorem_ipsum[i : i + 500])
                   for i in range(0, len(lorem_ipsum), 500)) + enc.finish()
    assert out == rt.encode(lorem_ipsum, spec, fix_eoi=True)
    with pytest.raises(ValueError, match="finished"):
        enc.feed(b"x")


def test_bounded_memory_large_stream(tmp_path):
    """Encode a stream ~50x the chunk size without materialising it."""
    codec = FixedCodec(Endianness.LITTLE, backend="native")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, size=1 << 16).astype(np.uint8).tobytes()
    n_reps = 50

    class RepeatReader(io.RawIOBase):
        def __init__(self):
            self.left = n_reps
            self.buf = b""

        def read(self, n=-1):
            while len(self.buf) < n and self.left:
                self.buf += base
                self.left -= 1
            out, self.buf = self.buf[:n], self.buf[n:]
            return out

    enc_path = tmp_path / "big.lzw"
    with open(enc_path, "wb") as dst:
        codec.encode_stream(RepeatReader(), dst, chunk_size=1 << 16)
    assert enc_path.read_bytes() == codec.encode(base * n_reps)


# ---- the port's oracle against the JAX package's ----------------------

def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as exc:  # compared by class name and message
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("name", list(REF_SPECS))
def test_oracle_matches_the_jax_oracle(name):
    ref = REF_SPECS[name]
    spec = from_reference_spec(ref)
    rng = np.random.default_rng(len(name))
    hi = spec.alphabet_size if spec.variable else 256
    for n in (0, 1, 2, 300, 9000):
        data = rng.integers(0, hi, n).astype(np.uint8).tobytes()
        codes = oracle.encode_codes(data, spec)
        assert codes == joracle.encode_codes(data, ref)
        wire = oracle.pack_codes(codes, spec.endianness)
        assert wire == joracle.pack_codes(codes, ref.endianness)
        assert oracle.eoi_width_quirk(codes, spec) == joracle.eoi_width_quirk(
            codes, ref)
        # A stream with the EOI width quirk fails in both, alike.
        assert _outcome(oracle.decode_bytes, wire, spec) == _outcome(
            joracle.decode_bytes, wire, ref)
        if not spec.variable:
            assert oracle.unpack_codes_fixed(
                wire, 12, spec.endianness) == joracle.unpack_codes_fixed(
                wire, 12, ref.endianness)
