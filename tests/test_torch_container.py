"""The port's LZWT container codec as a whole, on the CPU (plain versions),
against the JAX package's ``BlockParallelCodec`` (lax path on the virtual
CPU mesh).  Containers are bytes: every comparison is exact.
"""

import io

import pytest
import torch

from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import BlockParallelCodec, LzwSpec, UnexpectedCodeError
from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.parallel import framing

REF = {"gif7": JSpec.gif(7), "tiff": JSpec.tiff(),
       "fixed_le": JSpec.fixed(JEndianness.LITTLE)}


def _codec(spec, block_size=None):
    return BlockParallelCodec(spec, block_size=block_size, device="cpu")


@pytest.mark.parametrize("block_size", [4096, 16384], ids=["4k", "16k"])
@pytest.mark.parametrize("name", list(REF))
def test_containers_byte_identical(name, block_size, tokyo_pixels):
    data = tokyo_pixels[:40000]
    ref = JaxCodec(REF[name], block_size=block_size)
    codec = _codec(from_reference_spec(REF[name]), block_size)
    want = ref.encode(data)
    got = codec.encode(data)
    assert got == want
    # Cross-decode: the same bytes decode in either package.
    assert codec.decode(want) == data
    assert ref.decode(got) == data


def test_golden_single_block(lorem_ipsum, lorem_ipsum_encoded):
    # One 32 KiB block of lorem_ipsum.txt is the reference's own stream.
    codec = _codec(LzwSpec.gif(7), 1 << 15)
    _, payloads = framing.parse_frame(codec.encode(lorem_ipsum))
    assert len(payloads) == 1
    assert bytes(payloads[0]) == lorem_ipsum_encoded


def test_default_block_sizes():
    assert _codec(LzwSpec.gif(7)).block_size == 1 << 16
    assert _codec(from_reference_spec(REF["fixed_le"])).block_size == 1 << 12


def test_decode_range(lorem_ipsum):
    codec = _codec(LzwSpec.gif(7), 1024)
    container = codec.encode(lorem_ipsum[:5000])
    assert codec.decode_range(container, 1, 3) == lorem_ipsum[1024:3072]
    assert codec.decode_range(container, 4, 5) == lorem_ipsum[4096:5000]
    assert codec.decode_range(container, 2, 2) == b""
    with pytest.raises(IndexError):
        codec.decode_range(container, 3, 9)


@pytest.mark.parametrize("name", ["gif7", "fixed_le"])
def test_stream_round_trip(name, lorem_ipsum):
    codec = _codec(from_reference_spec(REF[name]), 1024)
    data = lorem_ipsum[:7000]
    dst = io.BytesIO()
    assert codec.encode_stream(io.BytesIO(data), dst, batch_blocks=3) == len(
        data)
    out = io.BytesIO()
    assert codec.decode_stream(io.BytesIO(dst.getvalue()), out,
                               batch_blocks=2) == len(data)
    assert out.getvalue() == data


def test_empty_and_non_multiple_sizes():
    codec = _codec(from_reference_spec(REF["fixed_le"]), 1000)
    assert codec.decode(codec.encode(b"")) == b""
    for n in (1, 999, 1001):
        data = bytes((i * 7) % 251 for i in range(n))
        assert codec.decode(codec.encode(data)) == data


def test_encode_error_contract():
    # A byte > 127 after the first under GIF cs=7.
    codec = _codec(LzwSpec.gif(7), 16)
    with pytest.raises(UnexpectedCodeError) as exc:
        codec.encode(bytes([1, 2, 3, 200, 4]))
    assert exc.value.code == 200
    assert exc.value.code_size == 7


def test_wrong_spec_rejected(lorem_ipsum):
    container = _codec(LzwSpec.gif(7), 4096).encode(lorem_ipsum[:5000])
    with pytest.raises(framing.FramingError):
        _codec(LzwSpec.tiff(), 4096).decode(container)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockParallelCodec(LzwSpec.gif(7))


def test_non_cpu_tensor_never_takes_the_plain_version():
    # Only CPU tensors run the plain version; others launch or raise.
    blocks = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tenc.encode_blocks_codes(blocks, lens, LzwSpec.gif(7))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.load("encode_parse")
