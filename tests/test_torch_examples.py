"""The port's examples against the golden file and the JAX package.

``lzw_tpu_torch.examples.usage`` must give ``lorem_ipsum_encoded.bin``
back; ``compress_image_data.run`` on a prefix of the tokyo pixels with
``device="cpu"`` (the kernels' plain versions) must give the JAX oracle's
single stream and the container of the JAX package's
``BlockParallelCodec`` and of the port's framing of the native encoder,
exactly.  The plain encode walks every byte position of a block, so these
runs take 8 KiB blocks in place of the 64 KiB default; the card runs the
default in ``chip_smoke.py``.
"""

import pytest
import torch

from lzw_tpu import GifCodec as JGifCodec
from lzw_tpu.parallel import BlockParallelCodec as JBlockParallelCodec
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import LzwSpec
from lzw_tpu_torch.examples import compress_image_data, usage
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.parallel import block, framing

BLOCK = 8192


def test_usage_gives_the_golden_file(lorem_ipsum, lorem_ipsum_encoded):
    assert usage.run() == (len(lorem_ipsum), len(lorem_ipsum_encoded))


def test_usage_main_prints_the_check(capsys):
    usage.main()
    out = capsys.readouterr().out
    assert "compressed 23336 -> 9960 bytes (ratio 0.427)" in out
    assert "round-trip OK" in out


def test_usage_raises_on_another_golden_file(tmp_path, lorem_ipsum,
                                             lorem_ipsum_encoded):
    (tmp_path / "lorem_ipsum.txt").write_bytes(lorem_ipsum)
    bad = bytearray(lorem_ipsum_encoded)
    bad[100] ^= 1
    (tmp_path / "lorem_ipsum_encoded.bin").write_bytes(bytes(bad))
    with pytest.raises(AssertionError, match="differ from the reference"):
        usage.run(tmp_path)


@pytest.mark.parametrize("n", [20_000, 3 * BLOCK])
def test_compress_image_data_on_the_cpu(monkeypatch, tokyo_pixels, n):
    monkeypatch.setattr(block, "DEFAULT_BLOCK_SIZE", BLOCK)
    pixels = tokyo_pixels[:n]
    out = compress_image_data.run(pixels, device="cpu")
    assert out.n_devices == 1 and out.block_size == BLOCK
    assert out.single == JGifCodec(7, backend="oracle").encode(pixels)
    spec = LzwSpec.gif(7)
    assert out.container == framing.pack_frame(
        spec, BLOCK, len(pixels),
        get_runtime().encode_blocks(pixels, spec, BLOCK))
    assert out.container == JBlockParallelCodec(
        JSpec.gif(7), block_size=BLOCK).encode(pixels)


def test_compress_image_data_counts_every_device(monkeypatch, tokyo_pixels):
    monkeypatch.setattr(block, "DEFAULT_BLOCK_SIZE", 2048)
    pixels = tokyo_pixels[:4000]
    out = compress_image_data.run(pixels, device=["cpu", "cpu"])
    one = compress_image_data.run(pixels, device="cpu")
    assert out.n_devices == 2 and out.container == one.container


def test_compress_image_data_needs_cuda_when_asked(tokyo_pixels):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_image_data.run(tokyo_pixels[:1000])
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_image_data.main([])
