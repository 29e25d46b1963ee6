"""The port's GIF container helpers against the JAX package's copy and
against Pillow, the external GIF codec (tests/test_external_gif.py).

Files and streams are bytes: every comparison is exact.
"""

import io

import numpy as np
import pytest

from lzw_tpu.utils import gifwrap as jgif

from lzw_tpu_torch import GifCodec
from lzw_tpu_torch.utils.gifwrap import unwrap_gif, wrap_gif


@pytest.mark.parametrize("code_size", [2, 3, 5, 7, 8])
@pytest.mark.parametrize("length", [0, 1, 254, 255, 256, 1000])
def test_wrap_and_unwrap_equal_the_jax_copy(code_size, length):
    rng = np.random.default_rng(code_size * 1000 + length)
    stream = rng.integers(0, 256, length).astype(np.uint8).tobytes()
    gif = wrap_gif(stream, 17, 5, code_size)
    assert gif == jgif.wrap_gif(stream, 17, 5, code_size)
    assert unwrap_gif(gif) == jgif.unwrap_gif(gif) == (stream, code_size,
                                                       (17, 5))


def test_unwrap_skips_extensions_and_local_tables():
    # A GIF87a with a graphic-control extension and a local color table.
    stream = bytes(range(40))
    gif = bytearray(wrap_gif(stream, 4, 4, 2))
    at = gif.index(b"\x2c")
    gif[at:at] = b"\x21\xf9\x04\x00\x00\x00\x00\x00"
    at = gif.index(b"\x2c") + 9
    gif[at] |= 0x80 | 1  # a local table of 4 entries
    gif[at + 1 : at + 1] = bytes(12)
    gif[:6] = b"GIF87a"
    assert unwrap_gif(bytes(gif)) == jgif.unwrap_gif(bytes(gif)) == (
        stream, 2, (4, 4))


@pytest.mark.parametrize("bad", [b"PNG\x00\x00\x00" + bytes(20),
                                 b"GIF89a" + bytes(7) + b"\x3b"])
def test_unwrap_rejects_what_it_cannot_read(bad):
    for fn in (unwrap_gif, jgif.unwrap_gif):
        with pytest.raises(AssertionError):
            fn(bad)


@pytest.mark.parametrize("backend", ["native", "oracle"])
def test_pillow_decodes_our_streams(backend, tokyo_pixels):
    image = pytest.importorskip("PIL.Image")
    w, h = 128, 64
    pixels = np.frombuffer(tokyo_pixels[: w * h], np.uint8)
    stream = GifCodec(7, backend=backend).encode(pixels.tobytes())
    decoded = np.asarray(image.open(io.BytesIO(wrap_gif(stream, w, h, 7))))
    np.testing.assert_array_equal(decoded.reshape(-1), pixels)


@pytest.mark.parametrize("backend", ["native", "oracle"])
def test_we_decode_pillow_streams(backend, tokyo_pixels):
    image = pytest.importorskip("PIL.Image")
    w, h = 128, 96
    pixels = np.frombuffer(tokyo_pixels[: w * h], np.uint8).reshape(h, w)
    img = image.fromarray(pixels, mode="P")
    img.putpalette([(i * 2) % 256 for i in range(256) for _ in range(3)])
    buf = io.BytesIO()
    img.save(buf, format="GIF", optimize=False, interlace=False)
    stream, code_size, (gw, gh) = unwrap_gif(buf.getvalue())
    assert (stream, code_size, (gw, gh)) == jgif.unwrap_gif(buf.getvalue())
    ours = GifCodec(code_size, backend=backend).decode(stream)
    want = np.asarray(image.open(io.BytesIO(buf.getvalue())).convert("P"))
    np.testing.assert_array_equal(
        np.frombuffer(ours, np.uint8).reshape(gh, gw), want)
