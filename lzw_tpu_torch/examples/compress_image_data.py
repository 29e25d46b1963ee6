"""Compress indexed-image pixel data.

The counterpart of the JAX package's ``examples/compress_image_data.py``
(and of the reference's ``lzw/examples/compress_image_data.rs``)::

    python -m lzw_tpu_torch.examples.compress_image_data [--device cpu]

Decodes the palette indices of ``tokyo_128_colors.png`` (values 0..128),
compresses them as one GIF stream at code size 7 on the host, then as the
block-parallel container on the card (``--device``, by default ``cuda``:
every visible GPU), and decodes the container back.  ``--device cpu`` runs
the kernels' plain versions; ``cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import NamedTuple

from lzw_tpu_torch import BlockParallelCodec, GifCodec, LzwSpec
from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "test-assets"


class Compressed(NamedTuple):
    single: bytes     # one GIF stream, the reference's wire bytes
    container: bytes  # the LZWT container
    n_devices: int
    block_size: int


def run(pixels: bytes, device="cuda") -> Compressed:
    """Both compressions of ``pixels``; the container is decoded back and
    checked (raises AssertionError on a difference)."""
    codec = BlockParallelCodec(LzwSpec.gif(7), device=device)
    single = GifCodec(code_size=7).encode(pixels)
    container = codec.encode(pixels)
    if codec.decode(container) != pixels:
        raise AssertionError("container round trip differs")
    return Compressed(single, container, len(codec.devices),
                      codec.block_size)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the container codec "
                             "(default: cuda, every visible GPU)")
    args = parser.parse_args(argv)
    pixels = load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")
    print(f"indexed pixels: {len(pixels)} bytes")
    out = run(pixels, args.device)
    print(f"single stream: {len(out.single)} bytes "
          f"(ratio {len(out.single) / len(pixels):.3f})")
    print(f"container ({out.n_devices} device(s), {out.block_size}B "
          f"blocks): {len(out.container)} bytes "
          f"(ratio {len(out.container) / len(pixels):.3f})")


if __name__ == "__main__":
    main()
