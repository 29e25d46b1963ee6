"""Round-trip the text corpus against the reference golden file.

The counterpart of the JAX package's ``examples/usage.py`` (and of the
reference's ``lzw/examples/usage.rs``)::

    python -m lzw_tpu_torch.examples.usage

Encodes ``test-assets/lorem_ipsum.txt`` with the GIF flavor at code size 7,
checks the bytes equal ``lorem_ipsum_encoded.bin``, decodes, and compares.
The facade runs on the host (the native runtime, or the scalar oracle where
the runtime cannot build), as in the JAX package.
"""

from __future__ import annotations

import pathlib

from lzw_tpu_torch import GifCodec

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "test-assets"


def run(assets: pathlib.Path = ASSETS) -> tuple[int, int]:
    """Encode the corpus, hold it against the golden file and decode it
    back; returns (plain bytes, compressed bytes).  Raises AssertionError
    on any difference."""
    data = (assets / "lorem_ipsum.txt").read_bytes()
    golden = (assets / "lorem_ipsum_encoded.bin").read_bytes()
    codec = GifCodec(code_size=7)
    compressed = codec.encode(data)
    if compressed != golden:
        raise AssertionError("wire bytes differ from the reference")
    if codec.decode(compressed) != data:
        raise AssertionError("round trip differs")
    return len(data), len(compressed)


def main() -> None:
    n_data, n_compressed = run()
    print(f"compressed {n_data} -> {n_compressed} bytes "
          f"(ratio {n_compressed / n_data:.3f}), matches golden file")
    print("round-trip OK")


if __name__ == "__main__":
    main()
