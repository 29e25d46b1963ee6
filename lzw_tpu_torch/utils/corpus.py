"""Benchmark corpus loading without PIL.

The image corpus is the palette-index plane of ``tokyo_128_colors.png``, an
8-bit palette PNG.  This reader takes the PNG apart with the standard
library (``struct`` for the chunks, ``zlib`` for the IDAT stream) and undoes
the per-row filters with numpy, giving the same bytes as the JAX package's
PIL-based ``lzw_tpu.utils.corpus.load_tokyo_pixels``.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

__all__ = ["load_tokyo_pixels", "load_corpus", "decode_palette_png"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, height: int, width: int) -> np.ndarray:
    """Undo PNG filters 0-4 for 1 byte per pixel (filter spec, PNG §9)."""
    rows = raw.reshape(height, width + 1)
    out = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.int64)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along the row
            cur = np.cumsum(line) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: left-to-right dependence
            cur = np.zeros(width, np.int64)
            left = 0
            for x in range(width):
                up = int(prev[x])
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = int(prev[x - 1]) if x else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul
                    )
                left = (int(line[x]) + pred) & 0xFF
                cur[x] = left
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def decode_palette_png(blob: bytes) -> bytes:
    """Palette-index bytes of a non-interlaced 8-bit palette PNG."""
    if blob[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(blob):
        (n,) = struct.unpack_from(">I", blob, pos)
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if color != 3 or depth != 8 or interlace != 0:
        raise ValueError(
            f"expected a non-interlaced 8-bit palette PNG, got color type "
            f"{color}, depth {depth}, interlace {interlace}"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, height, width).tobytes()


def load_tokyo_pixels(path: str | pathlib.Path) -> bytes:
    """Decode an indexed PNG to its raw palette-index bytes."""
    return decode_palette_png(pathlib.Path(path).read_bytes())


def load_corpus(assets_dir: str | pathlib.Path) -> dict[str, bytes]:
    """Load the benchmark corpora keyed by the reference's bench names."""
    assets = pathlib.Path(assets_dir)
    return {
        "lorem_ipsum": (assets / "lorem_ipsum.txt").read_bytes(),
        "tokyo": load_tokyo_pixels(assets / "tokyo_128_colors.png"),
    }
