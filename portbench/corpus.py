"""The palette-index plane of an 8-bit palette PNG, without PIL.

A copy of the program's reader (``lzw_tpu_torch/utils/corpus.py``), kept
here so that the benchmark's inputs cannot move with the program: the
chunks taken apart with ``struct``, the IDAT stream inflated with ``zlib``,
the row filters undone with numpy.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

__all__ = ["decode_palette_png", "load_plane"]

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


def load_plane(path: str | pathlib.Path) -> np.ndarray:
    """The palette-index bytes of the PNG at ``path``, u8[height * width]."""
    blob = pathlib.Path(path).read_bytes()
    return np.frombuffer(decode_palette_png(blob), np.uint8)
