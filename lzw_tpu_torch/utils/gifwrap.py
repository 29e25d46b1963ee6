"""Minimal GIF container plumbing around raw GIF-flavor LZW streams.

The port's own copy of ``lzw_tpu/utils/gifwrap.py``.

The codec layer deals in raw LZW byte streams (the reference's surface,
`encoder.rs:353-440`); real GIF files chunk that stream into <= 255-byte
sub-blocks inside an image descriptor.  These helpers wrap/unwrap a
one-frame GIF89a so streams can be exchanged with external GIF codecs
(Pillow in the test suite and benchmarks — the external differential
anchor, the analog of the reference benching the `lzw`/`weezl` crates).
"""

from __future__ import annotations

import struct

__all__ = ["wrap_gif", "unwrap_gif"]


def wrap_gif(lzw_stream: bytes, width: int, height: int,
             code_size: int) -> bytes:
    """Wrap a raw GIF-flavor LZW stream in a one-frame GIF89a file."""
    n_colors = 1 << max(code_size, 1)
    gct_k = max(code_size, 1) - 1  # GCT holds 2^(k+1) entries
    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HH", width, height)
    out += bytes([0x80 | (7 << 4) | gct_k, 0, 0])  # GCT present, 8-bit res
    for i in range(n_colors):  # identity-ish grayscale palette
        v = (i * 255) // max(n_colors - 1, 1)
        out += bytes([v, v, v])
    out += b"\x2c" + struct.pack("<HHHH", 0, 0, width, height) + b"\x00"
    out += bytes([code_size])
    for off in range(0, len(lzw_stream), 255):
        chunk = lzw_stream[off : off + 255]
        out += bytes([len(chunk)]) + chunk
    out += b"\x00\x3b"
    return bytes(out)


def unwrap_gif(gif: bytes):
    """Extract (lzw_stream, min_code_size, (width, height)) from a GIF file.

    Raises AssertionError on anything but a simple single-image GIF.
    """
    assert gif[:6] in (b"GIF87a", b"GIF89a")
    width, height, flags = struct.unpack_from("<HHB", gif, 6)
    pos = 13
    if flags & 0x80:
        pos += 3 * (2 << (flags & 7))
    while True:
        block = gif[pos]
        pos += 1
        if block == 0x21:  # extension: label + sub-blocks
            pos += 1
            while gif[pos]:
                pos += 1 + gif[pos]
            pos += 1
        elif block == 0x2C:
            _, _, w, h, iflags = struct.unpack_from("<HHHHB", gif, pos)
            pos += 9
            if iflags & 0x80:
                pos += 3 * (2 << (iflags & 7))
            code_size = gif[pos]
            pos += 1
            stream = bytearray()
            while gif[pos]:
                n = gif[pos]
                stream += gif[pos + 1 : pos + 1 + n]
                pos += 1 + n
            return bytes(stream), code_size, (w, h)
        elif block == 0x3B:
            raise AssertionError("no image block found")
        else:
            raise AssertionError(f"unexpected GIF block 0x{block:02x}")
