"""LZWT block container format (v1), byte-identical to ``lzw_tpu.parallel.framing``.

New to this framework (the reference is strictly single-stream): a framing
layer that slices input into independently-dictionaried blocks so encode and
decode parallelize across devices and hosts.  Each block payload is a
self-contained salzweg-compatible stream of the chosen flavor (with the EOI
width fix enabled, see ``lzw_tpu.ops.reference.eoi_width_quirk``), so block
boundaries behave exactly like the reference's own dictionary resets
(`encoder.rs:330-333`) plus a restart.

Layout (all integers little-endian):

    offset  size  field
    0       4     magic  b"LZWT"
    4       1     version (1)
    5       1     flavor: 0 = variable, 1 = fixed
    6       1     code_size (2..=8; 8 for fixed)
    7       1     endianness: 0 = little, 1 = big
    8       1     strategy: 0 = default, 1 = tiff (early change)
    9       3     reserved (0)
    12      4     block_size (uncompressed bytes per block)
    16      4     n_blocks
    20      8     orig_size (total uncompressed bytes)
    28      4     reserved (0)
    32      4*n   per-block compressed byte lengths
    ...           concatenated block payloads

The per-block length table gives random access and is the resume/fault
isolation index: any block can be (re)decoded independently.
"""

from __future__ import annotations

import dataclasses
import struct

from lzw_tpu_torch.spec import (
    CodeSizeStrategy, DecodingError, Endianness, LzwSpec,
)

__all__ = [
    "FrameHeader", "pack_frame", "parse_frame", "HEADER_SIZE", "MAGIC",
    "STREAM_MAGIC", "write_stream_header", "read_stream_header",
    "write_stream_record", "read_stream_record", "write_stream_end",
]

MAGIC = b"LZWT"
VERSION = 1
HEADER_SIZE = 32
_HEADER_FMT = "<4sBBBBB3xIIQ4x"

# Streaming profile ("LZWS"): the same per-block payloads, but framed as a
# record sequence so neither side needs the block count up front — encode
# writes records as batches finish, decode consumes them with O(batch)
# memory.  Layout: 16-byte header (magic, version, spec fields, block_size),
# then (u32 len, payload) records, then the 0xFFFFFFFF terminator followed by
# a u64 of the original uncompressed size.
STREAM_MAGIC = b"LZWS"
_STREAM_HEADER_FMT = "<4sBBBBB3xI"
STREAM_HEADER_SIZE = struct.calcsize(_STREAM_HEADER_FMT)
_STREAM_END = 0xFFFFFFFF


class FramingError(DecodingError):
    """The container header or length table is malformed."""


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    spec: LzwSpec
    block_size: int
    n_blocks: int
    orig_size: int

    def block_lengths_span(self) -> tuple[int, int]:
        return HEADER_SIZE, HEADER_SIZE + 4 * self.n_blocks


def pack_frame(
    spec: LzwSpec,
    block_size: int,
    orig_size: int,
    payloads: list[bytes],
) -> bytes:
    """Assemble the container from per-block compressed payloads."""
    header = struct.pack(
        _HEADER_FMT,
        MAGIC,
        VERSION,
        0 if spec.variable else 1,
        spec.code_size,
        0 if spec.endianness is Endianness.LITTLE else 1,
        spec.strategy.value,
        block_size,
        len(payloads),
        orig_size,
    )
    lengths = struct.pack(f"<{len(payloads)}I", *(len(p) for p in payloads))
    return header + lengths + b"".join(payloads)


def parse_frame(data: bytes) -> tuple[FrameHeader, list[memoryview]]:
    """Parse header + length table; returns zero-copy payload views."""
    if len(data) < HEADER_SIZE:
        raise FramingError("container shorter than header")
    magic, version, flavor, code_size, endian, strategy, block_size, n_blocks, \
        orig_size = struct.unpack_from(_HEADER_FMT, data, 0)
    if magic != MAGIC:
        raise FramingError(f"bad magic {magic!r}")
    if version != VERSION:
        raise FramingError(f"unsupported container version {version}")
    endianness = Endianness.LITTLE if endian == 0 else Endianness.BIG
    if flavor == 0:
        spec = LzwSpec.variable(
            code_size, endianness, CodeSizeStrategy(strategy)
        )
    elif flavor == 1:
        spec = LzwSpec.fixed(endianness)
    else:
        raise FramingError(f"unknown flavor {flavor}")

    table_end = HEADER_SIZE + 4 * n_blocks
    if len(data) < table_end:
        raise FramingError("container shorter than its length table")
    lengths = struct.unpack_from(f"<{n_blocks}I", data, HEADER_SIZE)
    view = memoryview(data)
    payloads = []
    off = table_end
    for n in lengths:
        if off + n > len(data):
            raise FramingError("container payload truncated")
        payloads.append(view[off : off + n])
        off += n
    header = FrameHeader(spec, block_size, n_blocks, orig_size)
    return header, payloads


# --------------------------------------------------------------------------- #
# Streaming profile                                                           #
# --------------------------------------------------------------------------- #


def _spec_fields(spec: LzwSpec) -> tuple[int, int, int, int]:
    return (
        0 if spec.variable else 1,
        spec.code_size,
        0 if spec.endianness is Endianness.LITTLE else 1,
        spec.strategy.value,
    )


def _spec_from_fields(flavor: int, code_size: int, endian: int,
                      strategy: int) -> LzwSpec:
    endianness = Endianness.LITTLE if endian == 0 else Endianness.BIG
    if flavor == 0:
        return LzwSpec.variable(code_size, endianness, CodeSizeStrategy(strategy))
    if flavor == 1:
        return LzwSpec.fixed(endianness)
    raise FramingError(f"unknown flavor {flavor}")


def write_stream_header(dst, spec: LzwSpec, block_size: int) -> None:
    dst.write(struct.pack(
        _STREAM_HEADER_FMT, STREAM_MAGIC, VERSION, *_spec_fields(spec),
        block_size,
    ))


def read_stream_header(src) -> tuple[LzwSpec, int]:
    """Returns (spec, block_size)."""
    raw = src.read(STREAM_HEADER_SIZE)
    if len(raw) != STREAM_HEADER_SIZE:
        raise FramingError("stream shorter than header")
    magic, version, flavor, code_size, endian, strategy, block_size = (
        struct.unpack(_STREAM_HEADER_FMT, raw)
    )
    if magic != STREAM_MAGIC:
        raise FramingError(f"bad stream magic {magic!r}")
    if version != VERSION:
        raise FramingError(f"unsupported stream version {version}")
    return _spec_from_fields(flavor, code_size, endian, strategy), block_size


def write_stream_record(dst, payload: bytes) -> None:
    dst.write(struct.pack("<I", len(payload)))
    dst.write(payload)


def write_stream_end(dst, orig_size: int) -> None:
    dst.write(struct.pack("<IQ", _STREAM_END, orig_size))


def read_stream_record(src) -> bytes | int:
    """One record's payload, or the final ``orig_size`` int at stream end."""
    raw = src.read(4)
    if len(raw) != 4:
        raise FramingError("stream truncated at record length")
    (n,) = struct.unpack("<I", raw)
    if n == _STREAM_END:
        tail = src.read(8)
        if len(tail) != 8:
            raise FramingError("stream truncated at footer")
        return struct.unpack("<Q", tail)[0]
    payload = src.read(n)
    if len(payload) != n:
        raise FramingError("stream truncated inside a record")
    return payload
