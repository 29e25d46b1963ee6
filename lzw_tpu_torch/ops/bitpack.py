"""Vectorized variable-width bit packing and unpacking.

Port of ``lzw_tpu/ops/bitpack.py``, the data-parallel replacement for the
reference's streaming bit I/O (`lzw/src/io.rs`), which shifts one code at a
time through a u32 accumulator (`io.rs:239-246`, `:302-309`).  Here the
whole code stream is packed in one pass:

  1. an exclusive prefix sum of the code widths gives each code's bit
     offset;
  2. every code spans at most 3 output bytes (width <= 16, offset in its
     byte <= 7, 16 + 7 = 23 bits < 24), so each code is shifted into a
     24-bit window and its three byte lanes are added into the output.

Codes that share a byte occupy disjoint bits of it, so adding realises the
OR.  Width-0 codes are holes and contribute nothing.  The output length is
ceil(total_bits / 8) with zero pad bits, as `io.rs:251-259`, `:314-322`
write it.

The numpy half is a copy of the JAX package's; the torch half replaces its
``jax.numpy`` half (XLA glue there, torch ops here) and runs on the device
of the tensors it is given.  :func:`pack_codes_torch` packs the slots of
:func:`lzw_tpu_torch.ops.encode.encode_block`.

This module owns the wire's bit order: every code the port reads or writes
on the host or in a plain version goes through :func:`join_lanes`,
:func:`split_lanes`, :func:`read_symbol` and :func:`place_symbol`, and
every torch writer through :func:`scatter_symbols` (the oracle,
``ops.reference``, keeps its own bit code).  A kernel that reads or writes
the wire matches these.
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.spec import Endianness

__all__ = [
    "pack_codes_np",
    "unpack_fixed_np",
    "pack_codes_torch",
    "unpack_fixed_torch",
    "packed_size",
    "join_lanes",
    "split_lanes",
    "read_symbol",
    "place_symbol",
    "scatter_symbols",
]


def packed_size(total_bits: int) -> int:
    return (total_bits + 7) // 8


# --------------------------------------------------------------------------- #
# The bit order                                                               #
# --------------------------------------------------------------------------- #
# A symbol of at most 16 bits lies within the three bytes from the one its
# first bit is in: one 24-bit window, ``sh = bit & 7`` bits into it.
# LSB-first streams (GIF) fill a byte from its low bit, so a window's first
# byte is its lowest; MSB-first streams (TIFF) fill from the high bit, so
# its first byte is its highest.  The helpers use only <<, >>, | and &, so
# they take Python ints, numpy arrays and torch tensors alike, in the
# caller's integer type: widen u8 bytes first (a u8 shifted by 16 is 0).


def join_lanes(lanes, little: bool, bits: int = 8):
    """One window from its lanes in stream order, ``bits`` bits each: the
    first lane lowest in LSB order, highest in MSB order.  Three bytes make
    a symbol's 24-bit window; two 12-bit codes make a fixed-12 pair's,
    ``c0 | c1 << 12`` (LSB) or ``c0 << 12 | c1`` (MSB)."""
    low_first = lanes if little else lanes[::-1]
    window = low_first[0]
    for k in range(1, len(low_first)):
        window = window | (low_first[k] << (bits * k))
    return window


def split_lanes(window, little: bool, n: int = 3, bits: int = 8):
    """The ``n`` lanes of ``bits`` bits of a window, in stream order: the
    inverse of :func:`join_lanes`.  The window holds nothing above its top
    lane, which is therefore not masked."""
    mask = (1 << bits) - 1
    low_first = [window & mask]
    low_first += [(window >> (bits * k)) & mask for k in range(1, n - 1)]
    low_first.append(window >> (bits * (n - 1)))
    return tuple(low_first) if little else tuple(low_first[::-1])


def _symbol_shift(sh, width, little: bool):
    return sh if little else 24 - sh - width


def read_symbol(window, sh, width, little: bool):
    """The ``width``-bit symbol ``sh`` bits into a 24-bit window."""
    return (window >> _symbol_shift(sh, width, little)) & ((1 << width) - 1)


def place_symbol(value, sh, width, little: bool):
    """The 24-bit window that holds ``value`` (``width`` bits, none above)
    ``sh`` bits in: the inverse of :func:`read_symbol`."""
    return value << _symbol_shift(sh, width, little)


# --------------------------------------------------------------------------- #
# NumPy                                                                       #
# --------------------------------------------------------------------------- #


def pack_codes_np(
    codes: np.ndarray, widths: np.ndarray, endianness: Endianness
) -> np.ndarray:
    """Pack ``codes[i]`` (widths[i] bits each; width 0 = hole) into bytes."""
    codes = np.asarray(codes, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    offsets = np.cumsum(widths) - widths
    total_bits = int(offsets[-1] + widths[-1]) if len(widths) else 0
    n_bytes = packed_size(total_bits)
    out = np.zeros(n_bytes + 2, dtype=np.int64)  # +2 slack for 3-byte windows

    little = endianness is Endianness.LITTLE
    # A hole's mask is 0, so it adds nothing.
    masked = codes & ((1 << widths) - 1)
    byte_idx = offsets >> 3
    window = place_symbol(masked, offsets & 7, widths, little)
    for lane, vals in enumerate(split_lanes(window, little)):
        np.add.at(out, np.minimum(byte_idx + lane, n_bytes + 1), vals)
    return out[:n_bytes].astype(np.uint8)


def unpack_fixed_np(
    data: np.ndarray, width: int, endianness: Endianness
) -> np.ndarray:
    """Unpack all whole ``width``-bit codes from a byte array.

    Trailing bits that don't form a whole code are discarded, matching the
    EOF-tolerant bulk read of `io.rs:58-78`.
    """
    data = np.asarray(data, dtype=np.uint8)
    n_codes = (8 * len(data)) // width
    padded = np.concatenate([data.astype(np.int64), np.zeros(2, dtype=np.int64)])
    bit = np.arange(n_codes, dtype=np.int64) * width
    byte_idx = bit >> 3
    little = endianness is Endianness.LITTLE
    window = join_lanes((padded[byte_idx], padded[byte_idx + 1],
                         padded[byte_idx + 2]), little)
    return read_symbol(window, bit & 7, width, little).astype(np.int32)


# --------------------------------------------------------------------------- #
# torch                                                                       #
# --------------------------------------------------------------------------- #


def pack_codes_torch(codes: torch.Tensor, widths: torch.Tensor,
                     endianness: Endianness, out_bytes: int):
    """Pack on the codes' device into a buffer of a given size
    (``pack_codes_jax``, and ``jax.vmap`` of it for rows).

    Args:
      codes:  i32[S] code values (holes allowed), or i32[N, S] rows.
      widths: i32[S] or i32[N, S] bit widths, 0 marks a hole.
      endianness: the bit order.
      out_bytes: output buffer size per row; at least ceil(sum(widths) / 8).

    Returns:
      (u8[out_bytes] buffer zero-padded past the stream, i64 scalar tensor
      n_valid_bytes), or for rows (u8[N, out_bytes], i64[N]).  Bytes past
      ``out_bytes`` are dropped.

    Each code's bits are added at its bit offset by
    :func:`scatter_symbols`, the byte-lane scatter of the
    encoders' packer, into rows of ``out_bytes`` + 3 bytes: a code that
    starts past the buffer is moved to its end, so its three lanes land in
    the three slack bytes, which are dropped.
    """
    one = codes.dim() == 1
    if one:
        codes, widths = codes[None], widths[None]
    # A hole's mask (1 << 0) - 1 is 0, so it adds nothing.
    vals = codes.to(torch.int64) & ((1 << widths) - 1)
    n_bytes = (widths.sum(1, dtype=torch.int64) + 7) >> 3
    off = torch.cumsum(widths, 1, dtype=torch.int64)
    off -= widths
    off.clamp_(max=8 * out_bytes)
    out = torch.zeros((codes.shape[0], out_bytes + 3), dtype=torch.int64,
                      device=codes.device)
    scatter_symbols(out, vals, widths, off, endianness is Endianness.LITTLE)
    out = out[:, :out_bytes].to(torch.uint8)
    if one:
        return out[0], n_bytes[0]
    return out, n_bytes


def unpack_fixed_torch(data: torch.Tensor, width: int,
                       endianness: Endianness, n_codes: int) -> torch.Tensor:
    """Fixed-width unpack of ``n_codes`` codes (``unpack_fixed_jax``).

    ``data`` is u8[M] with at least ceil(n_codes * width / 8) valid bytes;
    callers compute ``n_codes = (8 * n_valid_bytes) // width``.  Returns
    i64[n_codes].
    """
    padded = torch.cat([data.to(torch.int64),
                        torch.zeros(2, dtype=torch.int64, device=data.device)])
    bit = torch.arange(n_codes, dtype=torch.int64, device=data.device) * width
    byte_idx = bit >> 3
    little = endianness is Endianness.LITTLE
    window = join_lanes((padded[byte_idx], padded[byte_idx + 1],
                         padded[byte_idx + 2]), little)
    return read_symbol(window, bit & 7, width, little)


def scatter_symbols(out, values, widths, bit_off, little: bool):
    """Add symbols (values i64[N, M], ``widths`` bits each, at static or
    per-row bit offsets ``bit_off``) into the byte buffer ``out`` i64[N,
    PB], one scatter-add a byte lane.  Symbols occupy disjoint bits, so
    adding equals OR-ing."""
    bit_off = bit_off.expand(out.shape[0], -1)
    b0 = bit_off >> 3
    window = place_symbol(values, bit_off & 7, widths, little)
    for lane, vals in enumerate(split_lanes(window, little)):
        out.scatter_add_(1, b0 + lane, vals)
