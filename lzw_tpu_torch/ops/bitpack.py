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
of the tensors it is given.  No codec path of the port calls this module
(the encoders pack with :mod:`lzw_tpu_torch.kernels.schedule` and
``kernels.encode.pack12``): it is the counterpart of
``lzw_tpu.ops.bitpack``'s public functions for callers of that module,
and :func:`pack_codes_torch` packs the slots of
:func:`lzw_tpu_torch.ops.encode.encode_block`.
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels.schedule import _scatter_symbols
from lzw_tpu_torch.spec import Endianness

__all__ = [
    "pack_codes_np",
    "unpack_fixed_np",
    "pack_codes_torch",
    "unpack_fixed_torch",
    "packed_size",
]


def packed_size(total_bits: int) -> int:
    return (total_bits + 7) // 8


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

    valid = widths > 0
    masked = np.where(valid, codes & ((1 << widths) - 1), 0)
    byte_idx = offsets >> 3
    shift = offsets & 7
    if endianness is Endianness.LITTLE:
        window = masked << shift
        lanes = (window & 0xFF, (window >> 8) & 0xFF, (window >> 16) & 0xFF)
    else:
        window = masked << (24 - widths - shift)
        # width-0 holes would shift by 24-0-sh; masked is 0 there so harmless,
        # but clamp the shift to stay in defined range.
        window = np.where(valid, window, 0)
        lanes = ((window >> 16) & 0xFF, (window >> 8) & 0xFF, window & 0xFF)
    for lane, vals in enumerate(lanes):
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
    shift = bit & 7
    b0, b1, b2 = padded[byte_idx], padded[byte_idx + 1], padded[byte_idx + 2]
    mask = (1 << width) - 1
    if endianness is Endianness.LITTLE:
        window = b0 | (b1 << 8) | (b2 << 16)
        return ((window >> shift) & mask).astype(np.int32)
    window = (b0 << 16) | (b1 << 8) | b2
    return ((window >> (24 - shift - width)) & mask).astype(np.int32)


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
    ``kernels.schedule._scatter_symbols``, the byte-lane scatter of the
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
    _scatter_symbols(out, vals, widths, off,
                     endianness is Endianness.LITTLE)
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
    shift = bit & 7
    b0 = padded[byte_idx]
    b1 = padded[byte_idx + 1]
    b2 = padded[byte_idx + 2]
    mask = (1 << width) - 1
    if endianness is Endianness.LITTLE:
        window = b0 | (b1 << 8) | (b2 << 16)
        return (window >> shift) & mask
    window = (b0 << 16) | (b1 << 8) | b2
    return (window >> (24 - shift - width)) & mask
