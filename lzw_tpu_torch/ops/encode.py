"""Single-stream LZW encode, and the static compressed-size bound.

Port of ``lzw_tpu/ops/encode.py``.  The JAX package encodes one stream with
its own XLA scan (``encode_block``: a hash-table dictionary, two (code,
width) slots per input byte) and packs the slots with
``bitpack.pack_codes_jax``.  The port has no second parse: the block
container's kernel ``csrc/encode_parse.cu``
(:func:`lzw_tpu_torch.kernels.encode.encode_blocks_codes`) takes a block of
any length and gives the same dense codes, so :func:`encode_stream_bytes`
launches it on one row and packs the codes against the static width
schedule (:func:`lzw_tpu_torch.kernels.schedule.pack_variable`) or in
12-bit pairs (:func:`lzw_tpu_torch.kernels.encode.pack12`).
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.encode import encode_blocks_codes, pack12
from lzw_tpu_torch.spec import (
    MAX_TABLE_SIZE, MAX_WIDTH, Endianness, LzwSpec, UnexpectedCodeError,
)

__all__ = ["MAX_STREAM", "encode_stream_bytes", "encoder_output_slots",
           "packed_bound"]

# The longest stream encode_stream_bytes takes: the parse kernel's block
# length and its dense code count are i32.
MAX_STREAM = 2**31 - 2


def encoder_output_slots(block_size: int) -> int:
    """Number of (code, width) slots for a block of ``block_size`` bytes.

    Slot layout: [CLEAR] + 2 per byte (miss code, possible reset CLEAR) +
    [final prefix, EOI].  Unused slots have width 0 and are skipped by the
    packer.
    """
    return 2 * block_size + 3


def packed_bound(block_size: int, spec: LzwSpec) -> int:
    """Static worst-case compressed size in bytes for one block."""
    if spec.variable:
        # Worst case: every byte misses at up to 12 bits, plus a CLEAR per
        # table fill (at least 4096 - 2**cs - 2 misses apart), plus leading
        # CLEAR and trailing prefix+EOI.
        resets = block_size // (MAX_TABLE_SIZE - spec.first_free_code) + 1
        bits = MAX_WIDTH * (block_size + resets + 3)
    else:
        bits = MAX_WIDTH * (block_size + 1)
    return (bits + 7) // 8 + 1


def encode_stream_bytes(data: bytes, spec: LzwSpec,
                        fix_eoi_width: bool = False,
                        device: str | torch.device = "cuda") -> bytes:
    """Compress one stream on ``device`` to salzweg's raw wire format.

    With ``fix_eoi_width=False`` (the default) the bytes are salzweg's, as
    the JAX facade calls ``encode_block``; ``True`` widens the EOI of a
    stream whose last data code lands on a width bump, as the container
    does (see ``lzw_tpu_torch.ops.reference.eoi_width_quirk``).  A CUDA
    device runs the encode-parse kernel, the CPU its plain version.
    Raises :class:`UnexpectedCodeError` for a byte past the alphabet after
    the first, and ValueError for a stream longer than :data:`MAX_STREAM`.
    """
    spec.validate()
    if len(data) > MAX_STREAM:
        raise ValueError(f"a stream of {len(data)} bytes is past the "
                         f"{MAX_STREAM} that the parse kernel's i32 "
                         "lengths take")
    device = torch.device(device)
    # One column at least: an empty stream is a row of length 0.
    row = np.zeros((1, max(len(data), 1)), np.uint8)
    row[0, : len(data)] = np.frombuffer(bytes(data), np.uint8)
    blocks = torch.from_numpy(row).to(device)
    lens = torch.tensor([len(data)], dtype=torch.int32, device=device)
    dense, counts, err, err_code = encode_blocks_codes(blocks, lens, spec)
    if int(err[0]):
        raise UnexpectedCodeError(int(err_code[0]), spec.code_size)
    codes = dense[:, : max(int(counts[0]), 1)]
    if spec.variable:
        bufs, n_bytes = _sched.pack_variable(codes, counts, spec,
                                             fix_eoi=fix_eoi_width)
    else:
        bufs, n_bytes = pack12(codes, counts,
                               spec.endianness is Endianness.LITTLE)
    return bufs[0, : int(n_bytes[0])].cpu().numpy().tobytes()
