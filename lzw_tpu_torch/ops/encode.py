"""Static compressed-size bound (``lzw_tpu/ops/encode.py:packed_bound``).

The JAX package's portable lax codec is not ported; the port's encode runs
through ``lzw_tpu_torch.kernels.encode``.
"""

from __future__ import annotations

from lzw_tpu_torch.spec import MAX_TABLE_SIZE, MAX_WIDTH, LzwSpec

__all__ = ["packed_bound"]


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
