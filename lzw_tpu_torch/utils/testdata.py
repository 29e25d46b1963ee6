"""Synthesised foreign-stream test vectors, built from the port's own encoder.

Port of ``lzw_tpu/utils/testdata.py``, whose scalar oracle lives in the JAX
package: here the codes come from the encode-parse kernel (its plain
version for CPU tensors) and the widths from the static emission schedule,
so the same stream can be made on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.encode import encode_blocks_codes
from lzw_tpu_torch.spec import LzwSpec, UnexpectedCodeError

__all__ = ["spliced_nonstrict_stream"]


def _pack_codes(codes: np.ndarray, widths: np.ndarray, little: bool) -> bytes:
    """Pack (code, width) symbols back to back, zero-filling the last byte
    (``lzw_tpu.ops.reference.pack_codes``)."""
    offs = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
    n_bytes = (int(widths.sum()) + 7) // 8
    out = torch.zeros((1, n_bytes + 3), dtype=torch.int64)
    _sched._scatter_symbols(
        out, torch.from_numpy(codes.astype(np.int64))[None],
        torch.from_numpy(widths.astype(np.int64))[None],
        torch.from_numpy(offs)[None], little,
    )
    return out[0, :n_bytes].to(torch.uint8).numpy().tobytes()


def spliced_nonstrict_stream(data: bytes, spec: LzwSpec, piece: int = 2000,
                             device="cpu") -> bytes:
    """A valid variable-flavor stream with EARLY CLEARs every ``piece``
    bytes: the foreign-stream shape the reference decoder takes
    (`decoder.rs:222-227`) and the strict-schedule decode does not.

    Each piece is encoded as its own stream (one batch of blocks on
    ``device``); a CLEAR at the decoder's current read width joins it to the
    previous one, and one EOI at that width ends the whole.  Byte-identical
    to ``lzw_tpu.utils.testdata.spliced_nonstrict_stream``.
    """
    if not spec.variable:
        raise ValueError("spliced_nonstrict_stream takes a variable-width spec")
    if not data:
        raise ValueError("spliced_nonstrict_stream needs at least one byte")
    if not 0 < piece < 3000:
        # Keeps each piece free of its own table-full CLEAR.
        raise ValueError(f"piece {piece} outside 1..2999")
    arr = np.frombuffer(bytes(data), np.uint8)
    n = -(-len(arr) // piece)
    blocks = np.zeros((n, piece), np.uint8)
    blocks.reshape(-1)[: len(arr)] = arr
    lens = np.full(n, piece, np.int32)
    lens[-1] = len(arr) - (n - 1) * piece
    dense, counts, errs, err_codes = encode_blocks_codes(
        torch.from_numpy(blocks).to(device), torch.from_numpy(lens).to(device),
        spec,
    )
    errs = errs.cpu().numpy()
    if errs.any():
        i = int(np.argmax(errs != 0))
        raise UnexpectedCodeError(int(err_codes[i]), spec.code_size)
    dense, counts = dense.cpu().numpy(), counts.cpu().numpy()
    sched = _sched.emission_schedule(spec, int(counts.max()) + 1)
    codes, widths = [], []
    clear_w = spec.initial_width
    for i in range(n):
        k = int(counts[i])
        codes += [spec.clear_code, *dense[i, :k].tolist()]
        widths += [clear_w, *sched.widths[:k].tolist()]
        clear_w = sched.eoi_width(k, True)  # the decoder's width here
    codes.append(spec.end_code)
    widths.append(clear_w)
    return _pack_codes(np.asarray(codes), np.asarray(widths),
                       spec.endianness.value == "little")
