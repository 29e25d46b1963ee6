"""Decode pass 1: the CUDA kernel, its plain version and the glue around it.

Port of the pass-1 half of ``lzw_tpu/kernels/decode_pallas.py``: codes ->
copy/literal descriptors ``kind<<29 | len<<17 | payload`` plus per-block
total, err and err_code.  Pass 2, which resolves the descriptors into bytes,
is the native runtime's ``apply_words`` on the host.

TPU mechanics with no counterpart here: the lockstep group/cell/segment
tiles and the VMEM group budgets (decode_pallas.py:569-570,609-624), the
one-/two-plane and ring table layouts with their windowed scans (the kernel
indexes its tables by code), and the padding of the code axis to whole
cells.  ``MAX_BLOCK`` stays: the 17-bit descriptor payload that
``apply_words`` reads bounds the block size, not the TPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, LzwSpec

__all__ = [
    "decode_pass1", "decode_pass1_reference", "decode_pass1_fixed",
    "decode_pass1_variable", "prepare_variable_decode", "unpack12",
    "KIND_COPY", "KIND_LIT", "KIND_HOLE", "MAX_BLOCK",
]

KIND_COPY = 0
KIND_LIT = 1
KIND_HOLE = 2

MAX_BLOCK = 1 << 17  # descriptor payload bound (17 bits)
THREADS_PER_CTA = 8  # lanes per warp, as the encoder


def unpack12(payloads: torch.Tensor, plens: torch.Tensor, little: bool):
    """3 bytes -> 2 twelve-bit codes (decode_pallas.py:83-101).

    payloads u8[N, PB] (zero past plens, PB % 3 == 0); returns codes
    i32[N, 2*PB/3] and n_codes i32[N].
    """
    N, PB = payloads.shape
    if PB % 3:
        raise ValueError(f"payload width {PB} is not a multiple of 3")
    b = payloads.to(torch.int32).reshape(N, PB // 3, 3)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    if little:
        c0 = b0 | ((b1 & 0xF) << 8)
        c1 = (b1 >> 4) | (b2 << 4)
    else:
        c0 = (b0 << 4) | (b1 >> 4)
        c1 = ((b1 & 0xF) << 8) | b2
    codes = torch.stack([c0, c1], dim=-1).reshape(N, -1)
    n_codes = (8 * plens.to(torch.int32)) // 12
    return codes, n_codes


def _table_params(spec: LzwSpec | None) -> tuple[int, int]:
    """(alphabet, first_free) of the decoder's dictionary."""
    if spec is None or not spec.variable:
        return 256, 256
    return spec.alphabet_size, spec.first_free_code


def _check_inputs(codes, n_codes, sched, block_size):
    dev = codes.device
    build.require_tensor(codes, "codes", torch.int32, 2, dev)
    build.require_tensor(n_codes, "n_codes", torch.int32, 1, dev)
    if n_codes.shape[0] != codes.shape[0]:
        raise ValueError("n_codes and codes disagree on the block count")
    if sched is not None:
        build.require_tensor(sched, "sched", torch.int32, 2, dev)
        if tuple(sched.shape) != (2, codes.shape[1]):
            raise ValueError(
                f"sched has shape {tuple(sched.shape)}, expected "
                f"(2, {codes.shape[1]})"
            )
    if not 0 < block_size <= MAX_BLOCK:
        raise ValueError(f"block_size {block_size} outside 1..{MAX_BLOCK}")


def decode_pass1(codes: torch.Tensor, n_codes: torch.Tensor,
                 spec: LzwSpec | None, block_size: int,
                 sched: torch.Tensor | None = None):
    """Pass 1 over dense codes.

    Args:
      codes:   i32[N, S] wire codes per block.
      n_codes: i32[N] codes per block.
      spec:    the wire spec (``None`` or fixed: the fixed-12 table).
      block_size: decoded block bound (<= MAX_BLOCK).
      sched:   i32[2, S] schedule rows (next index - 1, epoch start) for a
               variable spec (:func:`prepare_variable_decode`), else None.
    Returns:
      (words i32[N, S], totals i32[N], err i32[N], err_code i32[N]); err 1
      is a code beyond the next index, err 2 an output overflow.

    CPU tensors run :func:`decode_pass1_reference`; CUDA tensors run the
    kernel, and anything else raises.
    """
    variable = spec is not None and spec.variable
    if variable != (sched is not None):
        raise ValueError("sched is required for, and only for, variable specs")
    _check_inputs(codes, n_codes, sched, block_size)
    if codes.device.type == "cpu":
        return decode_pass1_reference(codes, n_codes, spec, block_size, sched)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    dev = codes.device
    fn = build.load("decode_pass1").decode_pass1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        planes = torch.empty((2, N, MAX_TABLE_SIZE), dtype=torch.int32,
                             device=dev)
        words = torch.empty((N, S), dtype=torch.int32, device=dev)
        stats = torch.empty((3, N), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(codes.data_ptr(), n_codes.data_ptr(), N, S, block_size,
                alphabet, first_free,
                None if sched is None else sched.data_ptr(),
                planes[0].data_ptr(), planes[1].data_ptr(), words.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
                THREADS_PER_CTA, stream)
    build.check_launch("decode_pass1", rc)
    return words, stats[0], stats[1], stats[2]


def decode_pass1_reference(codes: torch.Tensor, n_codes: torch.Tensor,
                           spec: LzwSpec | None, block_size: int,
                           sched: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`decode_pass1`.

    A lockstep loop over code ordinals, vectorised over blocks, mirroring
    ``_decode_kernel``'s step (decode_pallas.py:176-361) with int64 tables
    indexed by code.
    """
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    nc = n_codes.to(torch.int64)
    rows = torch.arange(N, device=dev)
    # Column MAX_TABLE_SIZE takes the writes of blocks that insert nothing.
    tab_len = torch.zeros((N, MAX_TABLE_SIZE + 1), dtype=torch.int64,
                          device=dev)
    tab_first = torch.zeros_like(tab_len)
    tab_src = torch.zeros_like(tab_len)
    words = torch.empty((N, S), dtype=torch.int64, device=dev)
    z = torch.zeros(N, dtype=torch.int64, device=dev)
    prev_len, prev_first, off, err, err_code = z, z, z, z, z
    nxt = torch.full((N,), first_free, dtype=torch.int64, device=dev)
    sched_h = None if sched is None else sched.cpu().numpy()

    for t in range(S):
        code = codes[:, t]
        active = (t < nc) & (err == 0)
        if sched_h is not None:
            nxt = int(sched_h[0, t])  # the same for every block
            first_step = t == int(sched_h[1, t])
        else:
            first_step = t == 0
        root = code < alphabet
        kwkwk = code == nxt
        bad = active & (code > nxt) if not first_step else torch.zeros_like(
            active)
        err = torch.where(bad, 1, err)
        err_code = torch.where(bad, code, err_code)
        ok = active & ~bad
        is_lit = root | first_step
        lookup = ok & ~is_lit & ~kwkwk
        c = code & (MAX_TABLE_SIZE - 1)
        len_c = torch.where(lookup, tab_len[rows, c], 0)
        first_c = torch.where(lookup, tab_first[rows, c], 0)
        src_d = torch.where(lookup, tab_src[rows, c], 0)

        length = torch.where(is_lit, 1, torch.where(kwkwk, prev_len + 1,
                                                    len_c))
        if first_step:
            first = code & 0xFF
        else:
            first = torch.where(root, code,
                                torch.where(kwkwk, prev_first, first_c))
        lit_byte = torch.where(root, code, 0)
        src = torch.where(kwkwk, off - prev_len, src_d)

        over = ok & (off + length > block_size)
        err = torch.where(over, 2, err)
        err_code = torch.where(over, code, err_code)
        ok = ok & ~over

        kind = torch.where(ok, torch.where(is_lit, KIND_LIT, KIND_COPY),
                           KIND_HOLE)
        payload = torch.where(is_lit, lit_byte, src)
        words[:, t] = ((kind << 29) | (length << 17) | payload) & 0xFFFFFFFF

        ins = ok & (nxt < MAX_TABLE_SIZE)
        if first_step:
            ins = torch.zeros_like(ins)
        at = torch.where(ins, nxt, MAX_TABLE_SIZE)
        tab_len[rows, at] = (prev_len + 1) & 0xFFF
        tab_first[rows, at] = prev_first & 0xFF
        tab_src[rows, at] = off - prev_len
        if sched_h is None:
            nxt = nxt + ins.to(torch.int64)

        off = off + torch.where(ok, length, 0)
        prev_len = torch.where(ok, length, prev_len)
        prev_first = torch.where(ok, first, prev_first)

    # Reinterpret the low 32 bits as i32, as the TPU kernel's i32 words.
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (words.to(torch.int32), off.to(torch.int32), err.to(torch.int32),
            err_code.to(torch.int32))


def decode_pass1_fixed(payloads: torch.Tensor, plens: torch.Tensor,
                       block_size: int, little: bool = True):
    """Fixed-12 pass 1 from payload bytes (``decode_pass1_fixed_tpu``).

    payloads u8[N, PB] zero-padded with PB % 3 == 0, plens i32[N].  Returns
    (words i32[N, S], n_codes, totals, err, err_code, codes); ``codes`` maps
    a corrupt descriptor back to its wire code.
    """
    codes, n_codes = unpack12(payloads, plens, little)
    words, totals, err, err_code = decode_pass1(
        codes.contiguous(), n_codes.contiguous(), None, block_size
    )
    return words, n_codes, totals, err, err_code, codes


def prepare_variable_decode(payloads_np: np.ndarray, plens_np, spec: LzwSpec):
    """Host half of the strict variable decode (decode_pallas.py:522-548):
    per-stream code-count recovery, frame-level strictness and the static
    per-step schedule rows.

    Returns (counts i64[N], strict bool[N], sched_arr i32[2, S], S) with S
    the batch's longest stream (at least 1).
    """
    N = payloads_np.shape[0]
    counts, strict, S_raw = _sched.recover_counts(
        np.asarray(payloads_np), np.asarray(plens_np, dtype=np.int64), spec
    )
    S = max(min(S_raw, int(counts.max()) if N else 1), 1)
    sched = _sched.emission_schedule(spec, S)
    sched_arr = np.zeros((2, S), np.int32)
    sched_arr[0, :] = (sched.nxt_of[:S] - 1).astype(np.int32)
    sched_arr[1, :] = sched.epoch_start[:S].astype(np.int32)
    return counts, strict, sched_arr, S


def decode_pass1_variable(payloads_np: np.ndarray, plens_np, spec: LzwSpec,
                          block_size: int, device="cpu"):
    """Variable-flavor strict-stream pass 1 (``decode_pass1_variable_tpu``).

    Recovers counts on the host, moves the payload bytes to ``device``,
    unpacks the dense codes there and runs :func:`decode_pass1`.  Returns
    (words i32[N, S], n_codes i64[N], totals, err, err_code, strict bool[N]);
    rows whose ``strict`` is False need a general decoder.
    """
    counts, strict, sched_arr, S = prepare_variable_decode(
        payloads_np, plens_np, spec
    )
    payloads = torch.from_numpy(np.ascontiguousarray(payloads_np)).to(device)
    counts_t = torch.from_numpy(counts.astype(np.int32)).to(device)
    dense, data_ok = _sched.unpack_variable_device(payloads, counts_t, spec, S)
    words, totals, err, err_code = decode_pass1(
        dense, counts_t, spec, block_size,
        torch.from_numpy(sched_arr).to(device),
    )
    strict = strict & data_ok.cpu().numpy()
    return words, counts, totals, err, err_code, strict
