"""Decode passes 1 and 2: the CUDA kernels, their plain versions and glue.

Port of ``lzw_tpu/kernels/decode_pallas.py``.  Pass 1: codes -> copy/literal
descriptors ``kind<<29 | len<<17 | payload`` plus per-block total, err and
err_code, and on request one kind of pair rows (stride-1 or stride-2).
Pass 2 resolves them into bytes: either the native runtime's
``apply_words`` on the host, or an all-device chain walk, the stride-2
:func:`decode_pass2_stride2` or the stride-1 :func:`decode_pass2_device`.

TPU mechanics with no counterpart here: the lockstep group/cell/segment
tiles and the VMEM group budgets (decode_pallas.py:569-570,609-624), the
one-/two-plane and ring table layouts with their windowed scans (the kernel
indexes its tables by code), and the padding of the code axis to whole
cells.  ``MAX_BLOCK`` stays: the 17-bit descriptor payload that
``apply_words`` reads bounds the block size, not the TPU.  Both pass-2
walks drop the TPU's backwards lockstep walk with its epoch units, pooling
and sorting, round segments, epoch-carrying code bits, reversed output,
per-lane shift and flip (decode_pallas.py:884-1056, 1169-1171, 1260,
1461-1566, 1619-1693): each word's output offset is the prefix sum of
pass 1's descriptor lengths (:func:`word_ends`, the kernel ``word_ends``),
so every code slot resolves its own word in place.  The ``_flat`` walks
put each block's bytes at the prefix sum of pass 1's totals, back to back
as the container returns them, so the host fetches one buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lzw_tpu_torch.kernels import build, chains
from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.ops.bitpack import join_lanes, split_lanes
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, LzwSpec
from lzw_tpu_torch.utils import spans

__all__ = [
    "decode_pass1", "decode_pass1_reference", "decode_pass1_fixed",
    "decode_pass1_variable", "prepare_variable_decode", "unpack12",
    "variable_pass1", "VariablePass1",
    "word_ends", "decode_pass2_stride2", "decode_pass2_stride2_flat",
    "decode_pass2_stride2_reference", "decode_pass2_device",
    "decode_pass2_device_flat", "decode_pass2_device_reference", "to_host",
    "decode_variable_all_device", "decode_fixed_all_device",
    "KIND_COPY", "KIND_LIT", "KIND_HOLE", "MAX_BLOCK", "ROW_KINDS",
]

KIND_COPY = 0
KIND_LIT = 1
KIND_HOLE = 2

MAX_BLOCK = 1 << 17  # descriptor payload bound (17 bits)
# The pair rows pass 1 may write, by the index the kernel takes.
ROW_KINDS = ("none", "stride1", "stride2")


def unpack12(payloads: torch.Tensor, plens: torch.Tensor, little: bool):
    """3 bytes -> 2 twelve-bit codes (decode_pallas.py:83-101).

    payloads u8[N, PB] (zero past plens, PB % 3 == 0); returns codes
    i32[N, 2*PB/3] and n_codes i32[N].
    """
    N, PB = payloads.shape
    if PB % 3:
        raise ValueError(f"payload width {PB} is not a multiple of 3")
    b = payloads.to(torch.int32).reshape(N, PB // 3, 3)
    pair = split_lanes(join_lanes((b[..., 0], b[..., 1], b[..., 2]), little),
                       little, n=2, bits=12)
    codes = torch.stack(pair, dim=-1).reshape(N, -1)
    n_codes = (8 * plens.to(torch.int32)) // 12
    return codes, n_codes


def _table_params(spec: LzwSpec | None) -> tuple[int, int]:
    """(alphabet, first_free) of the decoder's dictionary."""
    if spec is None or not spec.variable:
        return 256, 256
    return spec.alphabet_size, spec.first_free_code


def _row_kind(rows: str) -> int:
    if rows not in ROW_KINDS:
        raise ValueError(f"rows must be one of {ROW_KINDS}, got {rows!r}")
    return ROW_KINDS.index(rows)


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
                 sched: torch.Tensor | None = None, rows: str = "none"):
    """Pass 1 over dense codes.

    Args:
      codes:   i32[N, S] wire codes per block (not negative).
      n_codes: i32[N] codes per block.
      spec:    the wire spec (``None`` or fixed: the fixed-12 table).
      block_size: decoded block bound (<= MAX_BLOCK).
      sched:   i32[2, S] schedule rows (next index - 1, epoch start) for a
               variable spec, ``schedule.schedule_rows(spec, S)``
               (:func:`prepare_variable_decode`), else None.
      rows:    which pair rows i32[N, S] to return besides (one of
               :data:`ROW_KINDS`).  Row t describes the entry created at
               step t (code c, prefix p), 0 where none was: ``"stride1"``
               gives ``c<<20 | p<<8 | suffix(c)`` (bit 31 set from code 2048
               on), which :func:`decode_pass2_device` walks; ``"stride2"``
               gives ``done<<28 | prefix(p)<<16 | suffix(p)<<8 | suffix(c)``,
               which :func:`decode_pass2_stride2` walks.
    Returns:
      (words i32[N, S], totals i32[N], err i32[N], err_code i32[N]), plus
      the pair rows last unless ``rows`` is ``"none"``; err 1 is a code
      beyond the next index, err 2 an output overflow.  The first four do
      not depend on ``rows``.

    CPU tensors run :func:`decode_pass1_reference`; CUDA tensors run the
    kernel (a CTA per block, its dictionary epochs in turn), and anything
    else raises.
    """
    variable = spec is not None and spec.variable
    if variable != (sched is not None):
        raise ValueError("sched is required for, and only for, variable specs")
    row_kind = _row_kind(rows)
    _check_inputs(codes, n_codes, sched, block_size)
    if codes.device.type == "cpu":
        return decode_pass1_reference(codes, n_codes, spec, block_size, sched,
                                      rows)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    dev = codes.device
    # A variable block's epochs start every epoch_steps codes; a fixed-12
    # block is one epoch up to the table's freeze, then its frozen tail.
    if sched is None:
        period, epochs = MAX_TABLE_SIZE + 1 - first_free, 1
    else:
        period = _sched.epoch_steps(spec)
        epochs = max(-(-S // period), 1)
    fn = build.bound("decode_pass1", "decode_pass1_launch")
    with build.on_device(dev):
        words = torch.empty((N, S), dtype=torch.int32, device=dev)
        pair = (torch.empty((N, S), dtype=torch.int32, device=dev)
                if row_kind else None)
        stats = torch.empty((3, N), dtype=torch.int32, device=dev)
        rc = fn(codes.data_ptr(), n_codes.data_ptr(), N, S, block_size,
                alphabet, first_free,
                None if sched is None else sched.data_ptr(), period, epochs,
                words.data_ptr(), None if pair is None else pair.data_ptr(),
                row_kind, stats[0].data_ptr(), stats[1].data_ptr(),
                stats[2].data_ptr(), *chains.DECODE_PASS1, build.stream(dev))
    build.check_launch("decode_pass1", rc)
    out = (words, stats[0], stats[1], stats[2])
    return out + (pair,) if row_kind else out


def decode_pass1_reference(codes: torch.Tensor, n_codes: torch.Tensor,
                           spec: LzwSpec | None, block_size: int,
                           sched: torch.Tensor | None = None,
                           rows: str = "none"):
    """Plain PyTorch version of :func:`decode_pass1`.

    A lockstep loop over code ordinals, vectorised over blocks, mirroring
    ``_decode_kernel``'s step (decode_pallas.py:176-361) with int64 tables
    indexed by code.
    """
    _row_kind(rows)
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    nc = n_codes.to(torch.int64)
    blk = torch.arange(N, device=dev)
    # Column MAX_TABLE_SIZE takes the writes of blocks that insert nothing.
    tab_len = torch.zeros((N, MAX_TABLE_SIZE + 1), dtype=torch.int64,
                          device=dev)
    tab_first = torch.zeros_like(tab_len)
    tab_src = torch.zeros_like(tab_len)
    tab_pfx = torch.zeros_like(tab_len)
    tab_sfx = torch.zeros_like(tab_len)
    words = torch.empty((N, S), dtype=torch.int64, device=dev)
    pair = torch.zeros((N, S), dtype=torch.int64, device=dev)
    z = torch.zeros(N, dtype=torch.int64, device=dev)
    prev_len, prev_first, off, err, err_code, prev_code = z, z, z, z, z, z
    # (prefix << 8 | suffix) of the code consumed at the previous step, -1
    # after a root or literal.
    pps = torch.full((N,), -1, dtype=torch.int64, device=dev)
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
        len_c = torch.where(lookup, tab_len[blk, c], 0)
        first_c = torch.where(lookup, tab_first[blk, c], 0)
        src_d = torch.where(lookup, tab_src[blk, c], 0)
        pfx_c = torch.where(lookup, tab_pfx[blk, c], 0)
        sfx_c = torch.where(lookup, tab_sfx[blk, c], 0)

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
        tab_len[blk, at] = (prev_len + 1) & 0xFFF
        tab_first[blk, at] = prev_first & 0xFF
        tab_src[blk, at] = off - prev_len
        tab_pfx[blk, at] = prev_code & 0xFFF
        tab_sfx[blk, at] = first & 0xFF
        if rows == "stride1":
            row = (nxt << 20) | (prev_code << 8) | first
        else:
            row = torch.where(
                pps < 0,
                (1 << 28) | ((prev_code & 0xFF) << 8) | (first & 0xFF),
                ((pps >> 8) << 16) | ((pps & 0xFF) << 8) | (first & 0xFF))
        pair[:, t] = torch.where(ins, row, 0)
        if sched_h is None:
            nxt = nxt + ins.to(torch.int64)

        pps_new = torch.where(
            is_lit, -1,
            torch.where(kwkwk, (prev_code << 8) | (first & 0xFF),
                        (pfx_c << 8) | sfx_c))
        pps = torch.where(ok, pps_new, pps)
        off = off + torch.where(ok, length, 0)
        prev_len = torch.where(ok, length, prev_len)
        prev_first = torch.where(ok, first, prev_first)
        prev_code = torch.where(ok, code, prev_code)

    out = (_low32(words), off.to(torch.int32), err.to(torch.int32),
           err_code.to(torch.int32))
    return out if rows == "none" else out + (_low32(pair),)


def _low32(a: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as i32, as the TPU kernel's i32
    words and rows hold them."""
    a = a & 0xFFFFFFFF
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def decode_pass1_fixed(payloads: torch.Tensor, plens: torch.Tensor,
                       block_size: int, little: bool = True,
                       rows: str = "none"):
    """Fixed-12 pass 1 from payload bytes (``decode_pass1_fixed_tpu``).

    payloads u8[N, PB] zero-padded with PB % 3 == 0, plens i32[N].  Returns
    (words i32[N, S], n_codes, totals, err, err_code, codes), plus the pair
    rows of kind ``rows`` last (:func:`decode_pass1`); ``codes`` maps a
    corrupt descriptor back to its wire code.
    """
    codes, n_codes = unpack12(payloads, plens, little)
    codes, n_codes = codes.contiguous(), n_codes.contiguous()
    words, totals, err, err_code, *pair = decode_pass1(
        codes, n_codes, None, block_size, rows=rows
    )
    return (words, n_codes, totals, err, err_code, codes, *pair)


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
    with spans.span("recover.schedule_rows"):
        rows = _sched.schedule_rows(spec, S)
    return counts, strict, rows, S


class VariablePass1(NamedTuple):
    """Pass 1 of a strict variable batch (:func:`variable_pass1`)."""

    dense: torch.Tensor     # i32[N, S] wire codes, on the device
    counts: np.ndarray      # i64[N] recovered code counts
    counts_t: torch.Tensor  # the same, i32 on the device
    sched: torch.Tensor     # i32[2, S] schedule rows, on the device
    strict: np.ndarray      # bool[N]; False rows need a general decoder
    words: torch.Tensor
    totals: torch.Tensor
    err: torch.Tensor
    err_code: torch.Tensor
    pair: torch.Tensor | None  # the pair rows asked for, if any


def variable_pass1(payloads_np: np.ndarray, plens_np, spec: LzwSpec,
                   block_size: int, device="cuda", rows: str = "none",
                   stage=None, prep=None) -> VariablePass1:
    """Strict variable-flavor pass 1 from payload bytes
    (``_variable_pass1_from_payloads``): host count recovery, H2D, device
    unpack, :func:`decode_pass1` with pair rows of kind ``rows``.

    ``stage(name)``, when given, is a context manager timing each step
    (``dec_count_recovery``, ``dec_h2d``, ``dec_unpack``, ``dec_pass1``).
    ``prep``, when given, is :func:`prepare_variable_decode`'s result for
    these payloads, so a caller that has checked ``strict`` on the host does
    not recover the counts twice.
    """
    stage = stage or spans.span
    if prep is None:
        with stage("dec_count_recovery"):
            prep = prepare_variable_decode(payloads_np, plens_np, spec)
    counts, strict, sched_arr, S = prep
    with stage("dec_h2d"):
        payloads = torch.from_numpy(np.ascontiguousarray(payloads_np)).to(
            device)
        counts_t = torch.from_numpy(counts.astype(np.int32)).to(device)
        sched_t = torch.from_numpy(sched_arr).to(device)
    with stage("dec_unpack"):
        dense, data_ok = _sched.unpack_variable_device(payloads, counts_t,
                                                       spec, S)
    with stage("dec_pass1"):
        words, totals, err, err_code, *pair = decode_pass1(
            dense, counts_t, spec, block_size, sched_t, rows=rows
        )
    with spans.span("dec_strict"):
        strict = strict & data_ok.cpu().numpy()
    return VariablePass1(dense, counts, counts_t, sched_t, strict, words,
                         totals, err, err_code, pair[0] if pair else None)


def decode_pass1_variable(payloads_np: np.ndarray, plens_np, spec: LzwSpec,
                          block_size: int, device="cuda"):
    """Variable-flavor strict-stream pass 1 (``decode_pass1_variable_tpu``).

    Returns (words i32[N, S], n_codes i64[N], totals, err, err_code, strict
    bool[N]); rows whose ``strict`` is False need a general decoder.
    """
    p = variable_pass1(payloads_np, plens_np, spec, block_size, device)
    return p.words, p.counts, p.totals, p.err, p.err_code, p.strict


def _word_ends(words: torch.Tensor, n_codes: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """Plain version of :func:`word_ends`: the inclusive prefix sum of the
    word lengths, clipped to ``block_size``, over every slot (holes and
    slots past n_codes count 0; ``_epoch_totals``,
    decode_pallas.py:698-709)."""
    S = words.shape[1]
    live = (torch.arange(S, device=words.device)[None, :]
            < n_codes.to(torch.int64)[:, None]) & ((words >> 29) != KIND_HOLE)
    lens = torch.where(live, (words >> 17) & 0xFFF, 0)
    return torch.cumsum(lens, dim=1, dtype=torch.int32).clamp_(max=block_size)


def word_ends(words: torch.Tensor, n_codes: torch.Tensor,
              block_size: int) -> torch.Tensor:
    """Where each word of pass 1 goes: i32[N, S] inclusive ends, word t of
    block n filling bytes [ends[n, t-1], ends[n, t]) of the block.

    The sum of the descriptor lengths of slots 0..t, holes counting 0,
    clipped to ``block_size``.  Only slots below ``n_codes`` are defined:
    the kernel ``word_ends`` reads and writes no other slot.  CPU tensors
    run :func:`_word_ends`; CUDA tensors run the kernel, and anything else
    raises.
    """
    dev = words.device
    build.require_tensor(words, "words", torch.int32, 2, dev)
    build.require_tensor(n_codes, "n_codes", torch.int32, 1, dev)
    if n_codes.shape[0] != words.shape[0]:
        raise ValueError("n_codes and words disagree on the block count")
    if not 0 < block_size <= MAX_BLOCK:
        raise ValueError(f"block_size {block_size} outside 1..{MAX_BLOCK}")
    if dev.type == "cpu":
        return _word_ends(words, n_codes, block_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N, S = words.shape
    fn = build.bound("word_ends", "word_ends_launch")
    with build.on_device(dev):
        ends = torch.empty((N, S), dtype=torch.int32, device=dev)
        rc = fn(words.data_ptr(), n_codes.data_ptr(), N, S, block_size,
                ends.data_ptr(), build.stream(dev))
    build.check_launch("word_ends", rc)
    return ends


class _WalkPlan(NamedTuple):
    """A pass-2 walk's launch inputs on the card (:func:`_walk_plan`)."""

    ends: torch.Tensor         # i32[N, S] word ends (:func:`word_ends`)
    base: torch.Tensor | None  # i64[N] output offsets (flat mode)
    size: int                  # output bytes


def _walk_plan(words, n_codes, totals, block_size) -> _WalkPlan:
    """The word ends and, with ``totals``, each block's output offset, the
    exclusive prefix sum of its totals, and the output size (flat mode
    reads it back from the card: one synchronisation)."""
    ends = word_ends(words, n_codes, block_size)
    if totals is None:
        return _WalkPlan(ends, None, words.shape[0] * block_size)
    t = totals.to(torch.int64).clamp(min=0)
    base_end = torch.cumsum(t, 0)
    size = int(base_end[-1]) if t.numel() else 0
    return _WalkPlan(ends, base_end - t, size)


def _launch_walk(kernel: str, codes, pair, n_codes, sched, totals,
                 plan: _WalkPlan, block_size: int, spec,
                 out: torch.Tensor) -> None:
    """Launch walk ``kernel``, one CTA per block, into ``out`` (flat when
    ``totals`` is given, else padded [N, block_size] and zeroed)."""
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    fn = build.bound(kernel, f"{kernel}_launch")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with build.on_device(codes.device):
        rc = fn(codes.data_ptr(), plan.ends.data_ptr(), pair.data_ptr(),
                n_codes.data_ptr(), ptr(sched), ptr(totals), ptr(plan.base),
                N, S, block_size, alphabet, first_free, out.data_ptr(),
                build.stream(codes.device))
    build.check_launch(kernel, rc)


def _pass2(kernel: str, reference, codes, words, pair, n_codes, block_size,
           spec, sched, totals=None) -> torch.Tensor:
    """Shared wrapper of the two pass-2 kernels, padded or, with
    ``totals``, flat: checks, then the plain version for CPU tensors or
    :func:`word_ends` and the kernel ``kernel`` for CUDA tensors."""
    variable = spec is not None and spec.variable
    if variable != (sched is not None):
        raise ValueError("sched is required for, and only for, variable specs")
    _check_inputs(codes, n_codes, sched, block_size)
    for name, t in (("words", words), ("pair", pair)):
        build.require_tensor(t, name, torch.int32, 2, codes.device)
        if t.shape != codes.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(codes.shape)}")
    if totals is not None:
        build.require_tensor(totals, "totals", torch.int32, 1, codes.device)
        if totals.shape[0] != codes.shape[0]:
            raise ValueError("totals and codes disagree on the block count")
    if codes.device.type == "cpu":
        return reference(codes, words, pair, n_codes, block_size, spec, sched,
                         totals)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    dev = codes.device
    with build.on_device(dev):
        plan = _walk_plan(words, n_codes, totals, block_size)
        if totals is None:
            out = torch.zeros((codes.shape[0], block_size), dtype=torch.uint8,
                              device=dev)
        else:
            out = torch.empty(plan.size, dtype=torch.uint8, device=dev)
        _launch_walk(kernel, codes, pair, n_codes, sched, totals, plan,
                     block_size, spec, out)
    return out


def decode_pass2_stride2(codes: torch.Tensor, words: torch.Tensor,
                         pair2: torch.Tensor, n_codes: torch.Tensor,
                         block_size: int, spec: LzwSpec | None = None,
                         sched: torch.Tensor | None = None) -> torch.Tensor:
    """All-device pass 2, two bytes per pair row: pass-1 outputs ->
    decoded bytes, one zero-padded row per block.

    Args:
      codes:   i32[N, S] dense wire codes (pass 1's input).
      words:   i32[N, S] pass-1 descriptors; their lengths place each word.
      pair2:   i32[N, S] pass-1 stride-2 pair rows (``rows="stride2"``).
      n_codes: i32[N] codes per block.
      block_size: output width; every block's total must fit.
      spec, sched: as for :func:`decode_pass1` (code c of step t lives at
        pair row ``epoch_start(t) + 1 + c - first_free``; ``c - 255`` for
        fixed-12).
    Returns u8[N, block_size], zero past each block's total.

    The JAX package's ``decode_pass2_stride2`` takes ``totals`` where this
    takes ``words``: the offsets of the words replace its reversed walk.
    CPU tensors run :func:`decode_pass2_stride2_reference`; CUDA tensors
    run the kernels ``word_ends`` and ``decode_pass2``, and anything else
    raises.  :func:`decode_pass2_stride2_flat` writes the blocks' bytes back
    to back instead.
    """
    return _pass2("decode_pass2", decode_pass2_stride2_reference, codes,
                  words, pair2, n_codes, block_size, spec, sched)


def decode_pass2_stride2_flat(codes: torch.Tensor, words: torch.Tensor,
                              pair2: torch.Tensor, n_codes: torch.Tensor,
                              totals: torch.Tensor, block_size: int,
                              spec: LzwSpec | None = None,
                              sched: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """:func:`decode_pass2_stride2` with the blocks' bytes back to back, in
    block order: u8[sum(totals)], block n's bytes from the exclusive prefix
    sum of ``totals`` (i32[N], pass 1's) on.

    Every write of block n stays inside [0, min(totals[n], block_size)) of
    the block, so a corrupt block cannot write into a neighbour's bytes.
    Nothing is zeroed: a block whose words do not tile [0, totals[n]) (one
    with a pass-1 error) leaves bytes undefined on CUDA tensors (0 on the
    CPU).
    """
    return _pass2("decode_pass2", decode_pass2_stride2_reference, codes,
                  words, pair2, n_codes, block_size, spec, sched, totals)


def decode_pass2_device(codes: torch.Tensor, words: torch.Tensor,
                        pair: torch.Tensor, n_codes: torch.Tensor,
                        block_size: int, spec: LzwSpec | None = None,
                        sched: torch.Tensor | None = None) -> torch.Tensor:
    """All-device pass 2, one byte per pair row: pass-1 outputs -> decoded
    bytes (kernel ``decode_pass2_stride1``).

    Arguments and result as for :func:`decode_pass2_stride2`, with ``pair``
    the stride-1 pair rows of pass 1 (``rows="stride1"``).

    Contract differences from the JAX package's ``decode_pass2_device``:
    it takes ``totals`` where this takes ``words`` (the offsets of the
    words replace its reversed walk); its variable-flavor codes carry each
    step's epoch start in their high bits (``code | epoch_start << 12``),
    where this reads it from ``sched`` row 1 and takes plain wire codes;
    its pair rows are in its kernel layout (G, S, sub, 128), these
    block-major [N, S].  CPU tensors run
    :func:`decode_pass2_device_reference`; CUDA tensors run the kernels,
    and anything else raises.
    """
    return _pass2("decode_pass2_stride1", decode_pass2_device_reference,
                  codes, words, pair, n_codes, block_size, spec, sched)


def decode_pass2_device_flat(codes: torch.Tensor, words: torch.Tensor,
                             pair: torch.Tensor, n_codes: torch.Tensor,
                             totals: torch.Tensor, block_size: int,
                             spec: LzwSpec | None = None,
                             sched: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """:func:`decode_pass2_device` with the blocks' bytes back to back, as
    :func:`decode_pass2_stride2_flat` writes them."""
    return _pass2("decode_pass2_stride1", decode_pass2_device_reference,
                  codes, words, pair, n_codes, block_size, spec, sched,
                  totals)


def _walk_start(codes, words, n_codes, block_size, spec, sched, totals):
    """Shared start of the plain pass-2 walks, vectorised over code slots:
    writes every one-byte word (a root, or an epoch's first code) into the
    output, u8[N * block_size] or, with ``totals``, u8[sum(totals)], and
    returns it with the state of the other slots' walks (block, the
    block's output offset, node, last position, first position, pair-row
    base)."""
    alphabet, first_free = _table_params(spec)
    N, S = codes.shape
    dev = codes.device
    B = block_size
    if totals is None:
        base = torch.arange(N, device=dev) * B
        lim = torch.full((N,), B, dtype=torch.int64, device=dev)
        size = N * B
    else:
        lim = totals.to(torch.int64).clamp(min=0)
        base = torch.cumsum(lim, 0) - lim
        size = int(lim.sum())
        lim = lim.clamp(max=B)
    ends = torch.minimum(_word_ends(words, n_codes, B).to(torch.int64),
                         lim[:, None])
    starts = torch.cat(
        [torch.zeros((N, 1), dtype=torch.int64, device=dev), ends[:, :-1]],
        dim=1)
    t = torch.arange(S, device=dev)
    est = (sched[1].to(torch.int64) if sched is not None
           else torch.zeros(S, dtype=torch.int64, device=dev))
    codes = codes.to(torch.int64)
    flat = torch.zeros(size, dtype=torch.uint8, device=dev)
    valid = ends > starts
    lit = valid & ((t == est)[None, :] | (codes < alphabet))
    n_i, t_i = lit.nonzero(as_tuple=True)
    c = codes[n_i, t_i]
    flat[base[n_i] + starts[n_i, t_i]] = torch.where(
        c < alphabet, c, 0).to(torch.uint8)
    n_i, t_i = (valid & ~lit).nonzero(as_tuple=True)
    return flat, (n_i, base[n_i], codes[n_i, t_i], ends[n_i, t_i] - 1,
                  starts[n_i, t_i], est[t_i] + 1 - first_free)


def decode_pass2_stride2_reference(codes: torch.Tensor, words: torch.Tensor,
                                   pair2: torch.Tensor, n_codes: torch.Tensor,
                                   block_size: int,
                                   spec: LzwSpec | None = None,
                                   sched: torch.Tensor | None = None,
                                   totals: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`decode_pass2_stride2`, and with
    ``totals`` of :func:`decode_pass2_stride2_flat`.

    Vectorised over code slots, one loop iteration per chain step: each
    slot writes its word's last bytes first, two per pair row, as the
    kernel's threads do.
    """
    alphabet, _ = _table_params(spec)
    N, S = codes.shape
    pair = pair2.to(torch.int64).reshape(-1)
    flat, (n_i, o_i, node, pos, lo, base) = _walk_start(
        codes, words, n_codes, block_size, spec, sched, totals)
    while n_i.numel():
        root = node < alphabet
        flat[o_i[root] + pos[root]] = node[root].to(torch.uint8)
        row = base + node
        keep = ~root & (row >= 0) & (row < S)
        n_i, o_i, node, pos, lo, base, row = (
            a[keep] for a in (n_i, o_i, node, pos, lo, base, row))
        d = pair[n_i * S + row]
        flat[o_i + pos] = (d & 0xFF).to(torch.uint8)
        pos = pos - 1
        two = pos >= lo
        flat[o_i[two] + pos[two]] = ((d[two] >> 8) & 0xFF).to(torch.uint8)
        pos = pos - 1
        keep = two & ((d >> 28) == 0) & (pos >= lo)
        node = (d >> 16) & 0xFFF
        n_i, o_i, node, pos, lo, base = (
            a[keep] for a in (n_i, o_i, node, pos, lo, base))
    return flat if totals is not None else flat.reshape(N, block_size)


def decode_pass2_device_reference(codes: torch.Tensor, words: torch.Tensor,
                                  pair: torch.Tensor, n_codes: torch.Tensor,
                                  block_size: int,
                                  spec: LzwSpec | None = None,
                                  sched: torch.Tensor | None = None,
                                  totals: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`decode_pass2_device`, and with
    ``totals`` of :func:`decode_pass2_device_flat`.

    Vectorised over code slots, one loop iteration per chain step: each
    slot writes its word's last byte first, one per pair row, as the
    kernel's threads do.
    """
    alphabet, _ = _table_params(spec)
    N, S = codes.shape
    pair = pair.to(torch.int64).reshape(-1)
    flat, (n_i, o_i, node, pos, lo, base) = _walk_start(
        codes, words, n_codes, block_size, spec, sched, totals)
    while n_i.numel():
        root = node < alphabet
        flat[o_i[root] + pos[root]] = node[root].to(torch.uint8)
        row = base + node
        keep = ~root & (row >= 0) & (row < S)
        n_i, o_i, node, pos, lo, base, row = (
            a[keep] for a in (n_i, o_i, node, pos, lo, base, row))
        d = pair[n_i * S + row]
        flat[o_i + pos] = (d & 0xFF).to(torch.uint8)
        pos = pos - 1
        node = (d >> 8) & 0xFFF
        keep = pos >= lo
        n_i, o_i, node, pos, lo, base = (
            a[keep] for a in (n_i, o_i, node, pos, lo, base))
    return flat if totals is not None else flat.reshape(N, block_size)


def to_host(flat: torch.Tensor, out: torch.Tensor | None = None
            ) -> np.ndarray:
    """Decoded bytes on the host: a CUDA tensor in one copy into ``out``
    (a host tensor of its shape, pinned for an asynchronous copy) or into
    new pinned memory, then one synchronisation of its stream; a CPU
    tensor copied into ``out``, or as it is."""
    if out is None:
        if flat.device.type != "cuda":
            return flat.numpy()
        out = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    out.copy_(flat, non_blocking=True)
    if flat.device.type == "cuda":
        torch.cuda.current_stream(flat.device).synchronize()
    return out.numpy()


def decode_variable_all_device(payloads_np: np.ndarray, plens_np,
                               spec: LzwSpec, block_size: int,
                               device="cuda", stage=None,
                               stride2: bool = True, flat: bool = False,
                               prep=None):
    """Whole strict variable-flavor decode on ``device``
    (``decode_variable_all_device``): :func:`variable_pass1` with pair
    rows (``prep`` as there), then pass 2 (stage ``dec_pass2``).

    ``stride2`` (the name of ``decode_variable_epochs_run``'s option)
    picks the walk: stride-2 rows and :func:`decode_pass2_stride2` (the
    default), or stride-1 rows and :func:`decode_pass2_device`.  The JAX
    function's ``epoch_split`` and ``pooled`` have no meaning here: pass 2
    reads each code's epoch start from the schedule rows, so there are no
    epoch units to split or pool, and this one whole-stream route stands
    for the JAX package's ``epoch_split=False`` route and for its
    per-epoch ``stride2=False`` route alike.

    Returns (blocks u8[N, block_size], totals, errs, err_codes, strict
    bool[N]); rows whose ``strict`` is False need a general decoder.  With
    ``flat`` the blocks are u8[sum(totals)], back to back in block order
    (the ``_flat`` walks), as the container returns them.
    """
    p = variable_pass1(payloads_np, plens_np, spec, block_size, device,
                       rows="stride2" if stride2 else "stride1", stage=stage,
                       prep=prep)
    with (stage or spans.span)("dec_pass2"):
        if flat:
            walk = (decode_pass2_stride2_flat if stride2
                    else decode_pass2_device_flat)
            out = walk(p.dense, p.words, p.pair, p.counts_t, p.totals,
                       block_size, spec, p.sched)
        else:
            walk = decode_pass2_stride2 if stride2 else decode_pass2_device
            out = walk(p.dense, p.words, p.pair, p.counts_t, block_size,
                       spec, p.sched)
    return out, p.totals, p.err, p.err_code, p.strict


def decode_fixed_all_device(payloads: torch.Tensor, plens: torch.Tensor,
                            block_size: int, little: bool = True,
                            stage=None, stride2: bool = True,
                            flat: bool = False):
    """Whole fixed-12 decode on the payloads' device: pass 1 with pair
    rows, then pass 2 (the JAX package's ``decode_pass1_fixed_tpu`` +
    ``decode_pass2_stride2``, or with ``stride2=False`` its stride-1 rows
    + ``decode_pass2_device``); ``stage`` as for :func:`variable_pass1`
    (``dec_pass1``, ``dec_pass2``).

    Returns (blocks u8[N, block_size], totals, errs, err_codes); with
    ``flat`` the blocks are u8[sum(totals)], back to back in block order.
    """
    stage = stage or spans.span
    with stage("dec_pass1"):
        words, n_codes, totals, err, err_code, codes, pair = (
            decode_pass1_fixed(payloads, plens, block_size, little,
                               rows="stride2" if stride2 else "stride1"))
    with stage("dec_pass2"):
        if flat:
            walk = (decode_pass2_stride2_flat if stride2
                    else decode_pass2_device_flat)
            out = walk(codes, words, pair, n_codes, totals, block_size)
        else:
            walk = decode_pass2_stride2 if stride2 else decode_pass2_device
            out = walk(codes, words, pair, n_codes, block_size)
    return out, totals, err, err_code
