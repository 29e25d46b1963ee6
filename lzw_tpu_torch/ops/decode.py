"""Single-stream LZW decode: a sequential table scan, then the words.

Port of ``lzw_tpu/ops/decode.py``, the JAX package's XLA decoder of one
stream of any length, batched here over rows.  The reference interleaves
three jobs in one byte-at-a-time loop: reading variable-width codes,
growing the prefix/suffix/length tables, and walking suffix chains
backwards through a stack to materialise each word (`decoder.rs:174-290`
variable, `:553-642` fixed).  Only the first two are sequential, and they
are O(1) per code.

Pass 1 (:func:`decode_pass1`, kernel ``csrc/stream_pass1.cu``) scans the
codes: it reads each code at the bit cursor, keeps the dictionary as
**append-only global tables** (every insert gets a fresh global id, and a
local->global ``code_map`` translates wire codes of the current epoch; a
CLEAR only rewinds the local index, so the tables are immutable once
written), and records per word its global id, length, output offset,
whether it is a first-code literal and the wire code read.  Within an
epoch (CLEAR to CLEAR) the width of the k-th code depends on k alone
(:func:`epoch_widths`), so the kernel reads and decodes a whole epoch at
once, one CTA a row.

Pass 2 (:func:`decode_pass2`, kernel ``csrc/stream_pass2.cu``) walks every
word's suffix chain from its global id and writes byte
``offset + length - 1 - r`` at step ``r``; the words are independent, and
a CTA walks a chunk of them in a window of the tables staged in shared
memory.

Errors are the reference's: a code beyond the next index, a full table
without a CLEAR, a truncated stream, and the corrupt chain of pass 2 (the
reference's stack underflow, `decoder.rs:257-260`).  For corrupt streams
that do not raise, the reference emits stale-table garbage after a reset
(`decoder.rs:230-236`); the tables here keep the stale entries too.

Both wrappers take rows: u8[N, M] payloads and i32[N] valid lengths, the
container's batch of big blocks or one facade stream (N = 1), as the JAX
package vmaps its function.  CUDA tensors launch the kernels, CPU tensors
run the plain versions beside them (:func:`decode_pass1_reference`, a
Python loop over codes transcribing the JAX ``while_loop`` body, and
:func:`decode_pass2_reference`, its lockstep rounds in torch); any other
device raises.

Against the JAX package: the decoded length ``total_len`` is summed in
i64 (the JAX package's i32 wraps past 2**31 - 1 bytes); the word offsets
``out_off`` stay i32 and wrap as there, so :func:`check_offsets` raises
before pass 2 reads offsets of a row that long.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.ops.bitpack import join_lanes, read_symbol
from lzw_tpu_torch.spec import (
    MAX_TABLE_SIZE, MAX_WIDTH, LzwSpec, MissingClearCodeError,
    TruncatedStreamError, UnexpectedCodeError,
)

__all__ = [
    "ERR_NONE", "ERR_UNEXPECTED_CODE", "ERR_MISSING_CLEAR", "ERR_TRUNCATED",
    "NO_ERROR_STEP", "PASS2_CHUNK", "PASS2_KEYS", "STREAM_LAYOUTS",
    "StreamLayout", "check_offsets", "decode_block", "decode_pass1",
    "decode_pass1_reference", "decode_pass2", "decode_pass2_reference",
    "epoch_widths", "pass1_step_bound", "pass2_grid", "raise_decode_error",
]

ERR_NONE = 0
ERR_UNEXPECTED_CODE = 1
ERR_MISSING_CLEAR = 2
ERR_TRUNCATED = 3

# err_word_step of a row without a corrupt chain (i32 max, as in JAX).
NO_ERROR_STEP = 2**31 - 1
# The largest decoded length whose word offsets fit i32.
MAX_OFFSET = 2**31 - 1

_TABLE_KEYS = ("gprefix", "gsuffix", "glocal")
_WORD_KEYS = ("out_g", "out_len", "out_off")
_ROW_KEYS = ("n_words", "error", "error_code", "max_len")
# Pass 1's outputs that pass 2 takes, in its argument order.
PASS2_KEYS = (*_TABLE_KEYS, *_WORD_KEYS, "out_lit")


class StreamLayout(NamedTuple):
    """A stream kernel's CTA: ``threads`` threads and ``shared_bytes`` of
    dynamic shared memory (the sources' kThreads and kSharedBytes; each
    launch function refuses any other)."""

    threads: int
    shared_bytes: int


STREAM_LAYOUTS = {
    # One CTA a row.  By local code: global id and length (i32), first
    # byte (u8); by step of an epoch (4096 at most): bit offset (i32, one
    # more), link (u32) and code (u16, also the source of out_code).
    "stream_pass1": StreamLayout(
        1024, MAX_TABLE_SIZE * (4 + 4 + 1) + 4 * (4096 + 1) + 4096 * (4 + 2)),
    # One CTA a chunk of PASS2_CHUNK word slots.  The 256 roots and an
    # 8192-entry window of the tables, each entry one u32 (its prefix's
    # index in the table << 8 | its suffix byte); the chunk's word slots
    # sorted by length (u16); 8192 of its output bytes.
    "stream_pass2": StreamLayout(512, 4 * (256 + 8192) + 2 * 2048 + 8192),
}
# Word slots one pass-2 CTA takes: about one epoch's words.
PASS2_CHUNK = 2048


@functools.lru_cache(maxsize=None)
def epoch_widths(spec: LzwSpec) -> tuple[np.ndarray, np.ndarray]:
    """The static pattern of one epoch: (widths, bits).

    ``widths[k]`` is the width pass 1 reads step k of an epoch at, and
    ``bits[k]`` its bit offset from the epoch's start (``bits`` has one
    more entry, the end of the last step).  An epoch starts at the stream's
    start or after a CLEAR.  Variable flavors have ``4098 - first_free``
    steps at most (the last of them a CLEAR, an EOI or the missing-CLEAR
    error): the encoder's epoch, the widths of the first
    :func:`~lzw_tpu_torch.kernels.schedule.epoch_steps` data codes of its
    :class:`~lzw_tpu_torch.kernels.schedule.Schedule`, then 12 bits to the
    step that must end it.  Fixed-12 has the ``4097 - first_free`` steps up
    to the frozen table, 12 bits each.  Read-only int32 arrays.
    """
    steps = MAX_TABLE_SIZE + (2 if spec.variable else 1) - spec.first_free_code
    widths = np.full(steps, MAX_WIDTH, np.int32)
    if spec.variable:
        period = _sched.epoch_steps(spec)
        widths[:period] = _sched.emission_schedule(spec, period).widths
    bits = np.zeros(len(widths) + 1, np.int32)
    bits[1:] = np.cumsum(widths)
    widths.flags.writeable = False
    bits.flags.writeable = False
    return widths, bits


@functools.lru_cache(maxsize=32)
def _epoch_bits_on(spec: LzwSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(epoch_widths(spec)[1].copy()).to(device)


def pass2_grid(n_rows: int, S: int) -> int:
    """CTAs of a pass-2 launch on ``n_rows`` rows of ``S`` word slots: one
    a chunk of PASS2_CHUNK slots of a row."""
    return n_rows * -(-S // PASS2_CHUNK)


def pass1_step_bound(n_bytes: int, spec: LzwSpec) -> int:
    """Static bound on the number of codes in an ``n_bytes`` stream."""
    min_width = spec.initial_width if spec.variable else MAX_WIDTH
    return (8 * n_bytes) // min_width + 1


def _shapes(M: int, spec: LzwSpec) -> tuple[int, int]:
    """(S, G): word slots and global table entries of an M-byte row."""
    S = pass1_step_bound(M, spec)
    return S, spec.alphabet_size + S + 2  # roots + inserts + UNINIT


def decode_pass1(data: torch.Tensor, n_valid: torch.Tensor, spec: LzwSpec):
    """Sequential scan: codes -> (global id, length, offset) words, per row.

    Args:
      data:    u8[N, M] compressed bytes, anything past ``n_valid``.
      n_valid: i32[N] valid bytes per row.
      spec:    the wire format.

    Returns a dict of the JAX function's outputs with a leading row axis:
    the append-only tables ``gprefix``, ``gsuffix``, ``glocal`` i32[N, G]
    (G = alphabet + S + 2; the wire code each entry was inserted under is
    ``glocal``), the words ``out_g``, ``out_len``, ``out_off`` i32[N, S]
    and ``out_lit`` bool[N, S] (S = ``pass1_step_bound(M)``), and per row
    ``n_words``, ``error``, ``error_code``, ``max_len`` i32[N] and
    ``total_len`` i64[N].  Entries past a row's inserts and words are 0.
    Beside the JAX function's outputs, ``out_code`` i16[N, S]: each word's
    wire code (0 where a slot holds no word).  ``glocal[out_g]`` is the
    same code but for a first code after a CLEAR that reads an entry never
    inserted (the UNINIT entry, G - 1, whose ``glocal`` is 0).
    """
    build.require_tensor(data, "data", torch.uint8, 2, data.device)
    build.require_tensor(n_valid, "n_valid", torch.int32, 1, data.device)
    if n_valid.shape[0] != data.shape[0]:
        raise ValueError(f"n_valid has {n_valid.shape[0]} rows, data "
                         f"{data.shape[0]}")
    spec.validate()
    if data.device.type == "cpu":
        return decode_pass1_reference(data, n_valid, spec)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    N, M = data.shape
    S, G = _shapes(M, spec)
    dev = data.device
    with build.on_device(dev):
        tables = torch.zeros((3, N, G), dtype=torch.int32, device=dev)
        words = torch.zeros((3, N, S), dtype=torch.int32, device=dev)
        lit = torch.zeros((N, S), dtype=torch.bool, device=dev)
        code = torch.zeros((N, S), dtype=torch.int16, device=dev)
        rows = torch.empty((4, N), dtype=torch.int32, device=dev)
        total = torch.empty(N, dtype=torch.int64, device=dev)
        _launch_pass1(data, n_valid, spec, tables, words, lit, code, rows,
                      total)
    return _pass1_dict(tables, words, lit, code, rows, total)


def _launch_pass1(data, n_valid, spec: LzwSpec, tables, words, lit, code,
                  rows, total) -> None:
    """Launch ``stream_pass1.cu`` into the outputs of :func:`decode_pass1`
    (zeroed by the caller; ``tables``, ``words`` and ``rows`` are sequences
    of its planes) and count it; raises when it does not launch."""
    N, M = data.shape
    G, S = tables[0].shape[1], words[0].shape[1]
    fn = build.bound("stream_pass1", "stream_pass1_launch")
    bits = _epoch_bits_on(spec, data.device)
    rc = fn(data.data_ptr(), n_valid.data_ptr(), bits.data_ptr(),
            bits.shape[0] - 1, N, M, S, G, spec.alphabet_size,
            int(spec.variable), int(spec.endianness.value == "little"),
            spec.clear_code, spec.end_code, spec.first_free_code,
            *STREAM_LAYOUTS["stream_pass1"], *(t.data_ptr() for t in tables),
            *(t.data_ptr() for t in words), lit.data_ptr(), code.data_ptr(),
            *(t.data_ptr() for t in rows), total.data_ptr(),
            build.stream(data.device))
    build.check_launch("stream_pass1", rc)


def _pass1_dict(tables, words, lit, code, rows, total) -> dict:
    out = dict(zip(_TABLE_KEYS, tables))
    out.update(zip(_WORD_KEYS, words))
    out["out_lit"] = lit
    out["out_code"] = code
    out.update(zip(_ROW_KEYS, rows))
    out["total_len"] = total
    return out


def _wrap_i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _pass1_row(row: bytes, n_valid: int, spec: LzwSpec, S: int, G: int):
    """Plain pass 1 of one row: the JAX ``while_loop`` body
    (lzw_tpu/ops/decode.py:136-252) as a Python loop over codes, on Python
    lists.  Returns (tables, words, lit, the words' wire codes, (n_words,
    error, error_code, max_len), total_len, the bit cursor after the last
    step)."""
    alphabet = spec.alphabet_size
    variable = spec.variable
    little = spec.endianness.value == "little"
    uninit = G - 1
    padded = list(row) + [0, 0, 0]
    total_bits = 8 * n_valid

    roots = list(range(alphabet))
    pad = [0] * (G - alphabet)
    gprefix = roots + pad
    gsuffix = roots + pad
    gfirst = roots + pad
    glength = [1] * alphabet + pad
    glocal = roots + pad
    # Stale across resets by design (`decoder.rs:222-227`).
    code_map = roots + [uninit] * (MAX_TABLE_SIZE - alphabet)
    out_g = [0] * S
    out_len = [0] * S
    out_off = [0] * S
    out_lit = [False] * S
    out_code = [0] * S

    cursor = 0
    read_size = spec.initial_width
    next_local = spec.first_free_code
    gcount = alphabet
    prev_exists = False
    prev_g = 0
    step = 0
    off = 0
    done = False
    err = ERR_NONE
    err_code = 0
    while not done and step < S:
        can_read = cursor + read_size <= total_bits
        byte = cursor >> 3
        code = read_symbol(join_lanes(padded[byte : byte + 3], little),
                           cursor & 7, read_size, little)
        cursor += read_size

        if variable:
            truncated = not can_read
            is_clear = can_read and code == spec.clear_code
            is_end = can_read and code == spec.end_code
            process = can_read and not is_clear and not is_end
        else:
            truncated = is_clear = False
            is_end = not can_read  # clean termination on bit exhaustion
            process = can_read

        first = process and not prev_exists
        normal = process and prev_exists
        g_mapped = code_map[min(code, MAX_TABLE_SIZE - 1)]
        bad = normal and code > next_local
        kwkwk = normal and code == next_local
        normal_ok = normal and not bad
        table_full = next_local >= MAX_TABLE_SIZE
        missing_clear = False
        if variable:
            missing_clear = normal_ok and table_full
            normal_ok = normal_ok and not missing_clear
            ins = normal_ok
        else:
            ins = normal_ok and not table_full

        prev_len = glength[prev_g]
        prev_first = gfirst[prev_g]
        g_new = gcount
        g_cur = g_new if kwkwk else g_mapped
        cur_first = prev_first if kwkwk else gfirst[g_mapped]
        cur_len = prev_len + 1 if kwkwk else glength[g_mapped]

        if ins:  # append-only insert
            gprefix[g_new] = prev_g
            gsuffix[g_new] = cur_first
            gfirst[g_new] = prev_first
            glength[g_new] = prev_len + 1
            glocal[g_new] = next_local
            code_map[next_local] = g_new
            gcount += 1
            next_local += 1

        emit = first or normal_ok
        word_g = g_mapped if first else g_cur
        word_len = 1 if first else cur_len
        if emit:
            out_g[step] = word_g
            out_len[step] = word_len
            out_code[step] = code
        out_off[step] = _wrap_i32(off)
        out_lit[step] = first
        if emit:
            off += word_len
        step += 1

        if variable:
            if ins and next_local == (1 << read_size) - spec.strategy.increment \
                    and read_size < MAX_WIDTH:
                read_size += 1
            if is_clear:
                read_size = spec.initial_width
                next_local = spec.first_free_code

        if truncated:
            err_kind = ERR_TRUNCATED
        elif bad:
            err_kind = ERR_UNEXPECTED_CODE
        elif missing_clear:
            err_kind = ERR_MISSING_CLEAR
        else:
            err_kind = ERR_NONE
        done = is_end or err_kind != ERR_NONE
        if is_clear:
            prev_exists = False
        elif emit:
            prev_exists = True
        if emit:
            prev_g = word_g
        if err == ERR_NONE:
            err = err_kind
        if bad:
            err_code = code
    return ((gprefix, gsuffix, glocal), (out_g, out_len, out_off), out_lit,
            out_code, (step, err, err_code, max(out_len)), off, cursor)


def decode_pass1_reference(data: torch.Tensor, n_valid: torch.Tensor,
                           spec: LzwSpec):
    """Plain version of :func:`decode_pass1`: one Python loop per row."""
    N, M = data.shape
    S, G = _shapes(M, spec)
    tables = np.zeros((3, N, G), np.int32)
    words = np.zeros((3, N, S), np.int32)
    lit = np.zeros((N, S), bool)
    code = np.zeros((N, S), np.int16)
    rows = np.zeros((4, N), np.int32)
    total = np.zeros(N, np.int64)
    data_np = data.cpu().numpy()
    n_np = n_valid.cpu().numpy()
    for i in range(N):
        t, w, lt, c, r, tot, _ = _pass1_row(data_np[i].tobytes(),
                                            int(n_np[i]), spec, S, G)
        tables[:, i] = t
        words[:, i] = w
        lit[i] = lt
        code[i] = c
        rows[:, i] = r
        total[i] = tot
    dev = data.device
    return _pass1_dict(*(torch.from_numpy(a).to(dev)
                         for a in (tables, words, lit, code, rows, total)))


def check_offsets(total_len: torch.Tensor) -> None:
    """Raise ValueError when a row decodes past the i32 word offsets."""
    longest = int(total_len.max()) if total_len.numel() else 0
    if longest > MAX_OFFSET:
        raise ValueError(
            f"a stream decodes to {longest} bytes, past the {MAX_OFFSET} "
            "that pass 1's i32 word offsets hold")


def _check_pass2(tables, words, out_lit, out_bound: int):
    dev = tables[0].device
    N = tables[0].shape[0]
    for name, t in zip(_TABLE_KEYS, tables):
        build.require_tensor(t, name, torch.int32, 2, dev)
        if t.shape != tables[0].shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    for name, t in zip(_WORD_KEYS, words):
        build.require_tensor(t, name, torch.int32, 2, dev)
        if t.shape != words[0].shape or t.shape[0] != N:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    build.require_tensor(out_lit, "out_lit", torch.bool, 2, dev)
    if out_lit.shape != words[0].shape:
        raise ValueError(f"out_lit has shape {tuple(out_lit.shape)}")
    if out_bound < 1:
        raise ValueError(f"out_bound must be positive, not {out_bound}")


def decode_pass2(gprefix, gsuffix, glocal, out_g, out_len, out_off, out_lit,
                 out_bound: int, alphabet: int):
    """Materialise the words: every word walks its suffix chain.

    Takes :func:`decode_pass1`'s tables and words (rows of equal shape).
    Returns (u8[N, out_bound] output, i32[N] err_word_step, i32[N]
    err_code).  Bytes past a row's decoded length are zero; writes at or
    past ``out_bound`` are dropped (the caller checks ``total_len``).

    A word that is not a first-code literal and whose last-walked entry is
    not a root has a suffix chain longer than its recorded length: the
    corrupt chain the reference detects by stack underflow
    (`decoder.rs:257-260`).  ``err_word_step`` is the earliest such word
    (or ``NO_ERROR_STEP``) and ``err_code`` the wire code of the entry at
    the underflow, the value the reference reports.
    """
    tables = (gprefix, gsuffix, glocal)
    words = (out_g, out_len, out_off)
    _check_pass2(tables, words, out_lit, out_bound)
    dev = gprefix.device
    if dev.type == "cpu":
        return decode_pass2_reference(*tables, *words, out_lit, out_bound,
                                      alphabet)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N = gprefix.shape[0]
    with build.on_device(dev):
        out = torch.zeros((N, out_bound), dtype=torch.uint8, device=dev)
        # (word << 32 | code) of the earliest corrupt chain, all ones if none.
        first_bad = torch.full((N,), -1, dtype=torch.int64, device=dev)
        _launch_pass2(tables, words, out_lit, alphabet, out, first_bad)
    none = first_bad < 0
    err_word_step = torch.where(none, NO_ERROR_STEP, first_bad >> 32)
    err_code = torch.where(none, 0, first_bad & 0xFFFFFFFF)
    return out, err_word_step.to(torch.int32), err_code.to(torch.int32)


def _launch_pass2(tables, words, out_lit, alphabet: int, out,
                  first_bad) -> None:
    """Launch ``stream_pass2.cu`` into ``out`` u8[N, out_bound] (zeroed by
    the caller) and ``first_bad`` i64[N] (all ones) and count it; raises
    when it does not launch."""
    (N, G), S = tables[0].shape, words[0].shape[1]
    threads, shared = STREAM_LAYOUTS["stream_pass2"]
    fn = build.bound("stream_pass2", "stream_pass2_launch")
    rc = fn(*(t.data_ptr() for t in tables), *(t.data_ptr() for t in words),
            out_lit.data_ptr(), N, G, S, out.shape[1], alphabet, threads,
            pass2_grid(N, S), shared, out.data_ptr(), first_bad.data_ptr(),
            build.stream(out.device))
    build.check_launch("stream_pass2", rc)


def decode_pass2_reference(gprefix, gsuffix, glocal, out_g, out_len,
                           out_off, out_lit, out_bound: int, alphabet: int):
    """Plain version of :func:`decode_pass2`: the JAX function's lockstep
    rounds (lzw_tpu/ops/decode.py:304-327) in torch, one round per byte
    of the longest word, every word of every row at once."""
    N, S = out_g.shape
    dev = out_g.device
    big = NO_ERROR_STEP
    gprefix, gsuffix, glocal = (t.to(torch.int64)
                                for t in (gprefix, gsuffix, glocal))
    # The last column takes the writes that are dropped.
    out = torch.zeros((N, out_bound + 1), dtype=torch.int64, device=dev)
    cur = out_g.to(torch.int64)
    rem = out_len.to(torch.int64)
    pos = out_off.to(torch.int64) + rem - 1
    bad = torch.full((N, S), big, dtype=torch.int64, device=dev)
    while bool((rem > 0).any()):
        active = rem > 0
        idx = torch.where(active & (pos >= 0) & (pos < out_bound), pos,
                          out_bound)
        out.scatter_(1, idx, gsuffix.gather(1, cur))
        underflow = active & (rem == 1) & (cur >= alphabet) & ~out_lit
        bad = torch.where(underflow, glocal.gather(1, cur), bad)
        cur = torch.where(active, gprefix.gather(1, cur), cur)
        pos = pos - 1
        rem = torch.clamp(rem - 1, min=0)
    steps = torch.arange(S, device=dev)
    err_word_step = torch.where(bad != big, steps, big).min(dim=1).values
    at = torch.clamp(err_word_step, 0, S - 1)[:, None]
    err_code = torch.where(err_word_step != big,
                           bad.gather(1, at)[:, 0], 0)
    return (out[:, :out_bound].to(torch.uint8), err_word_step.to(torch.int32),
            err_code.to(torch.int32))


def decode_block(data: torch.Tensor, n_valid: torch.Tensor, spec: LzwSpec,
                 out_bound: int | None = None,
                 overflow_error: bool = False) -> dict:
    """Both passes, and each row's first error.

    ``out_bound`` is the output bytes kept per row: the container passes
    its block size; without one it is the longest decoded row, or 1 byte
    for a row with a pass-1 error, whose output is discarded (pass 2 still
    scans its words for an earlier corrupt chain, which needs no output),
    and :func:`check_offsets` holds the rows without one.

    Returns ``out`` u8[N, out_bound], ``total_len`` i64[N], ``error`` and
    ``error_code`` i32[N].  Error precedence follows stream order: a
    pass-2 corrupt chain on an earlier word wins over a pass-1 error on a
    later code (`decoder.rs:257-260`).  With ``overflow_error`` (and an
    ``out_bound``) a word that ends past ``out_bound`` is an error too, of
    kind ``ERR_UNEXPECTED_CODE`` on the code that passes it, in the same
    order: the container's decode pass 1 flags a block so.  Without it the
    row is cut at ``out_bound``, as the JAX function cuts it.
    """
    p1 = decode_pass1(data, n_valid, spec)
    failed = p1["error"] != ERR_NONE
    if out_bound is None:
        if overflow_error:
            raise ValueError("overflow_error needs an out_bound")
        kept = torch.where(failed, 0, p1["total_len"])
        check_offsets(kept)
        out_bound = max(int(kept.max()) if kept.numel() else 0, 1)
    out, err_word_step, err_code2 = decode_pass2(
        *(p1[k] for k in PASS2_KEYS), out_bound, spec.alphabet_size)
    # The pass-1 error (if any) occurred on the last processed step.
    p1_step = torch.where(failed, p1["n_words"] - 1, NO_ERROR_STEP)
    chain_first = err_word_step < p1_step
    error = torch.where(chain_first, ERR_UNEXPECTED_CODE, p1["error"])
    error_code = torch.where(chain_first, err_code2, p1["error_code"])
    if overflow_error and bool((p1["total_len"] > out_bound).any()):
        # The first word ending past the bound, named by the code read.
        ends = p1["out_off"].long() + p1["out_len"]
        over = (p1["out_len"] > 0) & (ends > out_bound)
        step = torch.where(over.any(1), over.int().argmax(1), NO_ERROR_STEP)
        word = step.clamp(max=over.shape[1] - 1).long()[:, None]
        code = p1["out_code"].gather(1, word).to(torch.int32)
        wins = step < torch.minimum(err_word_step, p1_step)
        error = torch.where(wins, ERR_UNEXPECTED_CODE, error)
        error_code = torch.where(wins, code[:, 0], error_code)
    return {
        "out": out,
        "total_len": p1["total_len"],
        "error": error,
        "error_code": error_code,
    }


def raise_decode_error(err: int, err_code: int) -> None:
    """Raise the typed error of a pass-1 error kind (nothing for none)."""
    if err == ERR_UNEXPECTED_CODE:
        raise UnexpectedCodeError(err_code)
    if err == ERR_MISSING_CLEAR:
        raise MissingClearCodeError()
    if err == ERR_TRUNCATED:
        raise TruncatedStreamError()
    if err != ERR_NONE:
        raise AssertionError(f"unknown decode error kind {err}")
