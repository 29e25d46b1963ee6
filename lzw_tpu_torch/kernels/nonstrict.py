"""Foreign (early-CLEAR) variable streams decoded on the device.

Port of ``lzw_tpu/kernels/nonstrict.py``.  The reference's decoder takes a
CLEAR at any position (`decoder.rs:222-227`); the strict-schedule decode
needs CLEARs exactly at table-full.  A foreign stream factors at its CLEARs
into dictionary epochs, each of which follows the static schedule on its
own (width bumps depend only on the code count since the last CLEAR, and an
epoch cannot outlive the table-full ordinal, past which the reference
demands a CLEAR, `decoder.rs:281-283`).  So :func:`parse_epochs` splits the
streams at their CLEARs on the host (numpy, vectorised per epoch
generation; the JAX package's function, which can also record each
stream's parse error and keep the codes before it), and every epoch
decodes on the device as a strict sub-stream through pass 1 and pass 2.

Left out against the JAX package: the padding of the sub-stream count to
kernel groups and of the output width to pass-2 buckets.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.decode import (
    KIND_HOLE, decode_pass1, decode_pass2_stride2_flat, to_host,
)
from lzw_tpu_torch.ops.bitpack import join_lanes, read_symbol
from lzw_tpu_torch.spec import (
    BlockOverflowError, LzwSpec, MAX_WIDTH, MissingClearCodeError,
    TruncatedStreamError, UnexpectedCodeError,
)
from lzw_tpu_torch.utils import spans

__all__ = ["parse_epochs", "split_substreams",
           "decode_variable_nonstrict_device"]


def _epoch_schedule_tables(spec: LzwSpec, S_e: int):
    """Widths/bit offsets for data ordinals 0..S_e of ONE epoch, measured
    from the epoch start (no leading CLEAR)."""
    sched = _sched.emission_schedule(spec, S_e + 2)
    widths = sched.widths[: S_e + 1].copy()
    offs = (sched.bit_off[: S_e + 2] - sched.bit_off[0]).copy()
    return widths, offs


@functools.lru_cache(maxsize=64)
def _slot_tables(spec: LzwSpec, L: int):
    """Per-slot extraction tables for epoch-local slots 0..L-1: bit offset,
    width, slot end (offset + width) — all static per spec, cached so the
    per-generation parse loop pays zero schedule work."""
    widths, offs = _epoch_schedule_tables(spec, max(L, 1))
    w = widths[:L].astype(np.int32)
    offs32 = offs[:L].astype(np.int32)
    return offs32, w, offs32 + w


def _unpack_at(w24, rows, bit_off_rows, spec: LzwSpec, L: int,
               little: bool):
    """Unpack epoch-local slots 0..L-1 for each row at absolute per-row
    bit offsets, from the precombined 24-bit window matrix ``w24``
    (``w24[i, b]`` = the window of the 3 bytes at b).

    One vectorized gather per (row, slot) — widths are <= 12, so 3 bytes
    cover any alignment — with no intermediate realigned copy, so the
    generation loop is not bound by per-call overhead.  Returns vals
    i32[m, L].
    """
    offs, w, _end = _slot_tables(spec, L)
    boff = bit_off_rows.astype(np.int64)[:, None] + offs[None, :]
    b0 = boff >> 3
    np.minimum(b0, w24.shape[1] - 1, out=b0)  # clamp: junk past bit_lim is
    # masked by the slot-end checks downstream
    sh = (boff & 7).astype(np.int32)
    return read_symbol(w24[rows[:, None], b0], sh, w[None], little)


def parse_epochs(payloads, plens, spec: LzwSpec, failed=None):
    """Split foreign variable streams into strict per-epoch sub-streams.

    Returns (dense i32[U, S_e_pad], counts i64[U], owner i64[U]) where U
    sub-streams appear grouped by owner stream in epoch order, plus S_e_pad.
    Raises :class:`TruncatedStreamError` if any stream ends without EOI,
    and :class:`MissingClearCodeError` for a data code where a table-full
    epoch's CLEAR must sit.  With ``failed`` (a list, empty) it raises
    neither: each stream's parse error, or None, is appended to it in
    stream order, and a failing stream ends with the epoch that fails,
    cut to its codes that end within the stream (a reference decoder
    meets them before the error).
    """
    if not spec.variable:
        raise ValueError("parse_epochs takes a variable-width spec")
    payloads = np.asarray(payloads)
    plens = np.asarray(plens, np.int64)
    N, PB = payloads.shape
    mat = np.zeros((N, PB + 8), np.int32)
    mat[:, :PB] = payloads
    little = spec.endianness.value == "little"
    # Pre-combined 3-byte windows: one gather per (row, slot) downstream.
    w24 = join_lanes((mat[:, :-2], mat[:, 1:-1], mat[:, 2:]), little)
    # Table-full bound on one epoch's data codes, from the schedule (the
    # early-change strategies bump one code sooner — see epoch_steps).
    S_e = _sched.epoch_steps(spec)
    widths, offs = _epoch_schedule_tables(spec, S_e)
    bit_lim = plens * 8

    # Leading CLEAR is optional in the reference decoder; consume it (and
    # any immediate repeats) wherever present.
    bit_off = np.zeros(N, np.int64)
    active = plens > 0
    clear, eoi = spec.clear_code, spec.end_code
    w0 = spec.initial_width

    owners: list[np.ndarray] = []
    denses: list[np.ndarray] = []
    counts: list[np.ndarray] = []
    done = ~active
    Lq = min(1024, S_e)
    end_q = _slot_tables(spec, Lq)[2]
    end_f = _slot_tables(spec, S_e)[2]

    fail = [None] * N

    def subset(g_rows, V, L, allow_full, is_term=None):
        """One epoch for streams ``g_rows`` with unpacked slot values
        ``V`` covering [0, L].  Slot S_e sits PAST the schedule's
        mandatory table-full CLEAR (offs jumps the 12-bit gap), so a
        full epoch advances by offs[S_e] — after verifying the skipped
        12 bits actually hold CLEAR (or EOI, the fix_eoi table-full
        ending); anything else is the reference's missing-CLEAR error
        (`decoder.rs:281-283`)."""
        m = len(g_rows)
        sl = V[:, :L]
        short = np.zeros(m, bool)
        if is_term is None:
            # A slot's own end is offs + width: offs[j + 1] would include
            # the mandatory-CLEAR gap at the table-full slot, wrongly
            # rejecting a terminator that ends the stream exactly there.
            slot_end = (bit_off[g_rows, None]
                        + (end_q if L == Lq else end_f)[None, :L])
            is_term = (((sl == clear) | (sl == eoi))
                       & (slot_end <= bit_lim[g_rows, None]))
        has_term = is_term.any(axis=1)
        fin_gap = np.zeros(m, bool)
        if allow_full:
            fullm = (~has_term) & (
                bit_off[g_rows] + offs[S_e] <= bit_lim[g_rows]
            )
            short = ~(has_term | fullm)
            if short.any() and failed is None:
                raise TruncatedStreamError()
            gi = np.nonzero(fullm)[0]
            if len(gi):
                gr = g_rows[gi]
                gb = bit_off[gr] + offs[S_e] - MAX_WIDTH
                gv = read_symbol(w24[gr, gb >> 3], gb & 7, MAX_WIDTH, little)
                wrong = (gv != clear) & (gv != eoi)
                if wrong.any() and failed is None:
                    raise MissingClearCodeError()
                for g in gr[wrong]:
                    fail[g] = MissingClearCodeError()
                fin_gap[gi] = (gv == eoi) | wrong
        k = np.where(
            has_term, is_term.argmax(axis=1), S_e
        ).astype(np.int64)
        if short.any():
            # The codes that end within the stream, then the truncation.
            k[short] = (slot_end[short] <= bit_lim[g_rows[short], None]).sum(
                axis=1)
            for g in g_rows[short]:
                fail[g] = TruncatedStreamError()
        term_val = np.where(
            has_term, sl[np.arange(m), np.minimum(k, L - 1)], clear
        )
        # Record this epoch (k may be 0 for CLEAR CLEAR runs).
        owners.append(g_rows.astype(np.int64))
        counts.append(k)
        sel = np.arange(L)[None, :] < k[:, None]
        denses.append(np.where(sel, sl, 0))
        adv = np.where(has_term, offs[k] + widths[k], offs[S_e])
        bit_off[g_rows] = bit_off[g_rows] + adv
        fin = (has_term & (term_val == eoi)) | fin_gap | short
        done[g_rows[fin]] = True

    guard = 0
    while not done.all():
        guard += 1
        if guard > (8 * PB) // w0 + 2:
            raise TruncatedStreamError()
        rows = np.nonzero(~done)[0]
        # Two-phase unpack: most foreign epochs terminate within ~1k
        # codes, so a quick prefix pass resolves them at prefix width and
        # only the stragglers pay the full table-bound unpack.
        vq = _unpack_at(w24, rows, bit_off[rows], spec, Lq, little)
        endq = bit_off[rows, None] + end_q[None, :]
        is_term_q = (((vq == clear) | (vq == eoi))
                     & (endq <= bit_lim[rows, None]))
        termq = is_term_q.any(axis=1)
        qi = np.nonzero(termq)[0]
        fi = np.nonzero(~termq)[0]
        if len(qi):
            subset(rows[qi], vq[qi], Lq, False, is_term_q[qi])
        if len(fi):
            # Stragglers (longer than the quick window) pay the full
            # table-bound unpack; typically a small minority.
            rf = rows[fi]
            vf = _unpack_at(w24, rf, bit_off[rf], spec, S_e, little)
            subset(rf, vf, S_e, True)

    if failed is not None:
        failed.extend(fail)
    if not owners:
        U = 0
        S_pad = 512
        return (np.zeros((0, S_pad), np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int64), S_pad)
    owner = np.concatenate(owners)
    cnt = np.concatenate(counts)
    W = max(d.shape[1] for d in denses)
    U_all = sum(d.shape[0] for d in denses)
    dense = np.zeros((U_all, W), np.int32)
    u = 0
    for d in denses:
        dense[u : u + d.shape[0], : d.shape[1]] = d
        u += d.shape[0]
    # Order sub-streams by (owner, generation): generations were appended
    # in order, and concatenation preserves per-owner order under a stable
    # sort on owner.
    order = np.argsort(owner, kind="stable")
    owner, cnt, dense = owner[order], cnt[order], dense[order]
    # Drop empty epochs (k == 0) — they decode to nothing.
    keep = cnt > 0
    owner, cnt, dense = owner[keep], cnt[keep], dense[keep]
    S_pad = max(512, ((int(cnt.max(initial=1)) + 511) // 512) * 512)
    return dense[:, :S_pad].copy() if dense.shape[1] >= S_pad else np.pad(
        dense, ((0, 0), (0, S_pad - dense.shape[1]))
    ), cnt, owner, S_pad


def split_substreams(payloads, plens, spec: LzwSpec, failed=None):
    """:func:`parse_epochs` plus the sub-streams' schedule rows: each
    sub-stream is one epoch, so its rows are those of a stream's first
    epoch, and its code slots stop at the longest count.  ``failed`` as in
    :func:`parse_epochs`.

    Returns (dense i32[U, S], counts i64[U], owner i64[U], sched_arr
    i32[2, S]); U may be 0.
    """
    dense, cnt, owner, _ = parse_epochs(payloads, plens, spec, failed)
    S = int(cnt.max(initial=1))
    return (np.ascontiguousarray(dense[:, :S]), cnt, owner,
            _sched.schedule_rows(spec, S))


def _stream_error(rows, dense, cnt, words, errs, err_codes, totals,
                  block_size: int, parse_error):
    """The first error of one stream in stream order, from its
    sub-streams' pass-1 outputs: ``rows`` are its sub-streams in epoch
    order, ``words`` their pass-1 words (numpy).  A word that ends past
    ``block_size`` counted over the whole stream fails on its code, as the
    container pass 1 flags a strict block; then a sub-stream's own pass-1
    error; then ``parse_error``, the stream's parse error (or None)."""
    room = block_size
    for r, w in zip(rows, words):
        n = int(cnt[r])
        kind, length = w[:n] >> 29, (w[:n] >> 17) & 0xFFF
        # Pass 1 stops at its error: the words before it are whole.
        stop = int(np.argmax(kind == KIND_HOLE)) if errs[r] else n
        over = np.cumsum(length[:stop]) > room
        if over.any():
            return UnexpectedCodeError(int(dense[r, np.argmax(over)]))
        if errs[r]:
            return UnexpectedCodeError(int(err_codes[r]))
        room -= int(totals[r])
    return parse_error


def decode_variable_nonstrict_device(payloads, plens, spec: LzwSpec,
                                     block_size: int, device="cuda",
                                     stage=None) -> list[bytes]:
    """Decode foreign early-CLEAR streams on ``device`` by resegmentation.

    ``payloads`` u8[N, PB] and ``plens`` are numpy.  Returns the N decoded
    streams as ``bytes``.  Raises the first failing stream's first error
    in stream order, as a reference decoder meets it with its output
    bounded at ``block_size``: :class:`UnexpectedCodeError` with the
    offending code from pass 1, or with the code whose word passes
    ``block_size`` (alone, as pass 1 flags it, or counted over the
    stream's epochs together), then :class:`TruncatedStreamError` or
    :class:`MissingClearCodeError` from the parse.
    ``stage(name)``, when given, is a context manager timing each stage
    (``dec_parse_epochs``, ``dec_h2d``, ``dec_pass1``, ``dec_pass2``,
    ``dec_d2h_out``).
    """
    stage = stage or spans.span
    N = payloads.shape[0]
    failed = []
    with stage("dec_parse_epochs"):
        dense, cnt, owner, sched_arr = split_substreams(payloads, plens, spec,
                                                        failed)
    parse_failed = np.array([e is not None for e in failed], bool)
    if dense.shape[0] == 0:
        if parse_failed.any():
            raise failed[int(np.argmax(parse_failed))]
        return [b""] * N
    with stage("dec_h2d"):
        dense_t = torch.from_numpy(dense).to(device)
        cnt_t = torch.from_numpy(cnt.astype(np.int32)).to(device)
        sched_t = torch.from_numpy(sched_arr).to(device)
    with stage("dec_pass1"):
        words, totals, errs, err_codes, pair = decode_pass1(
            dense_t, cnt_t, spec, block_size, sched_t, rows="stride2"
        )
    with spans.span("dec_errors"):
        errs = errs.cpu().numpy()
        te = totals.cpu().numpy().astype(np.int64)
        # A stream fails where pass 1 refused one of its sub-streams, where
        # they pass block_size together, or where its parse failed.
        refused = np.bincount(owner, weights=errs != 0, minlength=N) > 0
        long = np.bincount(owner, weights=np.where(errs == 0, te, 0),
                           minlength=N) > block_size
        failing = refused | long | parse_failed
        if failing.any():
            b = int(np.argmax(failing))
            rows = np.nonzero(owner == b)[0]
            w = words[torch.from_numpy(rows).to(words.device)].cpu().numpy()
            # None only where the words disagree with the totals.
            raise _stream_error(rows, dense, cnt, w, errs,
                                err_codes.cpu().numpy(), te, block_size,
                                failed[b]) or BlockOverflowError(block_size)
    with stage("dec_pass2"):
        # The sub-streams' bytes back to back, in (owner, epoch) order.
        flat = decode_pass2_stride2_flat(dense_t, words, pair, cnt_t, totals,
                                         block_size, spec, sched_t)
    with stage("dec_d2h_out"):
        flat = to_host(flat)
    with spans.span("dec_join"):
        ends = np.cumsum(np.bincount(owner, weights=te, minlength=N)).astype(
            np.int64)
        starts = np.concatenate([[0], ends[:-1]])
        return [flat[a:b].tobytes() for a, b in zip(starts, ends)]
