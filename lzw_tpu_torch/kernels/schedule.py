"""Static emission schedules for variable-width LZW, and the torch bit-pack.

Port of ``lzw_tpu/kernels/schedule.py``.  Width bumps and CLEAR resets of a
variable stream depend only on how many codes were emitted since the last
reset, never on the data, so the whole wire layout (per-ordinal width, CLEAR
positions, bit offsets) is a static schedule.  The encode kernel only has to
produce code values; packing and unpacking are static-offset arithmetic.

``Schedule``, ``emission_schedule`` and ``recover_counts`` stay numpy on the
host, as in the JAX package, and ``unpack_variable`` is its host unpack.
A spec's schedule and the tables derived from it are built once per
power-of-two capacity and sliced to the length a call needs, so a batch
with a new longest stream builds nothing.  ``pack_variable`` and
``unpack_variable_device`` were XLA glue there and are torch ops here, run on
the device of the tensors they are given: one scatter-add (pack) or gather
(unpack) per byte lane over per-ordinal offset tables, in place of the JAX
package's reshape-per-segment form, which existed because the TPU has no
cheap gather.  Every symbol is read and written in the bit order of
:mod:`lzw_tpu_torch.ops.bitpack`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lzw_tpu_torch.ops.bitpack import (
    join_lanes, read_symbol, scatter_symbols,
)
from lzw_tpu_torch.spec import LzwSpec, MAX_WIDTH
from lzw_tpu_torch.utils import spans

__all__ = [
    "Schedule", "emission_schedule", "epoch_steps", "pack_variable",
    "recover_counts",
    "schedule_rows", "unpack_variable", "unpack_variable_device",
]


class Schedule:
    """Static wire schedule for data-code ordinals 0..n_max-1.

    Attributes (numpy, length n_max + 1 where noted):
      widths[m]:       write width of data code m.
      clear_after[m]:  True if a CLEAR (12 bits) follows data code m (only
                       when another data code follows).
      bit_off[m]:      bit offset of data code m (after the initial CLEAR);
                       bit_off[n_max] is the offset one-past-last.
      nxt_of[m]:       dictionary index the encoder assigns at miss m.
      epoch_start[m]:  ordinal of the first code of m's dictionary epoch.
    """

    def __init__(self, spec: LzwSpec, n_max: int):
        self.spec = spec
        self.n_max = n_max
        inc = spec.strategy.increment
        first_free = spec.first_free_code
        # Every epoch restarts at the same width and index, so one epoch's
        # widths and indices, up to its CLEAR, repeat: walk it once, tile.
        pat_w, pat_nxt = [], []
        width = spec.initial_width
        nxt = first_free
        period = None
        for m in range(n_max):
            pat_w.append(width)
            pat_nxt.append(nxt)
            new_index = nxt
            nxt += 1
            if new_index == (1 << width) - inc:
                if width < MAX_WIDTH:
                    width += 1
                else:
                    period = m + 1
                    break
        m = np.arange(n_max, dtype=np.int64)
        j = m if period is None else m % period
        self.widths = np.asarray(pat_w, np.int64)[j]
        self.nxt_of = np.asarray(pat_nxt, np.int64)[j]
        self.clear_after = (np.zeros(n_max, bool) if period is None
                            else j == period - 1)
        self.epoch_start = m - j
        if period is not None:
            width = pat_w[n_max % period]
        widths, clear_after = self.widths, self.clear_after
        bit_off = np.zeros(n_max + 1, np.int64)
        bit_off[1:] = np.cumsum(widths + MAX_WIDTH * clear_after)
        bit_off += spec.initial_width  # the leading CLEAR
        self.bit_off = bit_off
        # width the *decoder* expects after consuming n data codes (its
        # insert trails the encoder's by one emission).
        self.next_width = np.empty(n_max + 1, np.int64)
        self.next_width[:n_max] = widths
        self.next_width[n_max] = width

    def eoi_width(self, n: int, fix: bool) -> int:
        """Width of the trailing EOI for a stream of n data codes."""
        if n == 0:
            return self.spec.initial_width
        if not fix:
            return int(self.widths[n - 1])
        if self.clear_after[n - 1]:
            # The decoder's table hit 4096 exactly; read size stays 12.
            return MAX_WIDTH
        return int(self.next_width[n]) if n < len(self.next_width) else int(
            self.widths[n - 1]
        )

    def total_bits(self, n: int, fix: bool = True) -> int:
        """Wire bits for n data codes incl. leading CLEAR and trailing EOI."""
        if n == 0:
            return 2 * self.spec.initial_width
        base = int(self.bit_off[n])
        if self.clear_after[n - 1]:
            base -= MAX_WIDTH  # no CLEAR after the final code (not a miss)
        return base + self.eoi_width(n, fix)

    def eoi_tables(self, fix: bool):
        """Vectorised :meth:`eoi_width` / :meth:`total_bits` for n = 0..n_max.

        Returns (eoi bit offset, eoi width, total bits), each i64[n_max + 1].
        """
        S = self.n_max
        w = np.empty(S + 1, np.int64)
        total = np.empty(S + 1, np.int64)
        w[0] = self.spec.initial_width
        total[0] = 2 * self.spec.initial_width
        if S:
            clear = self.clear_after[:S]
            if fix:
                w[1:] = np.where(clear, MAX_WIDTH, self.next_width[1 : S + 1])
            else:
                w[1:] = self.widths[:S]
            total[1:] = self.bit_off[1 : S + 1] - MAX_WIDTH * clear + w[1:]
        return total - w, w, total

    def prefix(self, n_max: int) -> "Schedule":
        """The schedule of ordinals 0..n_max-1 (n_max <= self.n_max): each
        array's prefix, equal to ``Schedule(spec, n_max)``'s."""
        if n_max == self.n_max:
            return self
        if not 0 <= n_max < self.n_max:
            raise ValueError(f"prefix {n_max} outside 0..{self.n_max}")
        out = object.__new__(Schedule)
        out.spec, out.n_max = self.spec, n_max
        for name in ("widths", "nxt_of", "clear_after", "epoch_start"):
            setattr(out, name, getattr(self, name)[:n_max])
        out.bit_off = self.bit_off[: n_max + 1]
        out.next_width = self.next_width[: n_max + 1]
        return out


def _capacity(n: int) -> int:
    """The size of the cached tables that serve n ordinals: the next power
    of two at or above n, so that a new stream length rarely builds one."""
    return 1 << max(n - 1, 0).bit_length()


class _Tables(NamedTuple):
    """A spec's schedule at one capacity and the tables derived from it.

    Every array is prefix-consistent: its entries for ordinals (or counts)
    up to n equal those built for a schedule of n, so a caller slices the
    prefix it needs.  ``eoi_off``, ``eoi_w`` and ``nbytes`` hold a row for
    each EOI rule (``fix_eoi`` 0, then 1) over counts n = 0..cap: the EOI's
    bit offset and width and the stream's wire byte length, which is
    non-decreasing in n.  The arrays are read-only: every caller shares
    them.
    """

    sched: Schedule
    eoi_off: np.ndarray    # i64[2, cap + 1]
    eoi_w: np.ndarray      # i64[2, cap + 1]
    nbytes: np.ndarray     # i64[2, cap + 1]
    clear_m: np.ndarray    # ordinals followed by a CLEAR (ascending)
    clear_off: np.ndarray  # the bit offsets of those CLEARs
    rows: np.ndarray       # i32[2, cap]: the decoder's next index, epoch start


@functools.lru_cache(maxsize=16)
def _tables_at(spec: LzwSpec, cap: int) -> _Tables:
    sched = Schedule(spec, cap)
    off, w, total = (np.stack(a) for a in zip(
        *(sched.eoi_tables(fix) for fix in (False, True))))
    nbytes = (total + 7) // 8
    # A CLEAR only adds bits, and the final code's CLEAR is dropped, so the
    # byte lengths never fall: count recovery searches them.
    if (nbytes[:, 1:] < nbytes[:, :-1]).any():
        raise RuntimeError(f"wire byte lengths of {spec} fall somewhere")
    clear_m = np.nonzero(sched.clear_after)[0]
    clear_off = sched.bit_off[clear_m] + sched.widths[clear_m]
    rows = np.stack([sched.nxt_of - 1, sched.epoch_start]).astype(np.int32)
    for arr in (*vars(sched).values(), off, w, nbytes, clear_m, clear_off,
                rows):
        if isinstance(arr, np.ndarray):
            arr.flags.writeable = False
    return _Tables(sched, off, w, nbytes, clear_m, clear_off, rows)


def _tables(spec: LzwSpec, n: int) -> _Tables:
    """The cached tables that hold ordinals and counts 0..n."""
    return _tables_at(spec, _capacity(n))


def emission_schedule(spec: LzwSpec, n_max: int) -> Schedule:
    """``Schedule(spec, n_max)``, sliced from the cached tables (its arrays
    are read-only)."""
    return _tables(spec, n_max).sched.prefix(n_max)


@functools.lru_cache(maxsize=16)
def epoch_steps(spec: LzwSpec) -> int:
    """Data codes of one dictionary epoch of a strict variable stream: the
    steps from a CLEAR to the next.  Epoch ``e`` of the schedule rows holds
    steps ``[e * P, (e + 1) * P)``, and its step ``k >= 1`` has the next
    index ``first_free + k - 1``.  The early-increment strategies (TIFF)
    trip table-full one code sooner (`lib.rs:84-91` applied at
    `decoder.rs:277-279`), so this is the position of the schedule's first
    mandatory CLEAR, not ``4096 - first_free + 1``."""
    clear_after = Schedule(spec, 1 << MAX_WIDTH).clear_after
    return int(np.argmax(clear_after)) + 1


def schedule_rows(spec: LzwSpec, S: int) -> np.ndarray:
    """The schedule rows i32[2, S] of a strict variable stream: per step,
    the decoder's next index (the encoder's minus one) and the ordinal of
    the step's epoch start."""
    return np.ascontiguousarray(_tables(spec, S).rows[:, :S])


@functools.lru_cache(maxsize=16)
def _device_tables_at(spec: LzwSpec, cap: int, fix_eoi: bool,
                      device: torch.device):
    tabs = _tables_at(spec, cap)

    def t(a):
        return torch.tensor(a, dtype=torch.int64, device=device)

    return {"bit_off": t(tabs.sched.bit_off), "widths": t(tabs.sched.widths),
            "clear_m": t(tabs.clear_m), "clear_off": t(tabs.clear_off),
            "eoi_off": t(tabs.eoi_off[int(fix_eoi)]),
            "eoi_w": t(tabs.eoi_w[int(fix_eoi)]),
            "nbytes": t(tabs.nbytes[int(fix_eoi)])}


@functools.lru_cache(maxsize=16)
def _device_tables(spec: LzwSpec, S: int, fix_eoi: bool, device: torch.device):
    """Per-ordinal (bit offset, width) and per-count EOI tables on a device:
    the prefixes for S ordinals of tables cached per capacity."""
    tabs = _tables(spec, S)
    full = _device_tables_at(spec, _capacity(S), fix_eoi, device)
    k = int(np.searchsorted(tabs.clear_m, S))
    return {
        "bit_off": full["bit_off"][:S], "widths": full["widths"][:S],
        "clear_m": full["clear_m"][:k], "clear_off": full["clear_off"][:k],
        "eoi_off": full["eoi_off"][: S + 1], "eoi_w": full["eoi_w"][: S + 1],
        "nbytes": full["nbytes"][: S + 1],
        "max_bits": int(tabs.eoi_off[int(fix_eoi), S]
                        + tabs.eoi_w[int(fix_eoi), S]),
    }


def pack_variable(dense: torch.Tensor, counts: torch.Tensor, spec: LzwSpec,
                  fix_eoi: bool = True):
    """Pack dense data-code arrays against the static schedule, on device.

    Args:
      dense:  i32[N, S] data codes; entries at or past counts are ignored.
      counts: i32[N] data-code counts per stream (each <= S).
      spec:   variable-flavor spec.
    Returns:
      (bytes u8[N, PB], lengths i32[N]) with PB = ceil(max bits / 8) + 16,
      the layout of ``lzw_tpu.kernels.schedule.pack_variable``.
    """
    if not spec.variable:
        raise ValueError("pack_variable takes a variable-width spec")
    N, S = dense.shape
    dev = dense.device
    tabs = _device_tables(spec, S, fix_eoi, dev)
    little = spec.endianness.value == "little"
    PB = (tabs["max_bits"] + 7) // 8 + 16
    out = torch.zeros((N, PB + 3), dtype=torch.int64, device=dev)
    counts = counts.to(torch.int64)

    # Leading CLEAR.
    init_w = torch.tensor([[spec.initial_width]], device=dev)
    scatter_symbols(
        out, torch.full((N, 1), spec.clear_code, dtype=torch.int64,
                        device=dev),
        init_w, torch.zeros((1, 1), dtype=torch.int64, device=dev), little,
    )
    # Data codes.
    ordinal = torch.arange(S, device=dev)
    vals = torch.where(ordinal[None, :] < counts[:, None],
                       dense.to(torch.int64), 0)
    scatter_symbols(out, vals, tabs["widths"][None], tabs["bit_off"][None],
                    little)
    # Mid-stream CLEARs: emitted only when a data code follows.
    cm = tabs["clear_m"]
    if cm.numel():
        present = (counts[:, None] > cm[None, :] + 1).to(torch.int64)
        scatter_symbols(
            out, present * spec.clear_code,
            torch.full((1, cm.numel()), MAX_WIDTH, dtype=torch.int64,
                       device=dev),
            tabs["clear_off"][None], little,
        )
    # Trailing EOI at a per-stream offset and width.
    scatter_symbols(
        out, torch.full((N, 1), spec.end_code, dtype=torch.int64, device=dev),
        tabs["eoi_w"][counts][:, None], tabs["eoi_off"][counts][:, None],
        little,
    )
    lengths = tabs["nbytes"][counts]
    return out[:, :PB].to(torch.uint8), lengths.to(torch.int32)


_LANES = np.arange(3)


def _read_symbols(payloads, rows, bit_off, width, little: bool):
    """Symbols of ``width`` bits at bit offsets ``bit_off`` of the rows
    ``rows`` of the u8 matrix ``payloads`` (the three broadcast together),
    bytes past the matrix's width reading 0: one gather of three bytes."""
    PB = payloads.shape[1]
    at = (np.asarray(bit_off) >> 3)[..., None] + _LANES
    rows = np.asarray(rows)[..., None]
    if PB:
        window = payloads[rows, np.minimum(at, PB - 1)] * (at < PB)
    else:
        window = np.zeros(np.broadcast(rows, at).shape, np.uint8)
    b = window.astype(np.int64)
    word = join_lanes((b[..., 0], b[..., 1], b[..., 2]), little)
    return read_symbol(word, bit_off & 7, width, little)


def recover_counts(payloads, plens, spec: LzwSpec):
    """Host-side stream-length recovery + frame-level strictness checks.

    Candidates for a stream's data-code count n are every n whose wire byte
    length, under either EOI width rule, matches; ambiguity (possible at
    small code sizes where several 3-bit codes share a byte) is resolved by
    checking the trailing EOI.  The byte lengths never fall in n, so each
    rule's candidates for a row are a range, found by search.  A row tries
    its candidates from the largest n down, the fixed-width EOI rule first
    on a tie, and keeps the first whose EOI reads as one: one gather a
    candidate rank, over the rows still open.

    Returns (counts i64[N], strict bool[N], S).  ``strict`` here covers the
    checks that need only a handful of byte reads per stream (byte-length /
    EOI match, leading CLEAR, mid-stream CLEARs); the per-data-slot
    CLEAR/EOI check lives with the unpack.

    Counts ``recover.blocks`` (the N rows) and ``recover.reads`` (the EOI
    symbols read: one for each candidate each row tries) in
    :mod:`lzw_tpu_torch.utils.spans`.
    """
    if not spec.variable:
        raise ValueError("recover_counts takes a variable-width spec")
    payloads = np.asarray(payloads)
    N, PB = payloads.shape
    spans.count("recover.blocks", N)
    # Upper bound on data codes: every code at the minimum width.
    S = int((8 * PB) // spec.initial_width + 2)
    tabs = _tables(spec, S)
    little = spec.endianness.value == "little"
    plens = np.asarray(plens, np.int64)
    counts = np.zeros(N, np.int64)
    found = plens == 0  # n = 0

    with spans.span("recover.candidates"):
        row = np.nonzero(~found)[0]
        # Per EOI rule (0: the last code's width, 1: the decoder's), the
        # row's candidates lo..head, tried from head down.
        nb = tabs.nbytes[:, : S + 1]
        lo = np.stack([np.searchsorted(t, plens[row], "left") for t in nb])
        head = np.stack([np.searchsorted(t, plens[row], "right")
                         for t in nb]) - 1
        keep = (head >= lo).any(axis=0)
        reads = 0
        while keep.any():
            row, lo, head = row[keep], lo[:, keep], head[:, keep]
            has = head >= lo
            rule = (has[1] & (~has[0] | (head[1] >= head[0]))).astype(np.intp)
            at = np.arange(row.size)
            n = head[rule, at]
            head[rule, at] -= 1
            off, w = tabs.eoi_off[rule, n], tabs.eoi_w[rule, n]
            # A candidate whose three-byte window ends past the width plus
            # 4 is not read, as in the JAX package (its copy pads by 4).
            ok = (off >> 3) + 2 < PB + 4
            hit = np.zeros(row.size, bool)
            hit[ok] = _read_symbols(payloads, row[ok], off[ok], w[ok],
                                    little) == spec.end_code
            reads += int(ok.sum())
            counts[row[hit]] = n[hit]
            found[row[hit]] = True
            keep = ~hit & (head >= lo).any(axis=0)
    spans.count("recover.reads", reads)
    strict = found
    max_n = int(counts.max()) if N else 0

    with spans.span("recover.strict"):
        rows = np.arange(N)
        # Validate the leading CLEAR.
        lead = _read_symbols(payloads, rows, 0, spec.initial_width, little)
        strict &= (lead == spec.clear_code) | (plens == 0)
        # Mid-stream CLEARs, where a data code follows: rows x positions.
        k = int(np.searchsorted(tabs.clear_m, max_n))
        if k:
            vals = _read_symbols(payloads, rows[:, None], tabs.clear_off[:k],
                                 MAX_WIDTH, little)
            mid = tabs.clear_m[:k] + 1 < counts[:, None]
            strict &= (~mid | (vals == spec.clear_code)).all(axis=1)

    return counts, strict, S


def unpack_variable_device(payloads: torch.Tensor, counts: torch.Tensor,
                           spec: LzwSpec, S: int):
    """Dense-code unpack on the payloads' device.

    ``payloads`` u8[N, PB] (zero past each stream's length), ``counts``
    i32[N] from :func:`recover_counts`.  Returns (dense i32[N, S], data_ok
    bool[N]); data_ok is False when a data slot holds CLEAR/EOI (a
    non-strict stream).
    """
    if not spec.variable:
        raise ValueError("unpack_variable_device takes a variable-width spec")
    N, PB = payloads.shape
    dev = payloads.device
    tabs = _device_tables(spec, S, True, dev)
    bit_off, widths = tabs["bit_off"], tabs["widths"]
    need = int(bit_off[-1].item() >> 3) + 3 if S else 0
    padded = torch.zeros((N, max(PB, need) + 4), dtype=torch.int64,
                         device=dev)
    padded[:, :PB] = payloads
    b0 = (bit_off >> 3)[None, :].expand(N, -1)
    little = spec.endianness.value == "little"
    window = join_lanes((padded.gather(1, b0), padded.gather(1, b0 + 1),
                         padded.gather(1, b0 + 2)), little)
    vals = read_symbol(window, (bit_off & 7)[None, :], widths[None, :],
                       little)
    sel = torch.arange(S, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    vals = torch.where(sel, vals, 0)
    bad = sel & ((vals == spec.clear_code) | (vals == spec.end_code))
    return vals.to(torch.int32), ~bad.any(dim=1)


def unpack_variable(payloads, plens, spec: LzwSpec):
    """Unpack strict streams to dense data codes + validation flags (host).

    ``payloads`` u8[N, PB] (zero past each stream's length) and ``plens``
    [N] byte lengths, numpy.  Returns numpy (dense i32[N, S], counts
    i32[N], strict bool[N]).  ``strict`` is False when the stream deviates
    from the static schedule (early CLEAR, missing EOI, width drift):
    callers must fall back to the general decoder for those streams.
    :func:`recover_counts`, then :func:`unpack_variable_device` on the CPU.
    """
    counts, strict, S = recover_counts(payloads, plens, spec)
    dense, data_ok = unpack_variable_device(
        torch.from_numpy(np.ascontiguousarray(payloads, np.uint8)),
        torch.from_numpy(counts.astype(np.int32)), spec, S)
    return (dense.numpy(), counts.astype(np.int32),
            strict & data_ok.numpy())
