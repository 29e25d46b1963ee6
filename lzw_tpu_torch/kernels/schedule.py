"""Static emission schedules for variable-width LZW, and the torch bit-pack.

Port of ``lzw_tpu/kernels/schedule.py``.  Width bumps and CLEAR resets of a
variable stream depend only on how many codes were emitted since the last
reset, never on the data, so the whole wire layout (per-ordinal width, CLEAR
positions, bit offsets) is a static schedule.  The encode kernel only has to
produce code values; packing and unpacking are static-offset arithmetic.

``Schedule``, ``emission_schedule`` and ``recover_counts`` stay numpy on the
host, as in the JAX package.  ``pack_variable`` and
``unpack_variable_device`` were XLA glue there and are torch ops here, run on
the device of the tensors they are given: one scatter-add (pack) or gather
(unpack) per byte lane over per-ordinal offset tables, in place of the JAX
package's reshape-per-segment form, which existed because the TPU has no
cheap gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lzw_tpu_torch.spec import LzwSpec, MAX_WIDTH

__all__ = [
    "Schedule", "emission_schedule", "pack_variable", "recover_counts",
    "unpack_variable_device",
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
        widths = np.empty(n_max, np.int64)
        clear_after = np.zeros(n_max, bool)
        nxt_of = np.empty(n_max, np.int64)
        epoch_start = np.empty(n_max, np.int64)
        width = spec.initial_width
        nxt = first_free
        estart = 0
        for m in range(n_max):
            widths[m] = width
            nxt_of[m] = nxt
            epoch_start[m] = estart
            new_index = nxt
            nxt += 1
            if new_index == (1 << width) - inc:
                if width < MAX_WIDTH:
                    width += 1
                else:
                    clear_after[m] = True
                    width = spec.initial_width
                    nxt = first_free
                    estart = m + 1
        self.widths = widths
        self.clear_after = clear_after
        self.nxt_of = nxt_of
        self.epoch_start = epoch_start
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


@functools.lru_cache(maxsize=64)
def emission_schedule(spec: LzwSpec, n_max: int) -> Schedule:
    return Schedule(spec, n_max)


@functools.lru_cache(maxsize=16)
def _device_tables(spec: LzwSpec, S: int, fix_eoi: bool, device: torch.device):
    """Per-ordinal (bit offset, width) and per-count EOI tables on a device."""
    sched = emission_schedule(spec, S)
    eoi_off, eoi_w, total = sched.eoi_tables(fix_eoi)
    # CLEAR symbols sit right after their data code, 12 bits wide.
    clear_m = np.nonzero(sched.clear_after[:S])[0]
    clear_off = sched.bit_off[clear_m] + sched.widths[clear_m]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return {
        "bit_off": t(sched.bit_off[:S]), "widths": t(sched.widths[:S]),
        "clear_m": t(clear_m), "clear_off": t(clear_off),
        "eoi_off": t(eoi_off), "eoi_w": t(eoi_w),
        "nbytes": t((total + 7) // 8), "max_bits": int(total[S]),
    }


def _scatter_symbols(out, values, widths, bit_off, little: bool):
    """Add symbols (values i64[N, M] at static or per-row bit offsets) into
    the byte buffer ``out`` i64[N, PB].  Symbols occupy disjoint bits, so
    adding equals OR-ing."""
    N = out.shape[0]
    bit_off = bit_off.expand(N, -1)
    widths = widths.expand(N, -1)
    b0 = bit_off >> 3
    sh = bit_off & 7
    if little:
        window = values << sh
        lanes = ((0, 0), (1, 8), (2, 16))
    else:
        window = values << (24 - widths - sh)
        lanes = ((0, 16), (1, 8), (2, 0))
    for lane, shift in lanes:
        out.scatter_add_(1, b0 + lane, (window >> shift) & 0xFF)


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
    _scatter_symbols(
        out, torch.full((N, 1), spec.clear_code, dtype=torch.int64,
                        device=dev),
        init_w, torch.zeros((1, 1), dtype=torch.int64, device=dev), little,
    )
    # Data codes.
    ordinal = torch.arange(S, device=dev)
    vals = torch.where(ordinal[None, :] < counts[:, None],
                       dense.to(torch.int64), 0)
    _scatter_symbols(out, vals, tabs["widths"][None], tabs["bit_off"][None],
                     little)
    # Mid-stream CLEARs: emitted only when a data code follows.
    cm = tabs["clear_m"]
    if cm.numel():
        present = (counts[:, None] > cm[None, :] + 1).to(torch.int64)
        _scatter_symbols(
            out, present * spec.clear_code,
            torch.full((1, cm.numel()), MAX_WIDTH, dtype=torch.int64,
                       device=dev),
            tabs["clear_off"][None], little,
        )
    # Trailing EOI at a per-stream offset and width.
    _scatter_symbols(
        out, torch.full((N, 1), spec.end_code, dtype=torch.int64, device=dev),
        tabs["eoi_w"][counts][:, None], tabs["eoi_off"][counts][:, None],
        little,
    )
    lengths = tabs["nbytes"][counts]
    return out[:, :PB].to(torch.uint8), lengths.to(torch.int32)


def recover_counts(payloads, plens, spec: LzwSpec):
    """Host-side stream-length recovery + frame-level strictness checks.

    Candidates for a stream's data-code count n are every n whose wire byte
    length matches; ambiguity (possible at small code sizes where several
    3-bit codes share a byte) is resolved by checking the trailing EOI.
    Streams are grouped by byte length so the candidate sets are shared.

    Returns (counts i64[N], strict bool[N], S).  ``strict`` here covers the
    checks that need only a handful of byte reads per stream (byte-length /
    EOI match, leading CLEAR, mid-stream CLEARs); the per-data-slot
    CLEAR/EOI check lives with the unpack.
    """
    if not spec.variable:
        raise ValueError("recover_counts takes a variable-width spec")
    N, PB = payloads.shape
    # Upper bound on data codes: every code at the minimum width.
    S = int((8 * PB) // spec.initial_width + 2)
    sched = emission_schedule(spec, S)
    little = spec.endianness.value == "little"

    # int32 suffices: reads combine <= 3 bytes (< 2^24) before shifting.
    padded = np.zeros((N, PB + 4), np.int32)
    padded[:, :PB] = payloads

    def read_cols(bit_offs, widths):
        """Read one symbol per (stream, position): bit_offs/widths (M,)."""
        bit_offs = np.asarray(bit_offs, np.int64)
        widths = np.asarray(widths, np.int64)
        b0 = bit_offs >> 3
        if little:
            w0 = (padded[:, b0] | (padded[:, b0 + 1] << 8)
                  | (padded[:, b0 + 2] << 16))
            return (w0 >> (bit_offs & 7)) & ((1 << widths) - 1)
        wbe = ((padded[:, b0] << 16) | (padded[:, b0 + 1] << 8)
               | padded[:, b0 + 2])
        return (wbe >> (24 - (bit_offs & 7) - widths)) & ((1 << widths) - 1)

    totals = sched.eoi_tables(True)[2]
    totals_nofix = sched.eoi_tables(False)[2]
    byte_len = (totals + 7) // 8
    byte_len_nofix = (totals_nofix + 7) // 8
    counts = np.zeros(N, np.int64)
    chosen = np.zeros(N, bool)
    strict = np.ones(N, bool)

    plens = np.asarray(plens, np.int64)
    chosen |= plens == 0  # n = 0
    for nbytes in np.unique(plens[~chosen]) if (~chosen).any() else []:
        rows = np.nonzero(plens == nbytes)[0]
        cands = np.nonzero(
            (byte_len == nbytes) | (byte_len_nofix == nbytes)
        )[0]
        for n in cands[::-1]:
            n = int(n)
            todo = rows[~chosen[rows]]
            if todo.size == 0:
                break
            for fix in (True, False):
                if (sched.total_bits(n, fix) + 7) // 8 != nbytes:
                    continue
                off = sched.total_bits(n, fix) - sched.eoi_width(n, fix)
                w = sched.eoi_width(n, fix)
                if (off >> 3) + 2 >= padded.shape[1]:
                    continue
                v = read_cols([off], [w])[todo, 0]
                hit = todo[v == spec.end_code]
                counts[hit] = n
                chosen[hit] = True
    strict &= chosen
    counts[~chosen] = 0
    max_n = int(counts.max()) if N else 0

    # Validate the leading CLEAR.
    lead = read_cols([0], [spec.initial_width])[:, 0]
    strict &= (lead == spec.clear_code) | (plens == 0)

    # Mid-stream CLEARs (a handful of positions).
    for m in np.nonzero(sched.clear_after[:max_n])[0]:
        cvals = read_cols(
            [int(sched.bit_off[m] + sched.widths[m])], [MAX_WIDTH]
        )[:, 0]
        mid = (m + 1) < counts
        strict &= ~mid | (cvals == spec.clear_code)

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
    sh = (bit_off & 7)[None, :]
    c0 = padded.gather(1, b0)
    c1 = padded.gather(1, b0 + 1)
    c2 = padded.gather(1, b0 + 2)
    mask = (1 << widths[None, :]) - 1
    if spec.endianness.value == "little":
        vals = ((c0 | (c1 << 8) | (c2 << 16)) >> sh) & mask
    else:
        vals = (((c0 << 16) | (c1 << 8) | c2) >> (24 - widths[None, :] - sh)
                ) & mask
    sel = torch.arange(S, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    vals = torch.where(sel, vals, 0)
    bad = sel & ((vals == spec.clear_code) | (vals == spec.end_code))
    return vals.to(torch.int32), ~bad.any(dim=1)
