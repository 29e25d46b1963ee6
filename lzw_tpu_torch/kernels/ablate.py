"""Encoder-cost ablations P1 and P2: the CUDA kernels and their plain versions.

Port of the Pallas ablation kernels of the JAX package's scripts:
``scripts/ablate_kernel.py`` (P1: ``make_kernel`` and ``make_grid_kernel``)
and ``scripts/ablate2.py`` (P2: ``make_kernel``).  Both run a toy lockstep
LZW parse, one lane per column of ``x``, and differ by variant in how much
of a real parse's memory work they do.  Per lane and step, with
``prefix = 0`` and ``nxt = 256`` at the start::

    key     = prefix * 256 + k                      (int32, wrapping)
    matched = the largest table row whose entry == key, else -1
    out     = prefix on a miss (matched < 0), else -1
    ins     = miss and nxt < 4096                   (nxt += ins always)
    prefix  = k on a miss, else max(matched, 0)

P1 variants (``x`` i32[G, B, L], one lockstep group of L lanes per g):

- ``empty``: no lookup, every step misses;
- ``scan_noinsert`` (``scan_reduce_only``): the lookup, no insert;
- ``scan``: the lookup, and a miss writes ``key`` at row ``nxt``;
- ``scan_wininsert``: the write happens only while ``nxt`` lies in
  ``[w0, w0 + seg)``, ``w0 = (min over the group's lanes of nxt) // 8 * 8``;
- ``seg2``: as ``scan_wininsert``, but the lookup sees only rows
  ``< 4 * seg`` (the JAX kernel's four static segments).

The grid kernel's ``gempty``, ``gscan_noins`` and ``gscan`` compute what
``empty``, ``scan_noinsert`` and ``scan`` compute: the chunk/grid split is
only the TPU's tiling, so one function serves both.

P2 variants (``x`` i32[steps, *lanes], every lane on its own):

- ``empty``: no lookup;
- ``scan``: the lookup in a table that no variant writes;
- ``ring``: that lookup, and a ring of ``ring`` rows per lane, written at row
  ``j % ring`` with ``key`` (or -1 when ``ins`` is false) each step, where
  ``j`` is the step's index within its cell of ``cell`` steps; ``matched``
  is the larger of the table's and the ring's largest matching row.

The kernels keep each lane's dictionary in shared memory as an
open-addressed index of key -> row where the TPU compare-scanned a table of
rows: ``csrc/ablate_parse.cu`` (8 lanes a CTA, a lockstep group one thread
block cluster, :data:`PARSE_LAYOUT`) and ``csrc/ablate_ring.cu`` (up to 8
lanes a CTA, each lane's ring beside an index of its rows that a lookup
walks once a step, :data:`RING_LAYOUT`).  So they are exact for inputs in
``[0, 2**23)``, where no key is the empty row's -1; the plain versions are
the TPU kernels' literal arithmetic and hold for every int32 input.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lzw_tpu_torch.kernels import build

__all__ = ["PARSE_LAYOUT", "PARSE_VARIANTS", "RING_LAYOUT", "RING_VARIANTS",
           "ParseLayout", "RingLayout", "ablate_parse",
           "ablate_parse_reference", "ablate_ring", "ablate_ring_reference",
           "parse_grid"]

FIRST_CODE = 256
TABLE_FULL = 4096  # no insert once nxt reaches this

# Variant name -> the kernels' template argument.
_EMPTY, _NOINSERT, _SCAN, _WININSERT, _SEG2 = range(5)
PARSE_VARIANTS = {
    "empty": _EMPTY, "scan_noinsert": _NOINSERT,
    "scan_reduce_only": _NOINSERT, "scan": _SCAN,
    "scan_wininsert": _WININSERT, "seg2": _SEG2,
    "gempty": _EMPTY, "gscan_noins": _NOINSERT, "gscan": _SCAN,
}
_LOCKSTEP = (_WININSERT, _SEG2)
_RING_EMPTY, _RING_SCAN, _RING_RING = range(3)
RING_VARIANTS = {"empty": _RING_EMPTY, "scan": _RING_SCAN,
                 "ring": _RING_RING}


class ParseLayout(NamedTuple):
    """``ablate_parse.cu``'s CTA (its kLanesPerCta, kThreads, kMaxCluster
    and kSharedBytes; the launch function refuses another)."""

    lanes_per_cta: int  # one warp a lane
    threads: int
    max_cluster: int  # CTAs of a lockstep group, one thread block cluster
    shared_bytes: int


# A lane: 6144 u16 hash slots, the key of each of rows 256..4095 (u32) and
# 64 steps of x (two buffers) and of out (i32); then each warp's nxt and
# the cluster's minima (i32, two buffers each) and their two mbarriers.
PARSE_LAYOUT = ParseLayout(
    8, 256, 16, 8 * (2 * 6144 + 4 * 3840 + 4 * 3 * 64) + 4 * 2 * 8
    + 4 * 2 * 16 + 8 * 2)


class RingLayout(NamedTuple):
    """``ablate_ring.cu``'s CTA (its kMaxLanesPerCta, kChunk, kLaneBytes,
    kMaxRing and kMaxSharedBytes).  A lane takes ``lane_bytes`` and 6 bytes
    a ring row; a CTA as many lanes as fit, at most ``max_lanes_per_cta``,
    one warp each.  The launch function refuses another layout."""

    max_lanes_per_cta: int
    chunk: int  # steps of x and out staged at once
    lane_bytes: int  # a lane's shared bytes besides its ring rows
    max_ring: int  # the index's 12-bit row field holds row + 1
    max_shared_bytes: int  # a CTA's on the H100

    def lanes_per_cta(self, ring: int) -> int:
        return min(self.max_lanes_per_cta,
                   self.max_shared_bytes // (self.lane_bytes + 6 * ring))

    def shared_bytes(self, ring: int) -> int:
        return self.lanes_per_cta(ring) * (self.lane_bytes + 6 * ring)


# A lane: two indexes of 6144 u16 slots (the never-written table's and the
# ring's), 64 steps of x (two buffers) and of out (i32) and the ring's row
# -1 (i32); then a key (i32) and a slot (u16) for each ring row.
RING_LAYOUT = RingLayout(8, 64, 2 * 2 * 6144 + 4 * 3 * 64 + 4, 4095, 232448)


def parse_grid(groups: int, lanes: int, variant: str) -> tuple[int, int,
                                                                int]:
    """(CTAs a group, groups, CTAs a cluster) of an ``ablate_parse``
    launch; raises when a lockstep group needs a larger cluster than the
    card's 16."""
    kind = _variant(PARSE_VARIANTS, variant)
    ctas = math.ceil(lanes / PARSE_LAYOUT.lanes_per_cta)
    if kind not in _LOCKSTEP:
        return ctas, groups, 1
    if ctas > PARSE_LAYOUT.max_cluster:
        raise ValueError(
            f"{variant} runs a group of {lanes} lanes as one cluster of "
            f"{PARSE_LAYOUT.lanes_per_cta} lanes a CTA: at most "
            f"{PARSE_LAYOUT.max_cluster * PARSE_LAYOUT.lanes_per_cta} lanes")
    return ctas, groups, ctas


def _variant(table: dict[str, int], variant: str) -> int:
    if variant not in table:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{sorted(table)}")
    return table[variant]


def _check_parse(x: torch.Tensor, table_rows: int, seg: int) -> None:
    build.require_tensor(x, "x", torch.int32, 3, x.device)
    if seg <= 0 or seg % 8:
        raise ValueError(f"seg must be a positive multiple of 8, was {seg}")
    if table_rows < TABLE_FULL + seg:
        # The insert window [w0, w0 + seg) starts at most at row 4096.
        raise ValueError(f"table_rows must be >= {TABLE_FULL + seg}, was "
                         f"{table_rows}")
    if x.shape[2] > 1024:
        raise ValueError(f"at most 1024 lanes per group, got {x.shape[2]}")


def _cuda_device(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def ablate_parse(x: torch.Tensor, variant: str, *, table_rows: int = 4608,
                 seg: int = 512) -> torch.Tensor:
    """P1: the lockstep toy parse of ``x`` i32[G, B, L] -> out i32[G, B, L].

    CPU tensors run :func:`ablate_parse_reference`; CUDA tensors run the
    kernel (exact for inputs in ``[0, 2**23)``; the lockstep variants
    ``scan_wininsert`` and ``seg2`` take at most 128 lanes, see
    :func:`parse_grid`), anything else raises.
    """
    kind = _variant(PARSE_VARIANTS, variant)
    _check_parse(x, table_rows, seg)
    if x.device.type == "cpu":
        return ablate_parse_reference(x, variant, table_rows=table_rows,
                                      seg=seg)
    dev = _cuda_device(x)
    G, B, L = x.shape
    parse_grid(G, L, variant)
    fn = build.bound("ablate_parse", "ablate_parse_launch")
    with build.on_device(dev):
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), G, B, L, seg, kind,
                PARSE_LAYOUT.lanes_per_cta, PARSE_LAYOUT.shared_bytes,
                build.stream(dev))
    build.check_launch("ablate_parse", rc)
    return out


def ablate_parse_reference(x: torch.Tensor, variant: str, *,
                           table_rows: int = 4608,
                           seg: int = 512) -> torch.Tensor:
    """Plain PyTorch version of :func:`ablate_parse`: the JAX kernel's
    compare-max over a [table_rows, L] table per group, one step at a time,
    vectorised over groups and lanes."""
    kind = _variant(PARSE_VARIANTS, variant)
    _check_parse(x, table_rows, seg)
    G, B, L = x.shape
    dev = x.device
    # seg2 looks only at its four static segments of seg rows.
    seen = 4 * seg if kind == _SEG2 else table_rows
    tab = torch.full((G, table_rows, L), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(seen, dtype=torch.int32, device=dev)[None, :, None]
    prefix = torch.zeros((G, L), dtype=torch.int32, device=dev)
    nxt = torch.full((G, L), FIRST_CODE, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    for i in range(B):
        k = x[:, i]
        key = prefix * 256 + k
        if kind == _EMPTY:
            matched = torch.full_like(key, -1)
        else:
            eq = tab[:, :seen] == key[:, None]
            matched = torch.where(eq, rows, -1).amax(dim=1)
        miss = matched < 0
        out[:, i] = torch.where(miss, prefix, -1)
        ins = miss & (nxt < TABLE_FULL)
        write = None
        if kind == _SCAN:
            write = ins
        elif kind in (_WININSERT, _SEG2):
            w0 = nxt.amin(dim=1, keepdim=True) // 8 * 8
            write = ins & (nxt >= w0) & (nxt < w0 + seg)
        if write is not None:
            at = nxt.clamp(max=table_rows - 1).long()[:, None]
            cur = tab.gather(1, at)
            tab.scatter_(1, at, torch.where(write[:, None], key[:, None],
                                            cur))
        prefix = torch.where(miss, k, matched.clamp(min=0))
        nxt = nxt + ins.to(torch.int32)
    return out


def _check_ring(x: torch.Tensor, cell: int, ring: int,
                table_rows: int) -> None:
    if x.dtype != torch.int32 or x.dim() < 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32 tensor [steps, *lanes]")
    if cell <= 0 or x.shape[0] % cell:
        raise ValueError(f"steps ({x.shape[0]}) must be a multiple of cell "
                         f"({cell})")
    if not 0 < ring <= RING_LAYOUT.max_ring:
        raise ValueError(f"ring must be in [1, {RING_LAYOUT.max_ring}], was "
                         f"{ring}")
    if table_rows <= 0:
        raise ValueError(f"table_rows must be positive, was {table_rows}")


def ablate_ring(x: torch.Tensor, variant: str, *, cell: int = 512,
                ring: int = 512, table_rows: int = 4608) -> torch.Tensor:
    """P2: the toy parse of ``x`` i32[steps, *lanes], every lane on its own,
    with a ring of recent keys -> out i32 of the same shape.

    CPU tensors run :func:`ablate_ring_reference`; CUDA tensors run the
    kernel (exact for inputs in ``[0, 2**23)``), anything else raises.  On
    both, ``ring`` must lie in ``[1, RING_LAYOUT.max_ring]`` (4095: the
    kernel's index names a row in 12 bits) or it raises ValueError.
    """
    kind = _variant(RING_VARIANTS, variant)
    _check_ring(x, cell, ring, table_rows)
    if x.device.type == "cpu":
        return ablate_ring_reference(x, variant, cell=cell, ring=ring,
                                     table_rows=table_rows)
    dev = _cuda_device(x)
    steps = x.shape[0]
    lanes = x[0].numel()
    fn = build.bound("ablate_ring", "ablate_ring_launch")
    with build.on_device(dev):
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), steps, lanes, cell, ring, kind,
                RING_LAYOUT.lanes_per_cta(ring),
                RING_LAYOUT.shared_bytes(ring), build.stream(dev))
    build.check_launch("ablate_ring", rc)
    return out


def ablate_ring_reference(x: torch.Tensor, variant: str, *, cell: int = 512,
                          ring: int = 512,
                          table_rows: int = 4608) -> torch.Tensor:
    """Plain PyTorch version of :func:`ablate_ring`, one step at a time,
    vectorised over lanes.  The table that no variant writes holds -1 in
    every row, so its compare-max is its last row for the key -1 and -1 for
    any other key."""
    kind = _variant(RING_VARIANTS, variant)
    _check_ring(x, cell, ring, table_rows)
    steps = x.shape[0]
    xs = x.reshape(steps, -1)
    L = xs.shape[1]
    dev = x.device
    buf = torch.full((ring, L), -1, dtype=torch.int32, device=dev)
    ring_rows = torch.arange(ring, dtype=torch.int32, device=dev)[:, None]
    prefix = torch.zeros(L, dtype=torch.int32, device=dev)
    nxt = torch.full((L,), FIRST_CODE, dtype=torch.int32, device=dev)
    out = torch.empty_like(xs)
    for s in range(steps):
        k = xs[s]
        key = prefix * 256 + k
        if kind == _RING_EMPTY:
            matched = torch.full_like(key, -1)
        else:
            matched = torch.where(key == -1, table_rows - 1, -1).to(
                torch.int32)
            if kind == _RING_RING:
                hit = torch.where(buf == key, ring_rows, -1).amax(dim=0)
                matched = torch.maximum(matched, hit)
        miss = matched < 0
        out[s] = torch.where(miss, prefix, -1)
        ins = miss & (nxt < TABLE_FULL)
        if kind == _RING_RING:
            buf[(s % cell) % ring] = torch.where(ins, key, -1)
        prefix = torch.where(miss, k, matched.clamp(min=0))
        nxt = nxt + ins.to(torch.int32)
    return out.reshape(x.shape)
