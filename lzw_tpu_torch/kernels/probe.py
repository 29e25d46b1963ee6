"""Scan-rate and gather probes P3 and P4: the CUDA kernels and plain versions.

Port of the Pallas probes of the JAX package's scripts:

- P3, ``scripts/probe_i16.py:make``: ``steps`` sweeps of a zero-filled
  table of ``rows`` rows with compare <, select and max, in int32 and in
  int16 (:func:`probe_scan`, ``csrc/probe_scan.cu``).  Its output is 0
  for any input; it exists to time the sweep.  Another ``fill`` of the
  table makes the compare, select and max show in the output, for tests.
- P4, ``scripts/probe_tpu.py``: ``x * 2 + 1`` (:func:`affine`), the
  per-lane gather ``o[r, l] = tab[idx[r, l], l]`` (:func:`gather_lanes`)
  and a chain of ``steps`` dependent gathers (:func:`gather_loop`), all in
  ``csrc/probe_gather.cu``.

And the chain-step probe of the encode kernels, which ports no TPU probe:
``steps`` steps of a dependent chain through a shared-memory table, by
one thread or a warp on the same values, timed by ``clock64``
(:func:`chain_steps`, ``csrc/chain_probe.cu``).

Every wrapper runs its plain version for CPU tensors, its kernel for CUDA
tensors, and raises for anything else.  Integer arithmetic wraps as int32.
"""

from __future__ import annotations

import math

import torch

from lzw_tpu_torch.kernels import build

__all__ = ["SENTINEL", "probe_scan", "probe_scan_reference", "affine",
           "affine_reference", "gather_lanes", "gather_lanes_reference",
           "gather_loop", "gather_loop_reference", "CHAIN_MODES",
           "CHAIN_WORDS", "chain_steps", "chain_steps_reference"]

SENTINEL = -30000  # the scan's value for rows not below the step's value


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _check_scan(x: torch.Tensor, rows: int) -> int:
    """Validates ``x`` [1, steps, *cols]; returns the column count."""
    if x.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"x has dtype {x.dtype}, expected int32 or int16")
    if x.dim() < 3 or x.shape[0] != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous tensor [1, steps, *cols]")
    cols = math.prod(x.shape[2:])
    if cols % 16:
        raise ValueError(f"the column count ({cols}) must be a multiple "
                         "of 16")
    if rows <= 0:
        raise ValueError(f"rows must be positive, was {rows}")
    return cols


def _fill_word(fill: int, dtype: torch.dtype) -> int:
    """The table's 32-bit word: ``fill`` as int32, or as int16 in both
    halves; raises when ``fill`` does not fit ``dtype``."""
    info = torch.iinfo(dtype)
    if not info.min <= fill <= info.max:
        raise ValueError(f"fill {fill} does not fit {dtype}")
    if dtype == torch.int16:
        return (fill & 0xFFFF) * 0x10001
    return fill & 0xFFFFFFFF


def probe_scan(x: torch.Tensor, *, rows: int = 1024,
               fill: int = 0) -> torch.Tensor:
    """P3: ``acc = max(acc, max over rows of where(tab < t, tab, -30000))``
    for each step's values ``t = x[0, j]``, over a table of ``rows`` rows
    that all hold ``fill`` (the script's 0), ``acc`` from 0.  ``x`` int32 or
    int16 [1, steps, *cols] -> o [1, *cols] of its dtype (the script's x
    [1, 512, 16, 128])."""
    cols = _check_scan(x, rows)
    word = _fill_word(fill, x.dtype)
    if x.device.type == "cpu":
        return probe_scan_reference(x, rows=rows, fill=fill)
    dev = _cuda_device(x)
    steps = x.shape[1]
    packed = x.dtype == torch.int16
    words = x.reshape(steps, cols).view(torch.int32)  # two int16 per word
    fn = build.bound("probe_scan", "probe_scan_launch")
    with build.on_device(dev):
        out = torch.empty(words.shape[1], dtype=torch.int32, device=dev)
        rc = fn(words.data_ptr(), out.data_ptr(), steps, words.shape[1],
                rows, int(packed), word, build.stream(dev))
    build.check_launch("probe_scan", rc)
    return out.view(x.dtype).reshape(1, *x.shape[2:])


def probe_scan_reference(x: torch.Tensor, *, rows: int = 1024,
                         fill: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_scan`, one step at a time over
    the whole [rows, cols] table."""
    cols = _check_scan(x, rows)
    _fill_word(fill, x.dtype)
    steps = x.shape[1]
    xs = x.reshape(steps, cols)
    tab = torch.full((rows, cols), fill, dtype=x.dtype, device=x.device)
    acc = torch.zeros(cols, dtype=x.dtype, device=x.device)
    for j in range(steps):
        cand = torch.where(tab < xs[j], tab, SENTINEL).amax(dim=0)
        acc = torch.maximum(acc, cand)
    return acc.reshape(1, *x.shape[2:])


def affine(x: torch.Tensor) -> torch.Tensor:
    """P4-a: ``x * 2 + 1`` of an int32 tensor."""
    dev = x.device
    build.require_tensor(x, "x", torch.int32, x.dim(), dev)
    if dev.type == "cpu":
        return affine_reference(x)
    _cuda_device(x)
    fn = build.bound("probe_gather", "affine_launch")
    with build.on_device(dev):
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), build.stream(dev))
    build.check_launch("probe_gather", rc)
    return out


def affine_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`affine`."""
    return x * 2 + 1


def _check_gather(tab: torch.Tensor, idx: torch.Tensor) -> None:
    dev = tab.device
    build.require_tensor(tab, "tab", torch.int32, 2, dev)
    build.require_tensor(idx, "idx", torch.int32, 2, dev)
    if idx.shape[1] != tab.shape[1]:
        raise ValueError(f"idx has {idx.shape[1]} lanes, tab {tab.shape[1]}")
    if tab.shape[0] == 0:
        raise ValueError("tab has no rows")


def gather_lanes(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P4-b: ``o[r, l] = tab[idx[r, l], l]`` for tab i32[H, L] and idx
    i32[R, L] with entries in [0, H) -> o i32[R, L]."""
    _check_gather(tab, idx)
    dev = tab.device
    if dev.type == "cpu":
        return gather_lanes_reference(tab, idx)
    _cuda_device(tab)
    fn = build.bound("probe_gather", "gather_lanes_launch")
    height, lanes = tab.shape
    with build.on_device(dev):
        out = torch.empty_like(idx)
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), height,
                lanes, idx.numel(), build.stream(dev))
    build.check_launch("probe_gather", rc)
    return out


def gather_lanes_reference(tab: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_lanes` (advanced indexing)."""
    _check_gather(tab, idx)
    lanes = torch.arange(tab.shape[1], device=tab.device)
    return tab[idx.long(), lanes]


def _check_loop(tab: torch.Tensor, idx: torch.Tensor, steps: int) -> None:
    _check_gather(tab, idx)
    height = tab.shape[0]
    if height & (height - 1):
        raise ValueError(f"tab's height must be a power of two, was {height}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, was {steps}")


def gather_loop(tab: torch.Tensor, idx: torch.Tensor,
                steps: int = 256) -> torch.Tensor:
    """P4-b2: per lane ``acc = 0``, then ``steps`` times ``row = (idx +
    acc) & (H - 1)``, ``acc = tab[row, l] + acc``; tab i32[H, L] with H a
    power of two, idx i32[R, L] -> acc i32[R, L]."""
    _check_loop(tab, idx, steps)
    if tab.device.type == "cpu":
        return gather_loop_reference(tab, idx, steps)
    dev = _cuda_device(tab)
    fn = build.bound("probe_gather", "gather_loop_launch")
    with build.on_device(dev):
        out = torch.empty_like(idx)
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
                tab.shape[1], idx.numel(), steps, build.stream(dev))
    build.check_launch("probe_gather", rc)
    return out


def gather_loop_reference(tab: torch.Tensor, idx: torch.Tensor,
                          steps: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_loop`, one gather per step."""
    _check_loop(tab, idx, steps)
    lanes = torch.arange(tab.shape[1], device=tab.device)
    acc = torch.zeros_like(idx)
    for _ in range(steps):
        row = (idx + acc) & (tab.shape[0] - 1)
        acc = tab[row.long(), lanes] + acc
    return acc


# chain_probe.cu's modes and its table of u32 words (64 KiB); "branch" and
# "store" are the load chain with a global store a step in four, behind a
# branch or made every step.
CHAIN_MODES = ("load", "parse", "stream", "branch", "store")
CHAIN_WORDS = 16384
_HASH = 2654435761


def _mix(b: int) -> int:
    return ((b * 0x9E3779B1) & 0xFFFFFFFF) >> 16 & 0xFFF8


def chain_steps(tab: torch.Tensor, start: int, mode: str, lanes: int,
                steps: int) -> tuple[int, int]:
    """``steps`` steps of chain ``mode`` over the u32 table ``tab``
    (i32[CHAIN_WORDS] on the card) from ``start``, run by ``lanes`` lanes
    of one warp on the same values: (clock64 cycles of the loop, the
    chain's last value).  CUDA tensors only: the cycles have no plain
    version; :func:`chain_steps_reference` gives the value."""
    dev = _cuda_device(tab)
    if tab.dtype != torch.int32 or tab.shape != (CHAIN_WORDS,) or \
            not tab.is_contiguous():
        raise ValueError(f"tab must be contiguous i32[{CHAIN_WORDS}]")
    fn = build.bound("chain_probe", "chain_probe_launch")
    with build.on_device(dev):
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)
        out = torch.zeros(2, dtype=torch.int32, device=dev)
        sink = torch.zeros(1024, dtype=torch.int32, device=dev)
        rc = fn(tab.data_ptr(), start, CHAIN_MODES.index(mode), lanes, steps,
                cycles.data_ptr(), out.data_ptr(), sink.data_ptr(),
                build.stream(dev))
    build.check_launch("chain_probe", rc)
    return int(cycles.item()), int(out[0].item()) & 0xFFFFFFFF


def chain_steps_reference(tab, start: int, mode: str, steps: int) -> int:
    """The last value of :func:`chain_steps`' chain, a loop on the host."""
    t = [int(v) & 0xFFFFFFFF for v in torch.as_tensor(tab).tolist()]
    x, k = start, 0
    for _ in range(steps):
        if mode in ("load", "branch", "store"):
            x = t[x]
        elif mode == "parse":
            key = (x * ((_HASH << 8) & 0xFFFFFFFF) + k * _HASH) & 0xFFFFFFFF
            x = t[(key * 7168) >> 32] & 0xFFF
        else:
            x = t[((x ^ _mix(k)) >> 2) + 1]
        k = (k + 37) & 127
    return x
