"""Ablation round 2 on the card: the toy parse P2 of 1024 independent lanes
with a table lookup and a ring of recent keys.

The counterpart of the JAX package's ``scripts/ablate2.py``::

    python -m lzw_tpu_torch.scripts.ablate2

It times the variants ``empty``, ``scan`` and ``ring`` of the kernel
``kernels/csrc/ablate_ring.cu`` (``kernels/ablate.py``: one warp a lane,
the lane's ring and an index of its rows in shared memory, one walk of the
index a step) at 4096 steps of (8, 128) lanes in cells of 512, each line
the mean of five calls on ``x + i`` (i < 5) by CUDA events.  Timing only:
``emitted`` counts the codes of the first call.  :func:`ring_cases` makes
the inputs that hold the kernel against its plain version.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lzw_tpu_torch.kernels import ablate
from lzw_tpu_torch.utils import card

STEPS, CELL = 4096, 512
VARIANTS = ("empty", "scan", "ring")


def make_input(device: torch.device, steps: int = STEPS,
               seed: int = 0) -> torch.Tensor:
    """The script's x: i32[steps, 8, 128] of random bytes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (steps, 8, 128)).astype(np.int32)
    return torch.from_numpy(x).to(device)


def ring_cases(steps: int, lanes: int, odd_lanes: int,
               seed: int = 0) -> dict[str, tuple[np.ndarray, int, int]]:
    """{name: (x i32[steps, n], cell, ring)}: the inputs on which the ring
    kernel's index must equal the compare-scan, ``steps`` a multiple of
    1024.  ``random`` is the script's x (with ``lanes`` 1024 and seed 0);
    the rest have a quarter of the lanes ``& 3``, whose keys repeat and so
    hit the ring: at the script's cell and ring (``hits``), in cells of 256
    (ring rows 256-511 never written) and of 1024, with a ring of 4 rows
    and with the largest ring in one cell of every step, on inputs in
    ``[2**23 - 300, 2**23)`` (keys past 2**31 wrap negative), and on
    ``odd_lanes`` lanes."""
    if steps % 1024:
        raise ValueError(f"steps must be a multiple of 1024, was {steps}")
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (steps, lanes)).astype(np.int32)
    hits = x.copy()
    hits[:, : lanes // 4] &= 3
    wide = (1 << 23) - 300 + rng.integers(0, 300, (steps, lanes)).astype(
        np.int32)
    wide[:, : lanes // 4] = (1 << 23) - 4 + (wide[:, : lanes // 4] & 3)
    odd = rng.integers(0, 256, (steps, odd_lanes)).astype(np.int32)
    odd[:, : odd_lanes // 4] &= 3
    return {"random": (x, CELL, 512), "hits": (hits, CELL, 512),
            "cell 256": (hits, 256, 512), "cell 1024": (hits, 1024, 512),
            "ring 4": (hits, CELL, 4),
            "ring max": (hits, steps, ablate.RING_LAYOUT.max_ring),
            "wide": (wide, CELL, 512), "odd lanes": (odd, CELL, 512)}


def run(variant: str, x: torch.Tensor, cell: int = CELL) -> tuple[float, int]:
    """Times ``variant`` and prints the JAX script's line; returns (ms per
    call, codes emitted)."""
    xs = [x + i for i in range(5)]  # before the warm-up call: its
    # scratch, once freed, serves the timed calls
    emitted = int((ablate.ablate_ring(x, variant, cell=cell) >= 0).sum())
    ms = card.events_ms([lambda xi=xi: ablate.ablate_ring(xi, variant,
                                                          cell=cell)
                         for xi in xs])
    steps = x.shape[0]
    secs = ms / 1e3
    print(f"{variant:8s}: {ms:7.3f} ms  {secs / steps * 1e9:7.0f} ns/step  "
          f"{x.numel() / secs / 2**20:7.0f} MiB/s  emitted={emitted}",
          flush=True)
    return ms, emitted


def main(argv: list[str] | None = None) -> dict[str, tuple[float, int]]:
    args = sys.argv[1:] if argv is None else argv
    if args:
        raise SystemExit("usage: python -m lzw_tpu_torch.scripts.ablate2")
    device = card.require_card()
    print(card.card_line(), flush=True)
    x = make_input(device)
    return {v: run(v, x) for v in VARIANTS}


if __name__ == "__main__":
    main()
