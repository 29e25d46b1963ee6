"""Ablation round 2 on the card: the toy parse P2 of 1024 independent lanes
with a table lookup and a ring of recent keys.

The counterpart of the JAX package's ``scripts/ablate2.py``::

    python -m lzw_tpu_torch.scripts.ablate2

It times the variants ``empty``, ``scan`` and ``ring`` of the kernel
``kernels/csrc/ablate_ring.cu`` (``kernels/ablate.py``) at 4096 steps of
(8, 128) lanes in cells of 512, each line the mean of five calls on
``x + i`` (i < 5) by CUDA events.  Timing only: ``emitted`` counts the
codes of the first call.
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
