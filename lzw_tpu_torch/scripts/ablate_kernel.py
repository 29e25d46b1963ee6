"""Ablation timings of the lockstep toy parse P1 on the card.

The counterpart of the JAX package's ``scripts/ablate_kernel.py``::

    python -m lzw_tpu_torch.scripts.ablate_kernel [orig|grid|all]

``orig`` times the variants of its chunked kernel, ``grid`` (the default)
those of its grid kernel; both run the one kernel
``kernels/csrc/ablate_parse.cu`` (``kernels/ablate.py``).  Each line is the
mean of five calls on ``x + i`` (i < 5), as the JAX script times, by CUDA
events.  Timing only: ``emitted`` counts the codes of the first call.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lzw_tpu_torch.kernels import ablate
from lzw_tpu_torch.utils import card

LANES = 128
GROUPS, STEPS = 2, 4096
ORIG = ("empty", "scan_noinsert", "scan_wininsert", "scan", "seg2")
GRID = ("gempty", "gscan_noins", "gscan")


def make_input(device: torch.device, seed: int = 0) -> torch.Tensor:
    """The script's x: i32[2, 4096, 128] of random bytes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (GROUPS, STEPS, LANES)).astype(np.int32)
    return torch.from_numpy(x).to(device)


def run_variant(variant: str, x: torch.Tensor) -> tuple[float, int]:
    """Times ``variant`` and prints the JAX script's line; returns (ms per
    call, codes emitted)."""
    xs = [x + i for i in range(5)]  # before the warm-up call: its
    # scratch, once freed, serves the timed calls
    emitted = int((ablate.ablate_parse(x, variant) >= 0).sum())
    ms = card.events_ms([lambda xi=xi: ablate.ablate_parse(xi, variant)
                         for xi in xs])
    steps = x.shape[0] * x.shape[1]
    secs = ms / 1e3
    print(f"{variant:16s}: {ms:7.3f} ms  {secs / steps * 1e9:6.0f} ns/step  "
          f"{steps * x.shape[2] / secs / 2**20:6.0f} MiB/s  "
          f"emitted={emitted}", flush=True)
    return ms, emitted


def main(argv: list[str] | None = None) -> dict[str, tuple[float, int]]:
    args = sys.argv[1:] if argv is None else argv
    which = args[0] if args else "grid"
    if which not in ("orig", "grid", "all"):
        raise SystemExit("usage: python -m lzw_tpu_torch.scripts.ablate_kernel"
                         " [orig|grid|all]")
    device = card.require_card()
    print(card.card_line(), flush=True)
    x = make_input(device)
    variants = (ORIG if which in ("all", "orig") else ()) + (
        GRID if which in ("all", "grid") else ())
    return {v: run_variant(v, x) for v in variants}


if __name__ == "__main__":
    main()
