"""Probe on the card: does the int16 compare/select/max scan, two columns
packed to a 32-bit word (s16x2), run at twice the int32 rate?

The counterpart of the JAX package's ``scripts/probe_i16.py``::

    python -m lzw_tpu_torch.scripts.probe_i16

The kernel ``kernels/csrc/probe_scan.cu`` (``kernels/probe.py``) sweeps a
zero-filled (1024, 16, 128) table with compare + select + max against
each of T = 512 steps' values, in int32 and in int16.  Each line is the
best of three calls by CUDA events, each on an input whose first value is
changed, as the JAX script times.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lzw_tpu_torch.kernels import probe
from lzw_tpu_torch.utils import card

S, SUB, T = 1024, 16, 512


def make_input(dtype: torch.dtype, device: torch.device, steps: int = T,
               seed: int = 0) -> torch.Tensor:
    """The script's x: [1, steps, 16, 128] of values in [1, 1000)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 1000, (1, steps, SUB, 128))
    return torch.from_numpy(x).to(dtype).to(device)


def run(dtype: torch.dtype, steps: int = T) -> float:
    """Times the sweep in ``dtype`` and prints the JAX script's line;
    returns the best ms."""
    x = make_input(dtype, card.require_card(), steps)
    probe.probe_scan(x, rows=S)
    best = float("inf")
    for rep in range(3):
        xv = x.clone()
        xv[0, 0, 0, 0] = rep + 1
        best = min(best, card.events_ms(
            [lambda: probe.probe_scan(xv, rows=S)]))
    rows_per_s = steps * S / (best / 1e3)
    name = str(dtype).removeprefix("torch.")
    print(f"{name}: {best:.4f} ms for {steps}x{S} rows "
          f"({rows_per_s / 1e9:.2f} G rows/s x {SUB * 128} lanes)", flush=True)
    return best


def main(argv: list[str] | None = None) -> dict[str, float]:
    args = sys.argv[1:] if argv is None else argv
    if args:
        raise SystemExit("usage: python -m lzw_tpu_torch.scripts.probe_i16")
    card.require_card()
    print(card.card_line(), flush=True)
    return {str(dt).removeprefix("torch."): run(dt)
            for dt in (torch.int32, torch.int16)}


if __name__ == "__main__":
    main()
