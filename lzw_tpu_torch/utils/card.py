"""Timing on the card: its name and power limit, and CUDA-event times.

Every time these give is the card's.  Without a CUDA device
:func:`require_card` raises: a measurement has no CPU run.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Sequence

import torch

__all__ = ["require_card", "nvidia_smi_line", "card_line", "events_ms",
           "cuda_ms"]


def require_card() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measures the card and has "
                           "no CPU run")
    return torch.device("cuda", 0)


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    """One line naming the card, for the head of a measurement's output."""
    return (f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
            f"{nvidia_smi_line()}")


def events_ms(calls: Sequence[Callable[[], object]]) -> float:
    """Mean milliseconds per call of ``calls``, each run once in order,
    between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(calls)


def cuda_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a
    warm-up."""
    fn()
    return events_ms([fn] * reps)
