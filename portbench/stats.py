"""The arithmetic of the end-to-end metrics: rates and tails of calls.

A rate is one sum over one sum: the uncompressed bytes of every call of
an operation over the summed wall seconds of those calls, in MiB/s (the
throughput of the program's ``utils/profiling.RunMetrics``, uncompressed
bytes a second, README.md:16-19, taken over all the calls of a window in
place of one call's).  A tail is a nearest-rank percentile over every
call, so it is always a latency that a call had.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

MiB = 1 << 20


def rate_mib_s(nbytes: Sequence[int], seconds: Sequence[float]) -> float | None:
    """Uncompressed MiB per second over all the calls; None without calls."""
    total = math.fsum(seconds)
    if not seconds or total <= 0:
        return None
    return sum(nbytes) / MiB / total


def percentile(values: Sequence[float], q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of them at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100 * len(ordered))) - 1]
