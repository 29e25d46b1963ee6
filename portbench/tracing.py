"""The reduction of a ``torch.profiler`` Chrome trace to per-call numbers.

The harness wraps each profiled call in ``record_function("portbench.<op>")``,
which the trace keeps as a host event of category ``user_annotation``.
Every kernel, copy and fill on the card is a device event (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``), on the same clock.  For each
operation this gives:

* ``wall_s``: the length of the union of its calls (their sum, where
  one caller makes one call at a time);
* ``busy_s``: the length of the union of the device events inside its
  calls, with events that overlap counted once (over ``wall_s``, the
  device's busy share);
* ``kernels``: device seconds by event name, inside its calls;
* ``gaps``: the seconds inside its calls in which the device was idle, by
  what the host was doing at the middle of each gap (the shortest host
  event that covers it; the call's own annotation where no finer one
  does).

Times in a Chrome trace are microseconds.
"""

from __future__ import annotations

import bisect
import collections
import json
import pathlib

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PREFIX = "portbench."
US = 1e-6


def load(path: str | pathlib.Path) -> list[dict]:
    """The complete events (``"ph": "X"``) of a Chrome trace file."""
    doc = json.loads(pathlib.Path(path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def union_length(intervals: list[tuple[float, float]], lo: float,
                 hi: float) -> float:
    """The length of the union of ``intervals`` (start, end) clipped to
    [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: list[tuple[float, float]], lo: float,
              hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``spans`` as disjoint intervals, in order."""
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def summarize(events: list[dict], ops) -> dict:
    """Per operation, and under ``"all"`` for every operation together:
    ``calls``, ``wall_s``, ``busy_s``, ``kernels`` and ``gaps`` (dicts of
    name -> seconds), as the module says.  Calls that overlap (several
    callers) count the time they share once."""
    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    device = sorted((span(e) + (e["name"],) for e in events
                     if e.get("cat") in DEVICE_CATS), key=lambda d: d[0])
    host = sorted((span(e) + (e["name"],) for e in events
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    dev_starts = [d[0] for d in device]
    host_starts = [h[0] for h in host]
    spans = {op: [] for op in (*ops, "all")}
    for e in events:
        if e.get("cat") != "user_annotation" or not e["name"].startswith(
                PREFIX):
            continue
        op = e["name"][len(PREFIX):]
        if op in spans and op != "all":
            spans[op].append(span(e))
            spans["all"].append(span(e))
    out = {}
    for op, calls in spans.items():
        rec = out[op] = {"calls": len(calls), "wall_s": 0.0, "busy_s": 0.0,
                         "kernels": collections.Counter(),
                         "gaps": collections.Counter()}
        for lo, hi in merge(calls):
            rec["wall_s"] += (hi - lo) * US
            # A call ends synchronised, so its device events start inside
            # it.
            first = max(bisect.bisect_left(dev_starts, lo) - 1, 0)
            inside = [d for d in device[first:bisect.bisect_right(
                dev_starts, hi)] if d[1] > lo]
            busy = [(s, t) for s, t, _ in inside]
            rec["busy_s"] += union_length(busy, lo, hi) * US
            for s, t, name in inside:
                rec["kernels"][name] += (min(t, hi) - max(s, lo)) * US
            cover = host[bisect.bisect_left(host_starts, lo):
                         bisect.bisect_right(host_starts, hi)]
            for gs, ge in idle_gaps(busy, lo, hi):
                mid = (gs + ge) / 2
                around = [h for h in cover if h[0] <= mid <= h[1]]
                name = min(around, key=lambda h: h[1] - h[0])[2] if around \
                    else PREFIX + op
                rec["gaps"][name] += (ge - gs) * US
    return out


def top(counter: dict, n: int = 10, width: int = 120) -> list[list]:
    """The ``n`` largest entries of ``counter`` as [name, seconds], each
    name cut to ``width`` characters."""
    ranked = sorted(counter.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], seconds] for name, seconds in ranked]
