"""What the readers of the program's own spans and counters share.

The program (``lzw_tpu_torch.utils.spans``) opens a host range
``lzw.<name>`` in the profiler's trace for each step of a call, and, while
a ``torch.profiler`` records, adds each span's seconds and each counter's
ticks to its tally ``PROFILED``.  In a traced run only the second half of
the window runs under the profiler, so the tally holds the profiled calls
alone.  The trace itself is summarised by :mod:`portbench.tracing`, whose
``gaps`` name each idle stretch of a call by the shortest host event over
its middle: a stage span, a torch op, else a call or range span or the
call's own annotation ``portbench.<op>``.

A program without the module, or one that recorded no span, gives None.
"""

from __future__ import annotations

from portbench import tracing

PREFIX = "lzw."
# The spans of a whole call or of a range of it; every other lzw.* span is
# a stage span.
CALL_SPANS = ("lzw.encode", "lzw.decode", "lzw.range")


def profiled() -> dict | None:
    """The program's tally of the profiled stretch, or None where the
    program has no spans or recorded none."""
    try:
        from lzw_tpu_torch.utils import spans
    except ImportError:
        return None
    tally = spans.PROFILED.snapshot()
    return tally if any(k.startswith(PREFIX) for k in tally) else None


def span_ms(run, op: str, names) -> float | None:
    """Mean ms a profiled call of ``op`` spent in the spans ``names``
    (without the prefix); None where no profiled call entered any."""
    tally = profiled()
    calls = run.calls_of(op, "profiled")
    if run.profile is None or tally is None or not calls:
        return None
    keys = [PREFIX + n for n in names]
    if not any(k in tally for k in keys):
        return None
    return 1e3 * sum(tally.get(k, 0.0) for k in keys) / len(calls)


def idle_unspanned_pct(run, op: str) -> float | None:
    """The share of the idle seconds of the profiled calls of ``op`` that
    no stage span names, in percent: the gaps named by the call's own
    annotation or by a call or range span.  A gap named by a torch op
    counts as spanned: the program runs every torch op of a call inside a
    stage span."""
    if run.profile is None or profiled() is None:
        return None
    gaps = run.profile[op]["gaps"]
    idle = sum(gaps.values())
    if not idle:
        return None
    bare = {tracing.PREFIX + op, *CALL_SPANS}
    return 100 * sum(s for name, s in gaps.items() if name in bare) / idle


def ratio(numerator: str, denominator: str) -> float | None:
    """One counter of the profiled stretch over another; None where the
    second never ticked."""
    tally = profiled()
    if tally is None or not tally.get(denominator):
        return None
    return tally.get(numerator, 0) / tally[denominator]
