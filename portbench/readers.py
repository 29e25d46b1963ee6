"""What the metric readers of ``portbench/metrics/`` share.

A reader is ``portbench/metrics/<metric>.py`` with ``read(run)``, ``run``
a :class:`portbench.harness.Run`; it returns the metric's value, or None
where the run holds nothing to read it from.
"""

from __future__ import annotations

from portbench import roofline, stats


def timed_calls(run, op: str):
    """The calls the end-to-end metrics rest on: every call of ``op`` in
    the window of an untraced run."""
    return run.calls_of(op, "window")


def rate(run, op: str) -> float | None:
    calls = timed_calls(run, op)
    return stats.rate_mib_s([c.nbytes for c in calls],
                            [c.seconds for c in calls])


def p95_ms(run, op: str) -> float | None:
    """Over every call's latency: from its request's arrival in an open
    loop, else its own length."""
    value = stats.percentile(
        [c.seconds if c.latency is None else c.latency
         for c in timed_calls(run, op)], 95)
    return None if value is None else 1e3 * value


def _stage(stages: dict, name: str) -> float:
    """A stage's seconds, summed over the devices of a device list (keys
    ``<stage>@<device>``)."""
    return sum(s for k, s in stages.items() if k.split("@")[0] == name)


def stage_ms(run, op: str, names) -> float | None:
    """Mean ms a staged call of ``op`` spent in the stages ``names``; None
    where no staged call has any of them."""
    calls = run.calls_of(op, "staged")
    if not any(k.split("@")[0] in names for c in calls for k in c.stages):
        return None
    return 1e3 * sum(_stage(c.stages, n) for c in calls
                     for n in names) / len(calls)


def host_ms(run, op: str, host_stage: str) -> float | None:
    """Mean ms a staged call of ``op`` spent in ``host_stage`` and outside
    every stage: its wall time less every other stage."""
    calls = run.calls_of(op, "staged")
    if not calls:
        return None
    rest = [c.seconds - sum(s for k, s in c.stages.items()
                            if k.split("@")[0] != host_stage)
            for c in calls]
    return 1e3 * sum(rest) / len(calls)


def kernel_roofline(run, op: str, kernel: str, work) -> float | None:
    """The roofline share of the kernels whose trace name holds
    ``kernel`` in the profiled calls of ``op``; ``work(expected, nbytes)``
    gives a call's (bytes, ops)."""
    if run.profile is None:
        return None
    device_s = sum(s for name, s in run.profile[op]["kernels"].items()
                   if kernel in name)
    calls = run.calls_of(op, "profiled")
    return roofline.share_pct(
        [work(run.expected[c.input], c.nbytes) for c in calls], device_s)


def idle_pct(run, op: str) -> float | None:
    if run.profile is None or not run.profile[op]["wall_s"]:
        return None
    p = run.profile[op]
    return 100 * (1 - p["busy_s"] / p["wall_s"])
