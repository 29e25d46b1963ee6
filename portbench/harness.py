"""One run of one cell: set-up, the measured window, the check, the metrics.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  Everything that belongs to
one cell is data, found by name: the cell's entry in ``BENCHMARK.json``
names its configuration (the file the configs entry gives) and its
traffic mix (``portbench/traffic/<mix>.json``, read by
:mod:`portbench.generator`); each metric is a reader
``portbench/metrics/<metric>.py`` whose ``read(run)`` returns a number,
or None where it finds nothing to read.

A configuration's ``"entry"`` names the program's entry point:
``"container"`` (the default), the block container
``lzw_tpu_torch.BlockParallelCodec`` over the configuration's
``block_size``; or ``"facade"``, the single-stream codec
``lzw_tpu_torch.api.LzwCodec`` with the ``backend`` of its ``codec``,
which has no ``block_size``, runs on one device, takes ``"call"``
windows only, and has no stage timer (the staged half of a traced window
runs it unstaged).

A run:

1. set-up: the configuration's corpus, the mix's inputs from ``--seed``
   (and, where its requests decode first, the reference's containers of
   them), the program's codec for each caller, and one request of every
   input on each, so that every shape the window meets is built;
2. the window: the mix's requests (:mod:`portbench.generator`), each call
   timed on the host clock from call to returned bytes.  With ``--trace
   1`` the first half of the window runs with the codec's ``stage_times``
   and the second half under ``torch.profiler``;
3. the peak device memory, then the program's state freed;
4. the reference's containers, a facade's streams (:mod:`portbench.check`),
   on a pool of worker processes that import nothing but NumPy and the
   reference;
5. every process the run started ended and waited for
   (:func:`end_children`);
6. one JSON line on standard output, the numbers compared and their
   limits as the last lines of standard error.

The run reads and writes nothing outside its checkout but ``TMPDIR``,
where a traced run writes its Chrome trace and deletes it once read.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import importlib.util
import json
import multiprocessing
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

from portbench import check, generator, tracing
from portbench.corpus import load_plane
from portbench.reference.lzw import Wire

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
OPS = ("encode", "decode")
# Top-level modules the process may not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "lzw_tpu")
WORKERS = 8
ENTRIES = ("container", "facade")


@dataclasses.dataclass
class Call:
    """One timed call."""

    op: str
    phase: str          # "window", "staged" or "profiled"
    input: int
    nbytes: int         # the call's uncompressed bytes
    seconds: float
    stages: dict | None = None
    latency: float | None = None  # from the request's arrival; else seconds


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    seed: int
    trace: bool
    setup_s: float
    calls: list[Call]
    expected: list[check.Expected]
    profile: dict | None  # tracing.summarize of the profiled calls

    def calls_of(self, op: str, phase: str | None = None) -> list[Call]:
        return [c for c in self.calls
                if c.op == op and (phase is None or c.phase == phase)]


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(bench: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mix = generator.load_mix(HERE / "traffic" / f"{w['traffic']}.json")
    kind = entry(config)
    if kind not in ENTRIES:
        raise ValueError(f"{w['config']}: entry {kind!r} is not one of "
                         f"{ENTRIES}")
    if kind == "facade" and int(w["chips"]) != 1:
        raise ValueError(f"{name}: a facade runs on one device, not "
                         f"{w['chips']}")
    if kind == "facade" and mix["window"] != "call":
        raise ValueError(f"{name}: a facade has no block_size for "
                         f"{mix['window']!r} windows")
    return Cell(name, int(w["chips"]), config, mix)


def entry(config: dict) -> str:
    """The configuration's entry point: ``"container"`` or ``"facade"``."""
    return config.get("entry", "container")


def block_size(config: dict) -> int | None:
    """The container's block size; None for a facade, which has none."""
    return None if entry(config) == "facade" else int(config["block_size"])


def metric_entries(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    metrics, else the end-to-end ones; each that lists its cells where it
    lists this one, else where the end-to-end metric it moves is
    reported."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or (
                "workloads" not in m and m["moves"] in names)]


def load_reader(name: str):
    """``portbench/metrics/<name>.py``, loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_spec(wire: dict):
    """The program's ``LzwSpec`` of a configuration's ``wire``."""
    from lzw_tpu_torch.spec import CodeSizeStrategy, Endianness, LzwSpec

    endian = Endianness(wire.get("endianness", "little"))
    if wire["flavor"] == "variable":
        strategy = (CodeSizeStrategy.TIFF if wire.get("strategy") == "tiff"
                    else CodeSizeStrategy.DEFAULT)
        return LzwSpec.variable(int(wire["code_size"]), endian, strategy)
    return LzwSpec.fixed(endian)


def make_program_codec(config: dict, devices, stage_times=None):
    """The program's codec for a configuration: its container, or its
    single-stream facade on the first device (``stage_times`` unused)."""
    spec = program_spec(config["wire"])
    codec = config.get("codec", {})
    if entry(config) == "facade":
        from lzw_tpu_torch.api import LzwCodec

        return LzwCodec(spec, codec["backend"], device=devices[0])
    from lzw_tpu_torch import BlockParallelCodec

    return BlockParallelCodec(
        spec, block_size(config),
        device=devices[0] if len(devices) == 1 else list(devices),
        verify=codec.get("verify"), pass2=codec.get("pass2", "auto"),
        stage_times=stage_times)


class _Window:
    """The mix's requests, sent by its callers: each request the mix's
    calls in order on the next input, each call timed on the host clock
    from call to returned bytes."""

    def __init__(self, mix: dict, inputs, tally: check.Tally,
                 calls: list[Call], seed: int, containers=None,
                 err=sys.stderr):
        self.mix = mix
        self.inputs = inputs
        self.containers = containers
        self.tally = tally
        self.calls = calls
        self.seed = seed
        self.err = err
        self.next = 0
        self.reported = False
        self.lock = threading.Lock()

    def _call(self, fn, arg, op, phase, i, nbytes, stages, annotate, since):
        if stages is not None:
            stages.clear()
        try:
            if annotate is not None:
                with annotate(tracing.PREFIX + op):
                    t = time.perf_counter()
                    out = fn(arg)
                    end = time.perf_counter()
            else:
                t = time.perf_counter()
                out = fn(arg)
                end = time.perf_counter()
        except Exception:  # a failing call is counted, the window goes on
            with self.lock:
                self.tally.failed()
                if not self.reported:
                    self.reported = True
                    traceback.print_exc(file=self.err)
            return None
        if phase != "warm":
            with self.lock:
                self.calls.append(Call(
                    op, phase, i, nbytes, end - t,
                    dict(stages) if stages is not None else None,
                    end - (t if since is None else min(since, t))))
        return out

    def request(self, codec, k: int, phase: str, stages=None, annotate=None,
                arrived: float | None = None) -> None:
        """Request ``k``: the mix's calls on input ``k`` mod the inputs;
        the first call's latency counts from ``arrived`` where given."""
        i = k % len(self.inputs)
        x = self.inputs[i].data
        c = self.containers[i] if self.containers is not None else None
        for op in self.mix["ops"]:
            if op == "encode":
                c = self._call(codec.encode, x, op, phase, i, len(x), stages,
                               annotate, arrived)
                if c is None:
                    return
                with self.lock:
                    self.tally.encoded(i, c)
            else:
                y = self._call(codec.decode, c, op, phase, i, len(x), stages,
                               annotate, arrived)
                if y is None:
                    return
                with self.lock:
                    self.tally.decoded(y, x)
            arrived = None

    def warm(self, codecs) -> None:
        """One request of every input on every caller's codec."""
        for codec in codecs:
            for k in range(len(self.inputs)):
                self.request(codec, k, "warm")

    def run(self, codecs, seconds: float, phase: str, min_iterations: int = 1,
            stages=None, annotate=None) -> None:
        """The window: a closed loop sends requests until ``seconds`` have
        passed and ``min_iterations`` were sent; an open loop sends every
        request that arrives in ``seconds``, each at its time.  One caller
        a codec, each in a thread of its own where there are several."""
        times = generator.arrivals(self.mix, seconds, self.seed,
                                   min_iterations)
        start = time.perf_counter()
        deadline = start + seconds
        sent = [0]

        def take():
            with self.lock:
                n = sent[0]
                if times is None and n >= min_iterations and \
                        time.perf_counter() >= deadline:
                    return None, None
                if times is not None and n >= len(times):
                    return None, None
                sent[0] += 1
                self.next += 1
                return self.next - 1, None if times is None else \
                    start + float(times[n])

        def caller(j):
            while True:
                k, arrived = take()
                if k is None:
                    return
                if arrived is not None:
                    time.sleep(max(0.0, arrived - time.perf_counter()))
                self.request(codecs[j], k, phase,
                             None if stages is None else stages[j],
                             annotate, arrived)

        if len(codecs) == 1:
            caller(0)
            return
        threads = [threading.Thread(target=caller, args=(j,))
                   for j in range(len(codecs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def _memory_peak(devices) -> int:
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)


def _card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process holds, each compared
    whole: ``lzw_tpu_torch`` is not ``lzw_tpu``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices,
             entries: list[dict], t0: float, make_codec=make_program_codec,
             workers: int = WORKERS, min_iterations: int = 1,
             warm: bool = True, err=sys.stderr) -> tuple[dict, dict]:
    """One run; returns (the result line, the numbers compared)."""
    import torch

    wire = Wire.from_dict(cell.config["wire"])
    size = block_size(cell.config)
    plane = load_plane(ROOT / cell.config["corpus"])
    inputs = generator.make_inputs(cell.mix, plane, size, seed)
    callers = int(cell.mix["callers"])
    want = None
    if generator.needs_containers(cell.mix):
        want = _expected(inputs, wire, size, workers,
                         entry(cell.config))
    codecs = [make_codec(cell.config, devices) for _ in range(callers)]
    tally = check.Tally(len(inputs))
    calls: list[Call] = []
    window = _Window(cell.mix, inputs, tally, calls, seed,
                     None if want is None else [w.container for w in want],
                     err)
    if warm:
        window.warm(codecs)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    profile = None
    if not trace:
        window.run(codecs, seconds, "window", min_iterations)
    else:
        stages = [{} for _ in range(callers)]
        staged = [make_codec(cell.config, devices, st) for st in stages]
        window.run(staged, seconds / 2, "staged", min_iterations, stages)
        profile = _profiled(window, codecs, seconds / 2, min_iterations,
                            any(d.type == "cuda" for d in devices))
        del staged
    window_s = time.perf_counter() - t_start
    peak = _memory_peak(devices)
    del codecs, window
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if want is None:
        want = _expected(inputs, wire, size, workers,
                         entry(cell.config))
    numbers = tally.numbers(want)
    reference_s = time.perf_counter() - t_ref
    run = Run(cell, seed, trace, setup_s, calls, want, profile)
    metrics = {}
    for m in entries:
        value = load_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = any(d.type == "cuda" for d in devices)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda
              else "cpu",
              "count": len({str(d) for d in devices}),
              "memory_peak_bytes": peak}
    result = {
        "correct": all(numbers[k] <= check.LIMITS[k] for k in numbers)
        and bool(calls),
        "attempted": len(calls) + tally.calls_failed,
        "failed": tally.calls_failed + tally.calls_wrong,
        "metrics": metrics,
        "device": device,
    }
    if profile is not None:
        device["busy_s"] = profile["all"]["busy_s"]
        device["window_s"] = profile["all"]["wall_s"]
        kernels, gaps = {}, {}
        for op in OPS:
            p = profile[op]
            for name, s in p["kernels"].items():
                kernels[name] = kernels.get(name, 0.0) + s
            for name, s in p["gaps"].items():
                gaps[f"{op}: {name}"] = gaps.get(f"{op}: {name}", 0.0) + s
        result["breakdown"] = {"device_ops": tracing.top(kernels),
                               "idle_gaps": tracing.top(gaps)}
    result["calls"] = {op: len(run.calls_of(op)) for op in OPS}
    result["call_ms"] = {op: _spread_ms(run.calls_of(op)) for op in OPS}
    result["window_s"] = window_s
    result["reference_s"] = reference_s
    result["card"] = _card_line() if cuda else "cpu"
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result, numbers


def _expected(inputs, wire, block_size: int | None, workers: int,
              kind: str = "container"):
    """The reference's containers (a facade's streams, ``kind``
    ``"facade"``), on ``workers`` processes that import nothing but NumPy
    and the reference."""
    def want(ex=None, shards=1):
        if kind == "facade":
            return check.expected_streams(inputs, wire, ex)
        return check.expected(inputs, wire, block_size, ex, shards)

    if workers <= 1:
        return want()
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return want(ex, workers)


def _children() -> list[int]:
    """The processes whose parent is this one, from ``/proc``."""
    me, kids = os.getpid(), []
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rfind(")") + 2:].split()[1]) == me:
            kids.append(int(entry.name))
    return kids


def end_children(err=sys.stderr) -> None:
    """End every process this one started and wait for each.  A ``spawn``
    pool leaves multiprocessing's resource tracker behind it: a process
    that ignores SIGTERM and ends only once its pipe is closed.  The
    pool's semaphores are collected first, so that none starts it again
    when freed; then its pipe is closed and it is waited for.  Anything
    still running after that is killed, waited for and named on ``err``."""
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()
    for pid in _children():
        print(f"portbench: a process {pid} was still running; killed",
              file=err)
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


def _spread_ms(calls: list[Call]) -> dict:
    """The fastest, median and slowest call, and the first one, in ms."""
    ms = sorted(1e3 * c.seconds for c in calls)
    if not ms:
        return {}
    return {"min": ms[0], "median": ms[len(ms) // 2], "max": ms[-1],
            "first": 1e3 * calls[0].seconds}


def _profiled(window: _Window, codecs, seconds: float, min_iterations: int,
              cuda: bool) -> dict:
    """The second half of a traced window under ``torch.profiler``, and
    its Chrome trace reduced (:func:`portbench.tracing.summarize`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = pathlib.Path(tmp) / "window.pt.trace.json"
        # acc_events: one profiling cycle, so nothing is dropped (and the
        # profiler does not warn that it could be).
        with profile(activities=activities, acc_events=True) as prof:
            window.run(codecs, seconds, "profiled", min_iterations,
                       annotate=record_function)
        prof.export_chrome_trace(str(path))
        del prof
        return tracing.summarize(tracing.load(path), OPS)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    bench = load_benchmark()
    cell = load_cell(bench, args.workload)
    entries = metric_entries(bench, cell.name, bool(args.trace))
    try:
        import torch
    except ImportError as exc:
        print(f"portbench: PyTorch is missing ({exc})", file=sys.stderr)
        return 2
    try:
        import lzw_tpu_torch  # noqa: F401  the program under test
    except ImportError as exc:
        print(f"portbench: the program lzw_tpu_torch is missing ({exc})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}; no CPU run",
              file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    try:
        result, numbers = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), devices, entries, t0)
    finally:
        end_children()
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, value in numbers.items():
        print(f"{name} {value} limit {check.LIMITS[name]}", file=sys.stderr)
    return 0
