"""Run metrics and profiling helpers.

The counterpart of the JAX package's ``lzw_tpu/utils/profiling.py``, with
the same names.  The reference's observability is offline-only: criterion
wall-clock reports and dhat heap profiles (``SURVEY.md`` §5).  Here: a
per-run metrics record (bytes, ratio, throughput, block counts), a
``torch.profiler`` trace of a region (the counterpart of a
``jax.profiler`` capture) and a report of the CUDA devices' memory (the
dhat heap-stats analog).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import socket
import time

import torch

from lzw_tpu_torch.parallel.block import default_devices

__all__ = ["RunMetrics", "Timer", "trace", "device_memory_report"]


@dataclasses.dataclass
class RunMetrics:
    """Lightweight metrics for one codec run."""

    operation: str  # "encode" | "decode"
    flavor: str
    bytes_in: int
    bytes_out: int
    seconds: float
    n_blocks: int = 1
    n_devices: int = 1

    @property
    def ratio(self) -> float:
        if self.operation == "encode":
            return self.bytes_out / max(self.bytes_in, 1)
        return self.bytes_in / max(self.bytes_out, 1)

    @property
    def throughput_bps(self) -> float:
        """Uncompressed bytes/s (the reference's definition, README.md:16-19)."""
        plain = self.bytes_in if self.operation == "encode" else self.bytes_out
        return plain / max(self.seconds, 1e-12)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ratio"] = round(self.ratio, 4)
        d["throughput_MiB_s"] = round(self.throughput_bps / 2**20, 2)
        return json.dumps(d)


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.seconds``.

    The codec's calls return host bytes, so they end synchronised with the
    card.  A block that times a kernel wrapper on device tensors must end
    in ``torch.cuda.synchronize()``: the wrapper returns when the launch is
    queued, not when the kernel is done.
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike):
    """Capture a ``torch.profiler`` trace around a region.

    Records CPU activity, and CUDA activity (every kernel and copy on the
    card, the port's ctypes-loaded kernels among them) when the process
    has a CUDA device.  On exit, also when the region raised, the card is
    synchronised and a Chrome/Perfetto trace
    ``<host>_<pid>.<ns>.pt.trace.json`` is written into ``log_dir``.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out_dir = pathlib.Path(log_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(str(out_dir / f"{name}.pt.trace.json"))


def device_memory_report() -> dict:
    """Per-device memory statistics (the dhat heap-stats analog).

    One entry per visible CUDA device (:func:`default_devices`), keyed
    ``str(device)``: ``bytes_in_use`` and ``peak_bytes_in_use`` are the
    bytes of live tensors in PyTorch's caching allocator now and at their
    peak (since the process started or since
    ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` the device's
    total memory.  No kernel of the port calls ``cudaMalloc``: all of the
    codec's device memory comes through the caching allocator, so these
    counts see all of it.  The pinned host buffers of a device-route
    decode are host memory and are not counted.  Without a CUDA device the
    report has one ``"cpu"`` entry whose fields are None, as the JAX report
    gives for a device without statistics.
    """
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                        "bytes_limit": None}}
    report = {}
    for d in default_devices():
        stats = torch.cuda.memory_stats(d)
        report[str(d)] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(d)[1],
        }
    return report
