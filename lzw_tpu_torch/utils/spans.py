"""The codecs' spans and counters, on ``torch.profiler``'s clock.

A span names a stretch of a codec call: ``span(name, args)`` is a context
manager that, while a ``torch.profiler`` records, opens a host range
``"lzw." + name`` in the profiler's trace, beside (and on the same clock
as) the CUDA kernels and copies it records; its ``args``, ints, are the
range's inputs, which the trace shows where the profiler records shapes
(``record_shapes=True``, under ``"Concrete Inputs"``).  With no profiler
it returns one shared no-op context: a call pays one flag read a span.

The spans of a codec call (none per block, candidate or byte):

* ``lzw.encode`` / ``lzw.decode`` around a public call of
  :class:`~lzw_tpu_torch.parallel.block.BlockParallelCodec` or of a
  ``"torch"`` facade (:func:`call`): args (call id, blocks, input bytes,
  route).  The id comes from a counter of the codec; the route is an index
  of :data:`ROUTES`, the route a decode's strict blocks take (-1 on
  encode).  A container that turns out non-strict goes on under the same
  span, through ``lzw.dec_native`` or ``lzw.dec_parse_epochs``.
* ``lzw.range`` around each range's work in a step of the row split
  that runs several ranges, each on a worker thread: args (call id,
  device index, first block, end block); the id joins the worker's spans
  to their call.  (A step of one range runs in the calling thread, inside
  its call's span.)  A profiler records threads other than the one that
  started it only with ``experimental_config=
  torch.profiler._ExperimentalConfig(profile_all_threads=True)``.
* stage spans: every other name, each a step of a call.  The stages that
  :func:`staged` also times (``enc_host_prep``, ``enc_h2d``, ...) and
  host steps that only a profiler sees (``enc_errors``, ``enc_payloads``,
  ``enc_verify``, ``pack_frame``, ``parse_frame``, ``dec_errors``,
  ``dec_strict``, ``dec_native``, ``dec_join``, and inside
  ``dec_count_recovery`` ``recover.candidates``, ``recover.strict`` and
  ``recover.schedule_rows``).

Counters (:func:`count`) tick in :data:`COUNTS` with or without a profiler.
While a profiler records, :data:`PROFILED` also gathers each counter's
ticks and each span's seconds (host clock, taken inside the range), so
that a reader with no trace at hand gets what the profiled stretch held.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "lzw."
# The routes a decode's strict blocks take: the pass-2 kernel, the native
# runtime's apply_words, and blocks past MAX_BLOCK.
ROUTES = ("device", "host", "big")
# The shared no-op span.
OFF = contextlib.nullcontext()
_CALL = contextvars.ContextVar("lzw_call", default=-1)


class Tally:
    """Numbers by name, added to under one lock (the codecs' ranges run on
    several threads); :meth:`snapshot` copies them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


# Every counter's ticks: ``recover.blocks`` (the rows count recovery was
# given), ``recover.reads`` (the rows its candidate loop read),
# ``encode.blocks`` / ``decode.blocks`` (the blocks of each public call of
# the container codec, once a call whatever its ranges);
# ``stream_encode.steps`` / ``.rounds`` / ``.bytes`` (the stream encode
# kernel's phrases and table loads and the stream's bytes, ticked only
# while a profiler records: reading them costs a copy).
COUNTS = Tally()
# While a profiler records: each counter's ticks, and each span's seconds
# under its trace name (``"lzw.dec_count_recovery"``).
PROFILED = Tally()


def recording() -> bool:
    """Whether a ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


class _Span:
    """A stage span: a host range opened by ``_RecordFunctionFast``, which
    costs about a quarter of ``torch.profiler.record_function``."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def _open(self):
        rng = torch._C._profiler._RecordFunctionFast(self.name)
        rng.__enter__()
        return rng

    def _close(self, rng) -> None:
        rng.__exit__(None, None, None)

    def __enter__(self):
        self.range = self._open()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self._close(self.range)
        PROFILED.add(self.name, dt)
        return False


class _ArgSpan(_Span):
    """A span with args: ``record_function`` takes its args as a string,
    which never reaches the trace, and ``_RecordFunctionFast`` loses its
    inputs where the profiler records every thread; ints given through
    ``_record_function_with_args_enter`` reach the trace in both."""

    __slots__ = ("args",)

    def __init__(self, name: str, args: tuple):
        super().__init__(name)
        self.args = args

    def _open(self):
        return torch.autograd._record_function_with_args_enter(self.name,
                                                               *self.args)

    def _close(self, handle) -> None:
        torch.autograd._record_function_with_args_exit(handle)


def span(name: str, args: tuple = ()):
    """The span ``"lzw." + name`` while a profiler records, else
    :data:`OFF`."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _ArgSpan(PREFIX + name, args) if args else _Span(PREFIX + name)


class _Call(_ArgSpan):
    __slots__ = ("token",)

    def __enter__(self):
        self.token = _CALL.set(self.args[0])
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _CALL.reset(self.token)
        return False


def call(op: str, call_id: int, blocks: int, nbytes: int, route: int = -1):
    """The span of one public call (``op`` "encode" or "decode"); inside
    it :func:`current_call` is ``call_id``.  Open it only while
    :func:`recording`."""
    return _Call(PREFIX + op, (call_id, blocks, nbytes, route))


def current_call() -> int:
    """The id of the call whose span this thread is in, else -1."""
    return _CALL.get()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and, while a profiler records,
    to its entry in :data:`PROFILED`)."""
    COUNTS.add(name, n)
    if _profiler._is_profiler_enabled:
        PROFILED.add(name, n)


def staged(stage_times: dict | None, lock: threading.Lock, devices,
           key: str = ""):
    """A codec's stage hook: ``stage(name)`` is :func:`span`, and with
    ``stage_times`` given also a timer that synchronises ``devices``
    around its body and adds the seconds to ``stage_times[name + key]``
    under ``lock``."""
    if stage_times is None:
        return span

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def stage(name: str):
        with span(name):
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            dt = time.perf_counter() - t0
        with lock:
            stage_times[name + key] = stage_times.get(name + key, 0.0) + dt

    return stage
