"""The comparison that decides ``correct``.

Every call of the window is held to the reference, byte for byte:

* an encode's container against the reference's container of the same
  input (:mod:`portbench.reference`): header, length table and every
  block's payload; for a configuration whose entry is the single-stream
  facade (``"entry": "facade"``), its stream against the reference's
  stream of the input (:func:`portbench.reference.lzw.encode_stream`,
  salzweg's bytes);
* a decode's bytes against the input the benchmark made, which the
  decode of a sound container returns.

A decode is compared as it returns, outside its timing.  An encode's
container is kept, one copy of each distinct container an input gave,
and the kept ones are compared once the window has closed, when the
reference has run: so every call is compared, and the window holds no
reference work.

The numbers compared, each with its limit (exact comparisons, limit 0):

* ``container_bytes_wrong``: over every encode call, the bytes of its
  container (a facade's: of its stream) that differ from the
  reference's, and the difference in length;
* ``output_bytes_wrong``: the same over every decode call, against the
  input;
* ``calls_failed``: calls that raised.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import container as ref_container
from portbench.reference import lzw
from portbench.reference.lzw import Wire

LIMITS = {"container_bytes_wrong": 0, "output_bytes_wrong": 0,
          "calls_failed": 0}
# Distinct containers kept for one input; past it a call's container is
# compared with the first kept and counts wrong where it differs.
MAX_VARIANTS = 4


def bytes_wrong(got: bytes, want: bytes) -> int:
    """The positions where ``got`` and ``want`` differ, and their
    difference in length."""
    if got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


@dataclasses.dataclass
class Expected:
    """The reference's container of one input and its sizes; a facade's
    is one stream, its only block."""

    container: bytes
    payload_bytes: int
    codes: int
    blocks: int


def expected_streams(inputs, wire: Wire, executor=None) -> list[Expected]:
    """A facade's: the reference's one stream of each input, salzweg's
    bytes, one input a job."""
    datas = [x.data for x in inputs]
    return list((map if executor is None else executor.map)(
        _stream, datas, [wire] * len(datas)))


def _stream(data: bytes, wire: Wire) -> Expected:
    codes = lzw.parse_stream(data, wire)
    stream = lzw.pack_stream(codes, wire)
    return Expected(stream, len(stream), len(codes), 1)


def expected(inputs, wire: Wire, block_size: int, executor=None,
             shards: int = 1) -> list[Expected]:
    """The reference's container of each input.  Inputs that share their
    block rows (``"block"`` windows) are parsed once, row by row, and each
    container takes the rows' payloads in its own order."""
    out: list[Expected | None] = [None] * len(inputs)
    shared = [i for i, x in enumerate(inputs) if x.rows is not None]
    plain = [i for i, x in enumerate(inputs) if x.rows is None]
    if shared:
        rows = inputs[shared[0]].rows
        if any(inputs[i].rows is not rows for i in shared):
            raise ValueError("inputs with rows of their own")
        (payload, lengths, counts), = ref_container.encode_many(
            [rows.reshape(-1)], wire, block_size, executor=executor,
            shards=shards)
        ends = np.cumsum(lengths)
        for i in shared:
            order = inputs[i].order
            pieces = [payload[e - n:e] for e, n in zip(ends[order],
                                                      lengths[order])]
            out[i] = _expected(wire, block_size, len(inputs[i].data),
                               np.concatenate(pieces), lengths[order],
                               counts[order])
    for i, parts in zip(plain, ref_container.encode_many(
            [inputs[i].data for i in plain], wire, block_size,
            executor=executor, shards=shards)):
        out[i] = _expected(wire, block_size, len(inputs[i].data), *parts)
    return out


def _expected(wire, block_size, orig_size, payload, lengths, counts):
    return Expected(
        ref_container.assemble(wire, block_size, orig_size, payload, lengths),
        int(lengths.sum()), int(counts.sum()), len(lengths))


class Tally:
    """What the window's calls gave, as they return."""

    def __init__(self, n_inputs: int):
        self.containers: list[list[list]] = [[] for _ in range(n_inputs)]
        self.output_bytes_wrong = 0
        self.calls_failed = 0
        self.calls_wrong = 0
        self.overflow_wrong = 0

    def encoded(self, i: int, got: bytes) -> None:
        kept = self.containers[i]
        for entry in kept:
            if entry[0] == got:
                entry[1] += 1
                return
        if len(kept) < MAX_VARIANTS:
            kept.append([got, 1])
            return
        # Too many distinct answers for one input: at least all but one
        # of them are wrong; count this one against the first kept.
        self.overflow_wrong += max(bytes_wrong(got, kept[0][0]), 1)
        self.calls_wrong += 1

    def decoded(self, got: bytes, want: bytes) -> None:
        wrong = bytes_wrong(got, want)
        self.output_bytes_wrong += wrong
        self.calls_wrong += wrong > 0

    def failed(self) -> None:
        self.calls_failed += 1

    def numbers(self, want: list[Expected]) -> dict[str, int]:
        """The numbers compared, once the reference has run."""
        container_wrong = self.overflow_wrong
        for kept, exp in zip(self.containers, want):
            for got, calls in kept:
                wrong = bytes_wrong(got, exp.container)
                container_wrong += calls * wrong
                self.calls_wrong += calls if wrong else 0
        return {"container_bytes_wrong": container_wrong,
                "output_bytes_wrong": self.output_bytes_wrong,
                "calls_failed": self.calls_failed}
