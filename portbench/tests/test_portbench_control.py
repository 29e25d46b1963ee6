"""The comparison that decides ``correct`` comes out false where it must.

Each test skips the harness's look for a card and drives the rest of a
run (:func:`portbench.harness.run_cell` on the CPU, at a size a test can
hold), with the codec in the program's place:

* the reference, sound: ``correct`` true;
* the program on the CPU (its kernels' plain versions): true;
* the control, the reference with each block's (a facade's stream's)
  last code left out: false;
* the program with one fault planted under it, once for each fault the
  cells can have: a call that returns its input unchanged, half of the
  blocks left out, one byte altered where it is produced (one chip, so
  there is no exchange between chips to leave out): false.
"""

from __future__ import annotations

import io
import json
import struct
import time

import pytest
import torch

from portbench import generator, harness
from portbench.control import ReferenceCodec

# Every pair of a configuration and a mix the benchmark's files hold: its
# cells, and the bulk mix a later cell can take as data.
CELLS = {"gif7-image-bulk": ("gif7-image", "bulk"),
         "fixed12-image-bulk": ("fixed12-image", "bulk"),
         "gif7-image-one": ("gif7-image", "one-image"),
         "fixed12-image-one": ("fixed12-image", "one-image"),
         "gif7-image-facade": ("gif7-facade", "one-image")}


def _cell(name: str) -> harness.Cell:
    """The configuration and mix as their files give them, cut to a
    test's size: 4 KiB blocks (a container's), a few blocks' bytes a
    call."""
    config, traffic = CELLS[name]
    cell = harness.Cell(
        name, 1,
        json.loads((harness.HERE / "configs" / f"{config}.json").read_text()),
        generator.load_mix(harness.HERE / "traffic" / f"{traffic}.json"))
    if harness.entry(cell.config) == "container":
        cell.config["block_size"] = 4096
    cell.mix["bytes_per_call"] = 3 * 4096 if cell.mix["window"] == \
        "block" else 3 * 4096 + 1000
    cell.mix["inputs"] = 2
    return cell


def _run(cell, make_codec, seed=2**31 + 3):
    result, numbers = harness.run_cell(
        cell, seed, 0.0, False, [torch.device("cpu")],
        harness.metric_entries(harness.load_benchmark(), "gif7-image-one",
                               False),
        time.perf_counter(), make_codec=make_codec, workers=1,
        min_iterations=2, err=io.StringIO())
    return result, numbers


def _reference(flush=True):
    def make(config, devices, stage_times=None):
        return ReferenceCodec(config, flush)
    return make


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_in_the_programs_place_is_correct(name):
    result, numbers = _run(_cell(name), _reference())
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ("gif7-image-one", "fixed12-image-bulk",
                                  "gif7-image-facade"))
def test_the_program_on_the_cpu_is_correct(name):
    result, numbers = _run(_cell(name), harness.make_program_codec)
    assert result["correct"], numbers
    assert numbers == {"container_bytes_wrong": 0, "output_bytes_wrong": 0,
                       "calls_failed": 0}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result, numbers = _run(_cell(name), _reference(flush=False))
    assert not result["correct"]
    assert numbers["container_bytes_wrong"] > 0
    assert numbers["output_bytes_wrong"] > 0


def _frame(data: bytes):
    """(header, lengths, payloads) of a container."""
    n = struct.unpack_from("<I", data, 16)[0]
    lengths = struct.unpack_from(f"<{n}I", data, 32)
    at, payloads = 32 + 4 * n, []
    for k in lengths:
        payloads.append(data[at:at + k])
        at += k
    return data[:32], payloads


def _half(data: bytes) -> bytes:
    """Half of a container's blocks, or half of a facade's stream."""
    if data[:4] != b"LZWT":
        return data[: len(data) // 2]
    head, payloads = _frame(data)
    keep = payloads[: len(payloads) // 2]
    head = head[:16] + struct.pack("<I", len(keep)) + head[20:]
    return head + struct.pack(f"<{len(keep)}I", *map(len, keep)) + b"".join(
        keep)


def _flip(data: bytes, at: int) -> bytes:
    return data[:at] + bytes([data[at] ^ 0x10]) + data[at + 1:]


FAULTS = {
    # A call that returns its state unchanged.
    "encode returns its input": ("encode", lambda c, x: x),
    "decode returns its input": ("decode", lambda y, c: c),
    # Half of the batch left out.
    "encode leaves out half the blocks": ("encode", lambda c, x: _half(c)),
    "decode leaves out half the bytes": ("decode",
                                         lambda y, c: y[: len(y) // 2]),
    # One answer altered where it is produced.
    "encode alters a payload byte": ("encode", lambda c, x: _flip(c, len(c) - 5)),
    "decode alters an output byte": ("decode", lambda y, c: _flip(y, 7)),
}


class _Faulty:
    def __init__(self, inner, op, fault):
        self.inner, self.op, self.fault = inner, op, fault

    def encode(self, x):
        c = self.inner.encode(x)
        return self.fault(c, x) if self.op == "encode" else c

    def decode(self, c):
        y = self.inner.decode(c)
        return self.fault(y, c) if self.op == "decode" else y


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ("gif7-image-bulk", "fixed12-image-one",
                                  "gif7-image-facade"))
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    op, fn = FAULTS[fault]

    def make(config, devices, stage_times=None):
        return _Faulty(ReferenceCodec(config), op, fn)

    result, numbers = _run(_cell(name), make)
    assert not result["correct"], numbers
    assert result["failed"] > 0


def test_a_fault_planted_in_the_program_is_not_correct():
    def make(config, devices, stage_times=None):
        return _Faulty(harness.make_program_codec(config, devices), "encode",
                       FAULTS["encode alters a payload byte"][1])

    result, numbers = _run(_cell("gif7-image-one"), make)
    assert not result["correct"]
    assert numbers["container_bytes_wrong"] >= 1


def test_a_fault_planted_in_the_facade_is_not_correct():
    def make(config, devices, stage_times=None):
        return _Faulty(harness.make_program_codec(config, devices), "decode",
                       FAULTS["decode alters an output byte"][1])

    result, numbers = _run(_cell("gif7-image-facade"), make)
    assert not result["correct"]
    assert numbers["output_bytes_wrong"] >= 1


def test_a_call_that_raises_is_counted():
    class Raising:
        def __init__(self, config):
            self.inner = ReferenceCodec(config)
            self.n = 0

        def encode(self, x):
            self.n += 1
            if self.n == 4:
                raise RuntimeError("planted")
            return self.inner.encode(x)

        def decode(self, c):
            return self.inner.decode(c)

    result, numbers = _run(_cell("gif7-image-one"),
                           lambda config, devices, st=None: Raising(config))
    assert numbers["calls_failed"] == 1
    assert not result["correct"]
