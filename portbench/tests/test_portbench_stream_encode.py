"""The readers of the stream encode kernel's counters
(``stream_encode.bytes_per_step``, ``stream_encode.rounds_per_step``) on a
tally of their own, and through one profiled stretch of the ``"torch"``
facade on the CPU, where the plain version counts its phrases and no
rounds."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from portbench import generator, harness

from lzw_tpu_torch.utils import spans as program_spans

NAMES = ("stream_encode.bytes_per_step", "stream_encode.rounds_per_step")


@pytest.fixture
def tally(monkeypatch):
    fresh = program_spans.Tally()
    monkeypatch.setattr(program_spans, "PROFILED", fresh)
    return fresh


def _read(name, run):
    return harness.load_reader(name).read(run)


def _run(calls=()):
    cell = harness.Cell("c", 1, {}, {})
    return harness.Run(cell, 0, True, 1.0, list(calls), [], None)


def test_counter_ratios(tally):
    # A program's tally with the counters: bytes and rounds over steps.
    tally.add("lzw.enc_kernel", 0.01)
    for name, n in (("stream_encode.bytes", 700416),
                    ("stream_encode.steps", 181533),
                    ("stream_encode.rounds", 228838)):
        tally.add(name, n)
    assert _read(NAMES[0], _run()) == pytest.approx(700416 / 181533)
    assert _read(NAMES[1], _run()) == pytest.approx(228838 / 181533)


def test_nothing_to_read_without_the_counters(tally, monkeypatch):
    # A program whose kernel counts nothing (spans but no counters), and a
    # program without the spans module: nothing, and no exception.
    assert [_read(n, _run()) for n in NAMES] == [None, None]
    tally.add("lzw.enc_kernel", 0.01)
    assert [_read(n, _run()) for n in NAMES] == [None, None]
    monkeypatch.setitem(sys.modules, "lzw_tpu_torch.utils.spans", None)
    monkeypatch.delattr("lzw_tpu_torch.utils.spans")
    assert [_read(n, _run()) for n in NAMES] == [None, None]


def test_the_facade_cell_lists_them():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.metric_entries(bench, w["name"],
                                                           True)}
        assert set(NAMES) <= names if w["name"] == "gif7-image-facade" \
            else not set(NAMES) & names


def test_a_profiled_stretch_of_the_facade(tally):
    cfg = json.loads((harness.HERE / "configs" / "gif7-facade.json")
                     .read_text())
    mix = {"ops": ["encode", "decode"], "loop": "closed", "callers": 1}
    data = bytes(range(64)) * 40
    codecs = [harness.make_program_codec(cfg, [torch.device("cpu")])]
    calls = []
    window = harness._Window(mix, [generator.Input(data)], _Tally(), calls,
                             1)
    window.warm(codecs)
    # Nothing ticks outside the profiled stretch.
    assert "stream_encode.steps" not in program_spans.PROFILED.snapshot()
    profile = harness._profiled(window, codecs, 0.0, 2, False)
    run = _run(calls)
    run = harness.Run(run.cell, 0, True, 1.0, calls, [], profile)
    got = {n: _read(n, run) for n in NAMES}
    # The steps are the phrases: 64 distinct bytes, then longer phrases;
    # the plain version makes no rounds of a chain warp.
    assert 1.0 <= got[NAMES[0]] <= len(data) / 64
    assert got[NAMES[1]] == 0.0


class _Tally:
    def encoded(self, i, got):
        pass

    def decoded(self, got, want):
        assert got == want
