"""The readers of the program's spans and counters (``portbench/spans.py``
and its six metrics) on a synthetic trace, and through one profiled
stretch of the program's codec on the CPU."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from portbench import generator, harness, readers, spans, tracing

from lzw_tpu_torch.utils import spans as program_spans

NEW = ("span.enc_host_ms", "span.dec_host_ms", "span.count_recovery_ms",
       "device.idle_unspanned_pct.encode", "device.idle_unspanned_pct.decode",
       "schedule.recover_reads_per_block")


def _run_of(calls, profile=None):
    cell = harness.Cell("c", 1, {}, {})
    return harness.Run(cell, 0, profile is not None, 1.0, calls, [], profile)


def _trace(tmp_path):
    """The calls of the harness's synthetic trace, now with the program's
    spans: an encode over [0, 100] us (its span [2, 98]; device work [10,
    50] and [90, 95]; stage spans [2, 10] and [60, 80]) and a decode over
    [200, 300] (its span [201, 299]; a kernel [250, 260]; the host in
    aten::copy_ [205, 240] inside a stage span [204, 241])."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    ev = [
        x("user_annotation", "portbench.encode", 0, 100),
        x("user_annotation", "lzw.encode", 2, 96),
        x("cpu_op", "lzw.enc_host_prep", 2, 8),
        x("kernel", "void encode_parse_kernel<1>()", 10, 20),
        x("kernel", "pack", 20, 30),
        x("cpu_op", "lzw.enc_payloads", 60, 20),
        x("gpu_memcpy", "Memcpy DtoH", 90, 5),
        x("user_annotation", "portbench.decode", 200, 100),
        x("user_annotation", "lzw.decode", 201, 98),
        x("cpu_op", "lzw.dec_host_prep", 204, 37),
        x("cpu_op", "aten::copy_", 205, 35),
        x("kernel", "decode_pass1_kernel", 250, 10),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.summarize(tracing.load(path), harness.OPS)


@pytest.fixture
def tally(monkeypatch):
    fresh = program_spans.Tally()
    monkeypatch.setattr(program_spans, "PROFILED", fresh)
    return fresh


def _read(name, run):
    return harness.load_reader(name).read(run)


def test_span_readers_on_a_synthetic_trace(tmp_path, tally):
    profile = _trace(tmp_path)
    calls = [harness.Call(op, "profiled", 0, 1, 1e-4)
             for op in ("encode", "encode", "decode")]
    for name, seconds in (("lzw.enc_host_prep", 0.002),
                          ("lzw.enc_payloads", 0.001),
                          ("lzw.enc_verify", 0.003), ("lzw.pack_frame", 0.0),
                          ("lzw.enc_kernel", 0.5), ("lzw.parse_frame", 0.001),
                          ("lzw.dec_host_prep", 0.002),
                          ("lzw.dec_count_recovery", 0.004),
                          ("recover.blocks", 11), ("recover.reads", 242)):
        tally.add(name, seconds)
    run = _run_of(calls, profile)
    # Two encodes: (2 + 1 + 3) ms of host spans over two calls.
    assert _read("span.enc_host_ms", run) == pytest.approx(3.0)
    assert _read("span.dec_host_ms", run) == pytest.approx(3.0)
    assert _read("span.count_recovery_ms", run) == pytest.approx(4.0)
    # Encode idle [0, 10] (under enc_host_prep), [50, 90] (enc_payloads),
    # [95, 100] (under the call's span alone): 5 of 55 us unspanned.
    assert _read("device.idle_unspanned_pct.encode", run) == \
        pytest.approx(100 * 5 / 55)
    # Decode idle [200, 250] (aten::copy_, inside a stage span) and [260,
    # 300] (the call's span alone): 40 of 90 us.
    assert _read("device.idle_unspanned_pct.decode", run) == \
        pytest.approx(100 * 40 / 90)
    assert _read("schedule.recover_reads_per_block", run) == \
        pytest.approx(22.0)
    # The harness's readers read what they read before the spans.
    assert readers.idle_pct(run, "encode") == pytest.approx(55.0)
    assert readers.idle_pct(run, "decode") == pytest.approx(90.0)
    assert profile["encode"]["busy_s"] == pytest.approx(45e-6)
    assert profile["decode"]["gaps"]["aten::copy_"] == pytest.approx(50e-6)
    assert profile["decode"]["gaps"]["lzw.decode"] == pytest.approx(40e-6)


def test_nothing_to_read_without_the_programs_spans(tmp_path, tally,
                                                    monkeypatch):
    profile = _trace(tmp_path)
    calls = [harness.Call(op, "profiled", 0, 1, 1e-4)
             for op in harness.OPS]
    run = _run_of(calls, profile)
    # A program that recorded no span (the tally is empty) ...
    assert [_read(n, run) for n in NEW] == [None] * len(NEW)
    tally.add("lzw.enc_host_prep", 0.001)
    # ... a flavor without count recovery, an untraced run ...
    assert _read("span.count_recovery_ms", run) is None
    assert _read("schedule.recover_reads_per_block", run) is None
    assert _read("span.enc_host_ms", _run_of(calls)) is None
    assert _read("span.enc_host_ms", run) == pytest.approx(1.0)
    # ... and a program without the module give nothing, and raise not.
    monkeypatch.setitem(sys.modules, "lzw_tpu_torch.utils.spans", None)
    monkeypatch.delattr("lzw_tpu_torch.utils.spans")
    assert spans.profiled() is None
    assert [_read(n, run) for n in NEW] == [None] * len(NEW)


def test_cells_list_the_new_metrics():
    bench = harness.load_benchmark()
    for w in ("gif7-image-one", "fixed12-image-one"):
        names = {m["name"] for m in harness.metric_entries(bench, w, True)}
        variable = w.startswith("gif7")
        assert {n for n in NEW if n in names} == {
            n for n in NEW if variable or "recover" not in n}
    # The facade opens the host and pack spans but recovers no counts.
    names = {m["name"] for m in harness.metric_entries(
        bench, "gif7-image-facade", True)}
    assert {n for n in NEW if n in names} == {
        n for n in NEW if "recover" not in n}
    for w in ("gif7-image-one", "fixed12-image-one", "gif7-image-facade"):
        assert "span.pack_ms" in {
            m["name"] for m in harness.metric_entries(bench, w, True)}


def test_a_profiled_stretch_of_the_program(tally):
    """The harness's profiled half over the program's codec on the CPU, at
    a test's size: every new metric reads something."""
    cfg = {"wire": {"flavor": "variable", "code_size": 7},
           "block_size": 512, "codec": {"verify": True}}
    mix = {"ops": ["encode", "decode"], "loop": "closed", "callers": 1}
    data = bytes(range(64)) * 40
    codecs = [harness.make_program_codec(cfg, [torch.device("cpu")])]
    calls = []
    window = harness._Window(mix, [generator.Input(data)], _Tally(), calls,
                             1)
    window.warm(codecs)
    profile = harness._profiled(window, codecs, 0.0, 2, False)
    run = _run_of(calls, profile)
    assert [c.phase for c in calls] == ["profiled"] * 4
    got = {n: _read(n, run) for n in NEW + ("span.pack_ms",)}
    assert all(v is not None for v in got.values()), got
    assert 0 <= got["device.idle_unspanned_pct.decode"] <= 100
    # Five 512-byte blocks of one length: each candidate's EOI read reads
    # all five rows.
    assert got["schedule.recover_reads_per_block"] >= 1.0


def test_the_pack_span(tmp_path, tally):
    profile = _trace(tmp_path)
    calls = [harness.Call(op, "profiled", 0, 1, 1e-4)
             for op in ("encode", "encode", "decode")]
    run = _run_of(calls, profile)
    assert _read("span.pack_ms", run) is None
    tally.add("lzw.enc_pack", 0.003)
    # 3 ms over two encodes.
    assert _read("span.pack_ms", run) == pytest.approx(1.5)
    assert _read("span.pack_ms", _run_of(calls)) is None


def test_a_profiled_stretch_of_the_facade(tally):
    """The profiled half over the ``"torch"`` facade on the CPU, at a
    test's size: its host, pack and idle readers read something."""
    cfg = json.loads((harness.HERE / "configs" / "gif7-facade.json")
                     .read_text())
    mix = {"ops": ["encode", "decode"], "loop": "closed", "callers": 1}
    codecs = [harness.make_program_codec(cfg, [torch.device("cpu")])]
    calls = []
    window = harness._Window(mix, [generator.Input(bytes(range(64)) * 40)],
                             _Tally(), calls, 1)
    window.warm(codecs)
    profile = harness._profiled(window, codecs, 0.0, 2, False)
    run = _run_of(calls, profile)
    for name in ("span.pack_ms", "span.enc_host_ms", "span.dec_host_ms"):
        assert _read(name, run) > 0
    for name in ("device.idle_unspanned_pct.encode",
                 "device.idle_unspanned_pct.decode"):
        assert 0 <= _read(name, run) <= 100


class _Tally:
    def encoded(self, i, got):
        pass

    def decoded(self, got, want):
        assert got == want

    def failed(self):
        raise AssertionError("a call failed")
