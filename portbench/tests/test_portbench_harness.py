"""The harness's arithmetic on synthetic numbers, and its discovery of cells,
configurations, mixes and metrics by name."""

from __future__ import annotations

import hashlib
import io
import json
import math
import pathlib
import shutil
import time

import pytest
import torch

from portbench import check, generator, harness, readers, roofline, stats, \
    tracing
from portbench.corpus import load_plane
from portbench.reference.lzw import Wire

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _run_of(calls, profile=None, expected=None):
    cell = harness.Cell("c", 1, {}, {})
    return harness.Run(cell, 0, profile is not None, 1.0, calls,
                       expected or [], profile)


def test_rates_are_one_sum_over_one_sum():
    calls = [harness.Call("encode", "window", 0, 100 * stats.MiB, 1.0),
             harness.Call("encode", "window", 1, 1 * stats.MiB, 1.0),
             harness.Call("encode", "staged", 1, 50 * stats.MiB, 0.1),
             harness.Call("decode", "window", 0, 100 * stats.MiB, 4.0)]
    run = _run_of(calls)
    # 101 MiB in 2 s, not the mean of 100 and 1 MiB/s; staged calls and the
    # other operation left out.
    assert readers.rate(run, "encode") == pytest.approx(50.5)
    assert readers.rate(run, "decode") == pytest.approx(25.0)
    assert stats.rate_mib_s([], []) is None


def test_p95_is_over_every_call():
    seconds = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    calls = [harness.Call("decode", "window", 0, 1, s) for s in seconds]
    assert readers.p95_ms(_run_of(calls), "decode") == pytest.approx(95.0)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([], 95) is None


def _trace(tmp_path):
    """Two calls: an encode over [0, 100] us with device work [10, 30] and
    [20, 50] (overlapping) and a copy [90, 95]; a decode over [200, 300]
    with one kernel [250, 260], the host inside an op [205, 240]."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.encode",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void encode_parse_kernel<1>()",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "pack", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90,
         "dur": 5},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.encode",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.decode",
         "ts": 200, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 205,
         "dur": 35},
        {"ph": "X", "cat": "kernel", "name": "decode_pass1_kernel", "ts": 250,
         "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 1},
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_idle_share_and_union_from_a_chrome_trace(tmp_path):
    got = tracing.summarize(tracing.load(_trace(tmp_path)), harness.OPS)
    enc, dec = got["encode"], got["decode"]
    assert enc["calls"] == 1 and dec["calls"] == 1
    assert enc["wall_s"] == pytest.approx(100e-6)
    # [10, 50] and [90, 95]: the overlap counted once.
    assert enc["busy_s"] == pytest.approx(45e-6)
    assert enc["kernels"]["void encode_parse_kernel<1>()"] == \
        pytest.approx(20e-6)
    assert dec["busy_s"] == pytest.approx(10e-6)
    # Gaps [200, 250] (the host in aten::copy_ at 225) and [260, 300].
    assert dec["gaps"]["aten::copy_"] == pytest.approx(50e-6)
    assert dec["gaps"]["portbench.decode"] == pytest.approx(40e-6)
    run = _run_of([], got)
    assert readers.idle_pct(run, "encode") == pytest.approx(55.0)
    assert readers.idle_pct(run, "decode") == pytest.approx(90.0)
    assert tracing.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]


def test_union_and_gaps_clip_to_the_call():
    assert tracing.union_length([(0, 10), (5, 20), (30, 40)], 8, 35) == \
        pytest.approx(17)
    assert tracing.idle_gaps([(0, 10), (5, 20), (30, 40)], 8, 35) == \
        [(20, 30)]


def test_roofline_bytes_for_a_known_shape():
    # 2048 blocks of 64 KiB, 17,000 codes a block, 24,000 payload bytes.
    n, codes, payload = 2048 * 65536, 2048 * 17000, 2048 * 24000
    assert roofline.encode_parse(n, codes) == (n + 4 * codes, n)
    assert roofline.decode_pass1(payload, codes) == (payload + 4 * codes,
                                                      codes)
    assert roofline.decode_pass2(n, codes) == (4 * codes + n, n)
    b, o = roofline.encode_parse(n, codes)
    # Bytes bound it: 273.4 MB at 3.35 TB/s.
    assert roofline.least_seconds(b, o) == pytest.approx(b / 3.35e12)
    assert roofline.share_pct([(b, o)], 2 * b / 3.35e12) == pytest.approx(50)
    assert roofline.share_pct([(b, o)], 0.0) is None
    assert roofline.INT32_OPS_S == pytest.approx(16.73e12, rel=1e-3)


def test_kernel_roofline_reads_the_profiled_calls(tmp_path):
    from portbench.check import Expected

    got = tracing.summarize(tracing.load(_trace(tmp_path)), harness.OPS)
    calls = [harness.Call("encode", "profiled", 0, 1000, 1e-4)]
    run = _run_of(calls, got, [Expected(b"", 600, 300, 1)])
    want = 100 * roofline.least_seconds(1000 + 4 * 300, 1000) / 20e-6
    assert readers.kernel_roofline(
        run, "encode", "encode_parse_kernel",
        lambda e, n: roofline.encode_parse(n, e.codes)) == pytest.approx(want)
    assert readers.kernel_roofline(
        run, "decode", "decode_pass2_kernel",
        lambda e, n: roofline.decode_pass2(n, e.codes)) is None


def test_stage_readers():
    st = {"enc_host_prep": 0.002, "enc_h2d": 0.001, "enc_kernel": 0.004,
          "enc_pack": 0.003, "enc_d2h": 0.002}
    calls = [harness.Call("encode", "staged", 0, 1, 0.020, st)]
    run = _run_of(calls)
    # 20 ms less the 10 ms of the other stages: prep and the unstaged rest.
    assert readers.host_ms(run, "encode", "enc_host_prep") == \
        pytest.approx(10.0)
    assert readers.stage_ms(run, "encode", ("enc_h2d", "enc_d2h")) == \
        pytest.approx(3.0)
    assert readers.stage_ms(run, "encode", ("dec_count_recovery",)) is None
    multi = {"enc_pack@cuda:0": 0.001, "enc_pack@cuda:1": 0.002}
    run = _run_of([harness.Call("encode", "staged", 0, 1, 0.01, multi)])
    assert readers.stage_ms(run, "encode", ("enc_pack",)) == \
        pytest.approx(3.0)


def test_cells_report_their_metrics():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.metric_entries(bench, w["name"],
                                                         False)}
        layer = harness.metric_entries(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        assert all(m["moves"] in e2e for m in layer)
        one = w["traffic"] == "one-image"
        assert ("encode_p95_ms" in e2e) == one
        config = harness.load_cell(bench, w["name"]).config
        container = harness.entry(config) == "container"
        recovery = any(m["name"] == "schedule.count_recovery_ms"
                       for m in layer)
        assert recovery == (container and w["config"].startswith("gif7"))
        # The facade has no stage timer: no staged metric lists its cell.
        staged = any(m["name"].split(".")[0] in ("block", "encode",
                                                  "schedule")
                     for m in layer)
        assert staged == container
        for m in layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A cell, a configuration, a mix and a metric added as files and
    entries run with no edit of any file the benchmark has."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "gif7-image.json").read_text())
    cfg.update(name="gif5-image", wire={"flavor": "variable",
                                        "code_size": 8})
    (tmp_path / "portbench" / "configs" / "gif5-image.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench" / "traffic" / "pair.json").write_text(
        json.dumps({"window": "call", "offsets": "seed",
                    "bytes_per_call": 5000, "inputs": 2,
                    "ops": ["encode", "decode"], "loop": "closed",
                    "callers": 1}))
    (tmp_path / "portbench" / "metrics" / "calls.count.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "gif5-image", "source": "s",
                             "file": "portbench/configs/gif5-image.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "gif5-image-pair",
                               "config": "gif5-image", "traffic": "pair",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "calls.count", "unit": "calls",
                               "better": "higher", "source":
                               "program_counter", "layer": "harness",
                               "moves": "encode_MiBps",
                               "workloads": ["gif5-image-pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    cell = harness.load_cell(harness.load_benchmark(), "gif5-image-pair")
    assert cell.config["wire"]["code_size"] == 8
    assert cell.mix["bytes_per_call"] == 5000
    names = [m["name"] for m in harness.metric_entries(
        harness.load_benchmark(), "gif5-image-pair", True)]
    assert "calls.count" in names
    reader = harness.load_reader("calls.count")
    assert reader.read(_run_of([harness.Call("encode", "window", 0, 1,
                                             1.0)])) == 1.0


def test_inputs_come_from_the_seed():
    plane = load_plane(BENCH / "data" / "tokyo_128_colors.png")
    bulk = generator.load_mix(BENCH / "traffic" / "bulk.json")
    small = dict(bulk, bytes_per_call=8 * 4096)
    a = generator.make_inputs(small, plane, 4096, 2**31 + 11)
    b = generator.make_inputs(small, plane, 4096, 2**31 + 11)
    c = generator.make_inputs(small, plane, 4096, 12)
    assert [x.data for x in a] == [x.data for x in b]
    assert a[0].data != c[0].data
    assert len({x.data for x in a}) == len(a) == bulk["inputs"]
    assert all(len(x.data) == 8 * 4096 for x in a)
    # Every input holds the same blocks, each a window of the plane.
    for x in a:
        assert sorted(x.rows[x.order].tobytes()[i:i + 4096]
                      for i in range(0, 8 * 4096, 4096)) == sorted(
            a[0].data[i:i + 4096] for i in range(0, 8 * 4096, 4096))
    ring = plane.tobytes() * 2
    assert a[0].data[:4096] in ring
    one = generator.load_mix(BENCH / "traffic" / "one-image.json")
    imgs = generator.make_inputs(one, plane, 65536, 5)
    assert len(imgs) == one["inputs"]
    assert all(len(x.data) == len(plane) == 700416 for x in imgs)
    assert all(sorted(x.data) == sorted(plane.tobytes()) for x in imgs[:2])
    assert math.ceil(700416 / 65536) == 11


def _mix_run(tmp_path, monkeypatch, mix: dict, seconds=0.0, min_iterations=2):
    """A new mix placed as a file and run, at a test's size, with the
    reference in the program's place: no file the benchmark has is
    edited."""
    from portbench.control import ReferenceCodec

    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "traffic" / "new.json").write_text(
        json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gif7-image-new",
                               "config": "gif7-image", "traffic": "new",
                               "chips": 1, "why": "w"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, "gif7-image-new")
    cell.config["block_size"] = 4096
    codecs = []

    def make(config, devices, stage_times=None):
        codecs.append(ReferenceCodec(config))
        return codecs[-1]

    result, numbers = harness.run_cell(
        cell, 2**31 + 5, seconds, False, [torch.device("cpu")],
        harness.metric_entries(bench, cell.name, False), time.perf_counter(),
        make_codec=make, workers=1, min_iterations=min_iterations,
        err=io.StringIO())
    assert result["correct"], numbers
    return result, codecs


SMALL = {"bytes_per_call": 3 * 4096, "inputs": 2, "callers": 1,
         "loop": "closed"}


def test_a_decode_only_mix_is_data(tmp_path, monkeypatch):
    result, _ = _mix_run(tmp_path, monkeypatch, dict(
        SMALL, window="block", offsets="seed", ops=["decode"]))
    assert result["calls"] == {"encode": 0, "decode": 2}
    assert "decode_MiBps" in result["metrics"]
    assert "encode_MiBps" not in result["metrics"]


def test_a_new_layout_is_data(tmp_path, monkeypatch):
    """Block windows at offsets drawn from the seed, a layout no mix of
    the benchmark uses."""
    result, _ = _mix_run(tmp_path, monkeypatch, dict(
        SMALL, window="block", offsets="seed", ops=["encode", "decode"]))
    assert result["calls"] == {"encode": 2, "decode": 2}


def test_an_open_loop_with_several_callers_is_data(tmp_path, monkeypatch):
    result, codecs = _mix_run(tmp_path, monkeypatch, dict(
        SMALL, window="call", offsets="even", ops=["encode", "decode"],
        loop="open", callers=3, rate_per_s=40, arrivals="random"),
        seconds=0.25, min_iterations=1)
    # Every caller has a codec of its own, warmed on every input.
    assert len(codecs) == 3
    # round(40 * 0.25) requests, each an encode and a decode.
    assert result["calls"] == {"encode": 10, "decode": 10}
    assert result["metrics"]["encode_MiBps"]["value"] > 0


def test_an_open_loop_counts_the_wait_in_the_latency():
    class Slow:
        def encode(self, x):
            time.sleep(0.02)
            return b"c"

        def decode(self, c):
            return b"x"

    mix = {"ops": ["encode", "decode"], "loop": "open", "rate_per_s": 1000,
           "arrivals": "even"}
    calls = []
    window = harness._Window(mix, [generator.Input(b"x")] * 2,
                             _NullTally(), calls, 1)
    window.run([Slow()], 0.005, "window")
    enc = [c for c in calls if c.op == "encode"]
    # Five requests 1 ms apart, each encode 20 ms: the last one waits for
    # the four before it.
    assert len(enc) == 5
    assert enc[-1].latency == pytest.approx(0.1 - 0.004, abs=0.015)
    assert enc[-1].seconds < 0.04
    run = _run_of(calls)
    assert readers.p95_ms(run, "encode") == pytest.approx(
        1e3 * enc[-1].latency)


class _NullTally:
    def encoded(self, i, got):
        pass

    def decoded(self, got, want):
        pass

    def failed(self):
        pass


def test_a_mix_with_a_key_no_code_reads_is_refused(tmp_path):
    mix = json.loads((BENCH / "traffic" / "one-image.json").read_text())
    for bad in ({"think_ms": 5}, {"rate_per_s": 3}, {"window": "tile"},
                {"ops": ["encode", "verify"]}, {"callers": 0}):
        path = tmp_path / "m.json"
        path.write_text(json.dumps(dict(mix, **bad)))
        with pytest.raises(ValueError):
            generator.load_mix(path)
    assert generator.load_mix(BENCH / "traffic" / "bulk.json")["callers"] \
        == 1


def test_open_arrivals_are_as_many_for_every_seed():
    mix = {"loop": "open", "rate_per_s": 50, "arrivals": "random"}
    a = generator.arrivals(mix, 2.0, 1)
    b = generator.arrivals(mix, 2.0, 2**40 + 3)
    assert len(a) == len(b) == 100
    assert list(a) != list(b) and a.min() >= 0 and a.max() < 2.0
    even = generator.arrivals(dict(mix, arrivals="even"), 2.0, 1)
    assert even[1] == pytest.approx(0.02)
    assert generator.arrivals({"loop": "closed"}, 2.0, 1) is None


def _bench_with(tmp_path, monkeypatch, cell: dict, config: dict | None = None):
    """BENCHMARK.json with one more cell (and configuration), in a copy of
    the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if config is not None:
        (tmp_path / "portbench" / "configs" / "new.json").write_text(
            json.dumps(config))
        bench["configs"].append({"name": "new", "source": "s",
                                 "file": "portbench/configs/new.json",
                                 "reduced": [], "why": "w"})
    bench["workloads"].append(dict({"name": "new-cell", "chips": 1,
                                    "why": "w"}, **cell))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    return harness.load_benchmark()


def test_a_facade_configuration_builds_the_torch_facade():
    from lzw_tpu_torch.api import LzwCodec
    from lzw_tpu_torch.spec import LzwSpec

    cell = harness.load_cell(harness.load_benchmark(), "gif7-image-facade")
    assert cell.chips == 1 and "block_size" not in cell.config
    assert harness.entry(cell.config) == "facade"
    assert harness.block_size(cell.config) is None
    codec = harness.make_program_codec(cell.config, [torch.device("cpu")],
                                       {})
    assert type(codec) is LzwCodec
    assert codec.backend == "torch" and codec.device == torch.device("cpu")
    assert codec.spec == LzwSpec.gif(7)
    for name in ("gif7-image-one", "fixed12-image-one"):
        config = harness.load_cell(harness.load_benchmark(), name).config
        assert harness.entry(config) == "container"
        assert harness.block_size(config) == config["block_size"]


@pytest.mark.parametrize("case", ["four chips", "block windows",
                                  "unknown entry"])
def test_a_facade_cell_it_cannot_run_is_refused(tmp_path, monkeypatch, case):
    config = json.loads((BENCH / "configs" / "gif7-facade.json").read_text())
    cell = {"config": "new", "traffic": "one-image"}
    if case == "four chips":
        cell["chips"] = 4
    elif case == "block windows":
        cell["traffic"] = "bulk"
    else:
        config["entry"] = "stream"
    bench = _bench_with(tmp_path, monkeypatch, cell, config)
    with pytest.raises(ValueError):
        harness.load_cell(bench, "new-cell")


# sha256 (first 16 hex digits) of the reference's containers of two inputs
# of each container configuration and mix, cut to a test's size, as the
# harness before the facade entry gave them.
CONTAINERS = {"gif7-image/one-image": "c695f508f46d39d9",
              "gif7-image/bulk": "c080c45ec3e3fcb1",
              "fixed12-image/one-image": "3002b7b612a18df1",
              "fixed12-image/bulk": "b1cde9c212a8415d"}


@pytest.mark.parametrize("key", sorted(CONTAINERS))
def test_the_container_path_expects_the_same_containers(key):
    name, traffic = key.split("/")
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    mix = generator.load_mix(BENCH / "traffic" / f"{traffic}.json")
    mix["inputs"] = 2
    mix["bytes_per_call"] = 5 * 4096 if mix["window"] == "block" else \
        5 * 4096 + 777
    plane = load_plane(ROOT / config["corpus"])
    inputs = generator.make_inputs(mix, plane, 4096, 2**31 + 29)
    want = check.expected(inputs, Wire.from_dict(config["wire"]), 4096)
    h = hashlib.sha256()
    for e in want:
        h.update(e.container)
        h.update(repr((e.payload_bytes, e.codes, e.blocks)).encode())
    assert h.hexdigest()[:16] == CONTAINERS[key]


STREAM_READERS = {
    "stream_encode_roofline": ("encode", "stream_encode_kernel",
                               lambda e, n: roofline.encode_parse(n, e.codes)),
    "stream_pass1_roofline": ("decode", "stream_pass1_kernel",
                              lambda e, n: roofline.decode_pass1(
                                  e.payload_bytes, e.codes)),
    "stream_pass2_roofline": ("decode", "stream_pass2_kernel",
                              lambda e, n: roofline.decode_pass2(n, e.codes)),
}


@pytest.mark.parametrize("name", sorted(STREAM_READERS))
def test_a_stream_kernels_roofline_reads_its_kernel(tmp_path, name):
    """An encode [0, 100] us with ``stream_encode_kernel`` [10, 30]; a
    decode [200, 300] with ``stream_pass1_kernel`` [210, 240] and
    ``stream_pass2_kernel`` [250, 255]; the container's kernels beside
    them are not read."""
    op, kernel, work = STREAM_READERS[name]

    def x(cat, nm, ts, dur):
        return {"ph": "X", "cat": cat, "name": nm, "ts": ts, "dur": dur}

    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": [
        x("user_annotation", "portbench.encode", 0, 100),
        x("kernel", "void (anonymous namespace)::stream_encode_kernel(int)",
          10, 20),
        x("kernel", "encode_parse_kernel", 40, 50),
        x("user_annotation", "portbench.decode", 200, 100),
        x("kernel", "stream_pass1_kernel", 210, 30),
        x("kernel", "(anonymous namespace)::stream_pass2_kernel(Args)",
          250, 5),
        x("kernel", "decode_pass1_kernel", 260, 30)]}))
    profile = tracing.summarize(tracing.load(path), harness.OPS)
    device_s = {"stream_encode_kernel": 20e-6, "stream_pass1_kernel": 30e-6,
                "stream_pass2_kernel": 5e-6}[kernel]
    exp = check.Expected(b"", 600, 300, 1)
    calls = [harness.Call(op, "profiled", 0, 1000, 1e-4)]
    reader = harness.load_reader(name)
    assert reader.read(_run_of(calls, profile, [exp])) == pytest.approx(
        100 * roofline.least_seconds(*work(exp, 1000)) / device_s)
    assert reader.read(_run_of(calls, None, [exp])) is None
    # A profile of the container's kernels alone has nothing to read.
    other = {op: dict(profile[op], kernels={"decode_pass1_kernel": 1e-5,
                                            "encode_parse_kernel": 1e-5})}
    assert reader.read(_run_of(calls, other, [exp])) is None
