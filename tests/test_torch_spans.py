"""The codecs' spans and counters (``lzw_tpu_torch.utils.spans``) on the CPU.

Under ``torch.profiler`` every public call of the container codec and of
the ``"torch"`` facades is a host range ``lzw.encode`` / ``lzw.decode``
whose args hold its call id, with its steps as stage spans inside it;
with no profiler no range is opened at all.  The stage timer behind
``stage_times`` keeps its keys on every route, count recovery counts
the EOI symbols it reads, and the container counts each call's blocks.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lzw_tpu_torch import BlockParallelCodec, Endianness, LzwCodec, LzwSpec
from lzw_tpu_torch.kernels import schedule
from lzw_tpu_torch.ops import reference
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.utils import spans
from lzw_tpu_torch.utils.testdata import spliced_nonstrict_stream

CALLS = ("lzw.encode", "lzw.decode")
NOT_STAGES = (*CALLS, "lzw.range")
SPECS = {"gif7": LzwSpec.gif(7), "fixed12": LzwSpec.fixed(Endianness.LITTLE),
         "tiff": LzwSpec.tiff()}


def _data(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, n).astype(np.uint8).tobytes()


def _traced(tmp_path, fn, **kw) -> list[dict]:
    """``fn()`` under a CPU profiler that records the spans' args
    (``record_shapes``): the complete events of its Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 **kw) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _spans(events) -> list[dict]:
    return [e for e in events if e["name"].startswith(spans.PREFIX)]


def _inside(e: dict, outer: dict) -> bool:
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def _args(e: dict) -> list[int]:
    return [int(a) for a in e["args"]["Concrete Inputs"]]


@pytest.fixture(autouse=True)
def _fresh_tallies(monkeypatch):
    monkeypatch.setattr(spans, "COUNTS", spans.Tally())
    monkeypatch.setattr(spans, "PROFILED", spans.Tally())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_stage_spans_nest_in_their_call(tmp_path, name):
    spec = SPECS[name]
    data = _data(5 * 512 + 77)
    codec = BlockParallelCodec(spec, 512, device="cpu", verify=True)
    container = codec.encode(data)
    got = {}
    events = _traced(tmp_path, lambda: got.update(
        c=codec.encode(data), d=codec.decode(container)))
    assert got == {"c": container, "d": data}
    lzw = _spans(events)
    calls = sorted((e for e in lzw if e["name"] in CALLS),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in calls] == list(CALLS)
    enc, dec = calls
    # (call id, blocks, input bytes, route): the ids of one codec count
    # up; a CPU decode's strict blocks take the host pass 2.
    assert _args(enc) == [_args(enc)[0], 6, len(data), -1]
    assert _args(dec) == [_args(enc)[0] + 1, 6, len(container),
                          spans.ROUTES.index("host")]
    names = collections.defaultdict(set)
    for e in lzw:
        if e["name"] in CALLS:
            continue
        owner = [c for c in calls if _inside(e, c)]
        assert len(owner) == 1, e["name"]
        names[owner[0]["name"]].add(e["name"][len(spans.PREFIX):])
    # One device: every step runs in the calling thread, with no range
    # span.
    assert names["lzw.encode"] == {
        "enc_host_prep", "enc_h2d", "enc_kernel", "enc_errors",
        "enc_pack", "enc_d2h", "enc_payloads", "enc_verify", "pack_frame"}
    recover = {"dec_count_recovery", "dec_unpack", "dec_strict",
               "recover.candidates", "recover.strict",
               "recover.schedule_rows"}
    assert names["lzw.decode"] == {
        "parse_frame", "dec_host_prep", "dec_h2d", "dec_pass1",
        "dec_errors", "dec_d2h_words", "dec_apply_words",
        *(recover if spec.variable else ())}
    # Every torch op of a call runs inside one of its stage spans.
    stages = [e for e in lzw if e["name"] not in NOT_STAGES]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and not e["name"].startswith(spans.PREFIX)
           and any(_inside(e, c) for c in calls)]
    assert ops
    assert [e["name"] for e in ops
            if not any(_inside(e, s) for s in stages)] == []
    # The profiled stretch's tally: each span's seconds by its name.
    tally = spans.PROFILED.snapshot()
    assert {k for k in tally if k.startswith(spans.PREFIX)} == {
        e["name"] for e in lzw}
    assert tally["lzw.decode"] > tally["lzw.dec_pass1"] > 0


@pytest.mark.parametrize("name", ["gif7", "fixed12"])
def test_span_count_does_not_grow_with_blocks(tmp_path, name):
    spec = SPECS[name]
    per_call = {}
    for n_blocks in (11, 171):
        data = _data(n_blocks * 128, seed=n_blocks)
        codec = BlockParallelCodec(spec, 128, device="cpu", pass2="device")
        codec.decode(codec.encode(data))
        events = _traced(tmp_path, lambda: codec.decode(codec.encode(data)))
        per_call[n_blocks] = collections.Counter(
            e["name"] for e in _spans(events))
    assert per_call[11] == per_call[171]
    assert sum(per_call[11].values()) <= 30


def test_range_spans_carry_their_call_id(tmp_path):
    spec = SPECS["gif7"]
    data = _data(6 * 512)
    codec = BlockParallelCodec(spec, 512, device=["cpu", "cpu"],
                               pass2="device")
    container = codec.encode(data)

    def calls():
        assert codec.encode(data) == container
        assert codec.decode(container) == data

    # The ranges run on worker threads, which a profiler records only
    # when asked to record every thread.
    events = _traced(tmp_path, calls)
    assert [e["name"] for e in _spans(events) if e["name"] == "lzw.range"] \
        == []
    every = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    events = _traced(tmp_path, calls, experimental_config=every)
    lzw = _spans(events)
    ids = {e["name"]: _args(e)[0] for e in lzw if e["name"] in CALLS}
    ranges = [e for e in lzw if e["name"] == "lzw.range"]
    main = {e["tid"] for e in lzw if e["name"] in CALLS}
    assert {e["tid"] for e in ranges}.isdisjoint(main)
    seen = collections.Counter()
    for r in ranges:
        (owner,) = [c for c in lzw if c["name"] in CALLS and _inside(r, c)]
        call, device, lo, hi = _args(r)
        assert call == ids[owner["name"]]
        assert device == -1 and (lo, hi) in {(0, 3), (3, 6)}
        seen[owner["name"]] += 1
    # Two ranges a step: encode has one step, the device-route decode three
    # (count recovery, pass 1 and 2, the copy into the result).
    assert seen == {"lzw.encode": 2, "lzw.decode": 6}


def _route_cases():
    data = _data(3 * 256 + 50, seed=1)
    g7, f12 = SPECS["gif7"], SPECS["fixed12"]
    nonstrict = framing.pack_frame(
        g7, 256, len(data),
        [spliced_nonstrict_stream(data[i:i + 256], g7, 100)
         for i in range(0, len(data), 256)])
    cases = []
    for devices in ("cpu", ["cpu", "cpu"]):
        for pass2 in ("auto", "device", "host"):
            cases.append((g7, 256, pass2, devices, data, None))
            cases.append((f12, 256, pass2, devices, data, None))
        for pass2 in ("auto", "device"):
            cases.append((g7, 256, pass2, devices, data, nonstrict))
            cases.append((g7, 1 << 18, pass2, devices, data * 400, None))
    return cases


def _run_route(case, stage_times=None):
    spec, bs, pass2, devices, data, container = case
    codec = BlockParallelCodec(spec, bs, device=devices, pass2=pass2,
                               stage_times=stage_times)
    if container is None:
        container = codec.encode(data)
    assert codec.decode(container) == data
    return codec


def test_no_profiler_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a host range was opened with no profiler")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        refuse)
    assert not spans.recording()
    for case in _route_cases():
        _run_route(case)
    facade = LzwCodec(SPECS["gif7"], backend="torch", device="cpu")
    data = _data(300)
    assert facade.decode(facade.encode(data)) == data
    # Counters tick without a profiler; nothing gathers span seconds.
    assert spans.COUNTS.snapshot()["recover.blocks"] > 0
    assert spans.PROFILED.snapshot() == {}
    assert spans.span("enc_kernel") is spans.OFF


ENC = ["enc_d2h", "enc_h2d", "enc_host_prep", "enc_kernel", "enc_pack"]
# The stage_times keys of every route, as the codec gave them before its
# stages became spans: (spec, pass2, devices, container kind) -> encode's
# keys (None where the case decodes a given container) and decode's.
STAGE_KEYS = {
    ("gif7", "auto", 1): (ENC, [
        "dec_apply_words", "dec_count_recovery", "dec_d2h_words", "dec_h2d",
        "dec_host_prep", "dec_pass1", "dec_unpack"]),
    ("fixed12", "auto", 1): (ENC, [
        "dec_apply_words", "dec_d2h_words", "dec_h2d", "dec_host_prep",
        "dec_pass1"]),
    ("gif7", "device", 1): (ENC, [
        "dec_count_recovery", "dec_d2h_out", "dec_h2d", "dec_host_prep",
        "dec_pass1", "dec_pass2", "dec_unpack"]),
    ("fixed12", "device", 1): (ENC, [
        "dec_d2h_out", "dec_h2d", "dec_host_prep", "dec_pass1",
        "dec_pass2"]),
    ("gif7", "host", 1): (ENC, [
        "dec_apply_words", "dec_count_recovery", "dec_d2h_words", "dec_h2d",
        "dec_host_prep", "dec_pass1", "dec_unpack"]),
    ("fixed12", "host", 1): (ENC, [
        "dec_apply_words", "dec_d2h_words", "dec_h2d", "dec_host_prep",
        "dec_pass1"]),
    ("nonstrict", "auto", 1): (None, ["dec_count_recovery",
                                      "dec_host_prep"]),
    ("nonstrict", "device", 1): (None, [
        "dec_count_recovery", "dec_d2h_out", "dec_h2d", "dec_host_prep",
        "dec_parse_epochs", "dec_pass1", "dec_pass2"]),
    ("big", "auto", 1): (ENC, []),
    ("big", "device", 1): (ENC, ["dec_d2h_out", "dec_h2d", "dec_host_prep",
                                 "dec_stream"]),
    ("gif7", "auto", 2): ([k + "@cpu" for k in ENC], [
        "dec_apply_words", "dec_apply_words@cpu", "dec_count_recovery@cpu",
        "dec_d2h_words@cpu", "dec_h2d@cpu", "dec_host_prep@cpu",
        "dec_pass1@cpu", "dec_unpack@cpu"]),
    ("fixed12", "auto", 2): ([k + "@cpu" for k in ENC], [
        "dec_apply_words", "dec_apply_words@cpu", "dec_d2h_words@cpu",
        "dec_h2d@cpu", "dec_host_prep@cpu", "dec_pass1@cpu"]),
    ("gif7", "device", 2): ([k + "@cpu" for k in ENC], [
        "dec_count_recovery@cpu", "dec_d2h_out", "dec_h2d@cpu",
        "dec_host_prep@cpu", "dec_pass1@cpu", "dec_pass2@cpu",
        "dec_unpack@cpu"]),
    ("fixed12", "device", 2): ([k + "@cpu" for k in ENC], [
        "dec_d2h_out", "dec_h2d@cpu", "dec_host_prep@cpu", "dec_pass1@cpu",
        "dec_pass2@cpu"]),
    ("gif7", "host", 2): ([k + "@cpu" for k in ENC], [
        "dec_apply_words", "dec_apply_words@cpu", "dec_count_recovery@cpu",
        "dec_d2h_words@cpu", "dec_h2d@cpu", "dec_host_prep@cpu",
        "dec_pass1@cpu", "dec_unpack@cpu"]),
    ("fixed12", "host", 2): ([k + "@cpu" for k in ENC], [
        "dec_apply_words", "dec_apply_words@cpu", "dec_d2h_words@cpu",
        "dec_h2d@cpu", "dec_host_prep@cpu", "dec_pass1@cpu"]),
    ("nonstrict", "auto", 2): (None, ["dec_count_recovery@cpu",
                                      "dec_host_prep@cpu"]),
    ("nonstrict", "device", 2): (None, [
        "dec_count_recovery@cpu", "dec_d2h_out@cpu", "dec_h2d@cpu",
        "dec_host_prep@cpu", "dec_parse_epochs@cpu", "dec_pass1@cpu",
        "dec_pass2@cpu"]),
    ("big", "auto", 2): ([k + "@cpu" for k in ENC], []),
    ("big", "device", 2): ([k + "@cpu" for k in ENC], [
        "dec_d2h_out", "dec_h2d@cpu", "dec_host_prep@cpu",
        "dec_stream@cpu"]),
}


def _case_key(case):
    spec, bs, pass2, devices, _, container = case
    kind = ("big" if bs > 1 << 17 else "nonstrict" if container is not None
            else "gif7" if spec.variable else "fixed12")
    return kind, pass2, 1 if devices == "cpu" else 2


@pytest.mark.parametrize("case", _route_cases(),
                         ids=lambda c: "-".join(map(str, _case_key(c))))
def test_stage_times_keys_are_unchanged(case):
    enc_keys, dec_keys = STAGE_KEYS[_case_key(case)]
    spec, bs, pass2, devices, data, container = case
    stages = {}
    codec = BlockParallelCodec(spec, bs, device=devices, pass2=pass2,
                               stage_times=stages)
    if container is None:
        container = codec.encode(data)
        assert sorted(stages) == enc_keys
        stages.clear()
    assert codec.decode(container) == data
    assert sorted(stages) == dec_keys


def test_recover_counters_on_crafted_streams():
    spec = SPECS["gif7"]

    def recover(payloads):
        width = max(len(p) for p in payloads)
        mat = np.zeros((len(payloads), width), np.uint8)
        for i, p in enumerate(payloads):
            mat[i, :len(p)] = np.frombuffer(p, np.uint8)
        before = spans.COUNTS.snapshot()
        schedule.recover_counts(mat, np.array([len(p) for p in payloads]),
                                spec)
        after = spans.COUNTS.snapshot()
        return {k: after[k] - before.get(k, 0) for k in after}

    one = reference.encode_bytes(b"\x01", spec)
    # CLEAR, one data code and EOI, 8 bits each: 3 bytes fit one count
    # only, and its EOI reads as one under the first rule tried.
    assert len(one) == 3
    assert recover([one]) == {"recover.blocks": 1, "recover.reads": 1}
    # One read for each row and candidate it tries: four equal streams,
    # four reads.
    assert recover([one] * 4) == {"recover.blocks": 4, "recover.reads": 4}
    longer = [reference.encode_bytes(bytes(range(1, 2 + k)), spec)
              for k in range(3)]
    assert len({len(p) for p in longer}) == 3
    alone = sum(recover([p])["recover.reads"] for p in longer)
    assert recover(longer) == {"recover.blocks": 3, "recover.reads": alone}
    # A stream whose EOI is gone tries every candidate of its length, both
    # rules, and finds none.
    broken = one[:2] + b"\x00"
    tries = recover([broken])["recover.reads"]
    assert tries == 2
    assert recover([broken, one]) == {"recover.blocks": 2,
                                      "recover.reads": tries + 1}
    # While a profiler records, the ticks also go to its tally, beside the
    # seconds of count recovery's spans.
    with profile(activities=[ProfilerActivity.CPU]):
        recover([one])
    tally = spans.PROFILED.snapshot()
    assert {k: v for k, v in tally.items()
            if not k.startswith(spans.PREFIX)} == {"recover.blocks": 1,
                                                   "recover.reads": 1}
    assert set(tally) > {"lzw.recover.candidates", "lzw.recover.strict"}


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]],
                         ids=["one-range", "two-ranges"])
@pytest.mark.parametrize("op", ["encode", "decode"])
def test_block_counters_count_each_call_once(op, devices):
    spec = SPECS["tiff"]
    data = _data(4 * 256 + 50, seed=3)
    codec = BlockParallelCodec(spec, 256, device=devices, pass2="device")
    container = codec.encode(data)
    call, arg, want = ((codec.encode, data, container) if op == "encode"
                       else (codec.decode, container, data))
    name = f"{op}.blocks"

    def ticks(tally, before):
        return tally.snapshot().get(name, 0) - before.get(name, 0)

    counts, profiled = spans.COUNTS.snapshot(), spans.PROFILED.snapshot()
    assert call(arg) == want
    # With no profiler the counter ticks, and nothing is gathered.
    assert ticks(spans.COUNTS, counts) == 5
    assert spans.PROFILED.snapshot() == profiled
    with profile(activities=[ProfilerActivity.CPU]):
        call(arg)
        call(arg)
    # Five blocks a call, once a call, whatever the ranges.
    assert ticks(spans.PROFILED, profiled) == 10
    assert ticks(spans.COUNTS, counts) == 15


def test_torch_facade_spans(tmp_path):
    codec = LzwCodec(SPECS["gif7"], backend="torch", device="cpu")
    data = _data(300)
    stream = codec.encode(data)
    got = {}
    events = _traced(tmp_path, lambda: got.update(
        c=codec.encode(data), d=codec.decode(stream)))
    assert got == {"c": stream, "d": data}
    lzw = _spans(events)
    calls = sorted((e for e in lzw if e["name"] in CALLS),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in calls] == list(CALLS)
    assert _args(calls[0]) == [0, 1, len(data), -1]
    assert _args(calls[1]) == [1, 1, len(stream), spans.ROUTES.index(
        "device")]
    inner = {c["name"]: sorted(e["name"] for e in lzw
                               if e is not c and _inside(e, c))
             for c in calls}
    assert inner == {
        "lzw.encode": ["lzw.enc_d2h", "lzw.enc_errors", "lzw.enc_h2d",
                       "lzw.enc_host_prep", "lzw.enc_kernel",
                       "lzw.enc_pack"],
        "lzw.decode": ["lzw.dec_d2h_out", "lzw.dec_errors", "lzw.dec_h2d",
                       "lzw.dec_host_prep", "lzw.dec_stream"]}


def test_stream_encode_counts_only_while_profiled(tmp_path):
    # encode_stream_bytes adds the kernel's steps and rounds (here the
    # plain version's: its phrases, no rounds) and the stream's bytes to
    # the counters only while a profiler records; unprofiled calls read
    # nothing back.
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.ops.encode import encode_stream_bytes

    spec = LzwSpec.gif(7)
    data = bytes(range(64)) * 40
    encode_stream_bytes(data, spec, device="cpu")
    assert not any(k.startswith("stream_encode.")
                   for k in spans.COUNTS.snapshot())
    _traced(tmp_path, lambda: encode_stream_bytes(data, spec, device="cpu"))
    row = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
    plain = tenc.encode_blocks_codes_reference(
        row, torch.tensor([len(data)], dtype=torch.int32), spec)
    want = {"stream_encode.bytes": len(data),
            "stream_encode.steps": int(plain[1][0] + plain[2][0]),
            "stream_encode.rounds": 0}
    for tally in (spans.COUNTS, spans.PROFILED):
        got = tally.snapshot()
        assert {k: got.get(k) for k in want} == want
