"""The container's row split over several devices, on the CPU.

A list of CPU devices runs the kernels' plain versions, one worker thread
per block range, as a list of GPUs runs the kernels.  Containers are held
against the JAX package's ``BlockParallelCodec`` on its 8-device CPU mesh;
containers and decoded bytes are compared exactly.  The thread-safety
tests count through dicts whose item access yields the interpreter between
a read and its write, so an unguarded read-modify-write loses counts.
"""

import io
import threading
import time
import types

import pytest
import torch

from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

import chip_smoke
import lzw_tpu_torch.kernels.decode as tdec
import lzw_tpu_torch.parallel.block as block
from lzw_tpu_torch import (
    BlockParallelCodec, LzwSpec, UnexpectedCodeError, from_reference_spec,
)
from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.native.runtime import NativeRuntime
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.parallel import default_devices, framing, local_devices
from lzw_tpu_torch.utils.testdata import spliced_nonstrict_stream

BS = 512
REF = {"gif7": JSpec.gif(7), "tiff": JSpec.tiff(),
       "fixed": JSpec.fixed(JEndianness.LITTLE)}
# Codes past the decoder's next index, two per flavor.
BAD_CODES = {"gif7": (250, 251), "fixed": (4000, 4001)}
_JAX_CONTAINERS: dict = {}


def _cpus(k):
    return ["cpu"] * k


def _data(tokyo_pixels, n_blocks):
    # The last block is 100 bytes short.
    return tokyo_pixels[: max(n_blocks * BS - 100, 0)]


def _jax_container(name, data):
    key = (name, len(data))
    if key not in _JAX_CONTAINERS:
        _JAX_CONTAINERS[key] = JaxCodec(REF[name], block_size=BS).encode(data)
    return _JAX_CONTAINERS[key]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_blocks", [0, 1, 2, 7, 9])
@pytest.mark.parametrize("name", list(REF))
def test_containers_match_the_jax_mesh(name, n_blocks, k, tokyo_pixels):
    data = _data(tokyo_pixels, n_blocks)
    codec = BlockParallelCodec(from_reference_spec(REF[name]), BS,
                               device=_cpus(k))
    container = codec.encode(data)
    assert container == _jax_container(name, data)
    assert codec.decode(container) == data


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("pass2", ["host", "device", "auto"])
@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_round_trip_on_every_route(name, pass2, k, tokyo_pixels):
    data = _data(tokyo_pixels, 7)
    spec = from_reference_spec(REF[name])
    container = BlockParallelCodec(spec, BS, device="cpu").encode(data)
    codec = BlockParallelCodec(spec, BS, device=_cpus(k), pass2=pass2)
    assert codec.decode(container) == data
    assert codec.decode_range(container, 1, 6) == data[BS : 6 * BS]
    assert codec.decode_range(container, 6, 7) == data[6 * BS :]


@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_streams_over_the_split(name, tokyo_pixels):
    data = _data(tokyo_pixels, 9)
    spec = from_reference_spec(REF[name])
    one = BlockParallelCodec(spec, BS, device="cpu")
    three = BlockParallelCodec(spec, BS, device=_cpus(3))
    streams = []
    for codec in (one, three):
        dst = io.BytesIO()
        assert codec.encode_stream(io.BytesIO(data), dst,
                                   batch_blocks=4) == len(data)
        streams.append(dst.getvalue())
    assert streams[0] == streams[1]
    out = io.BytesIO()
    assert three.decode_stream(io.BytesIO(streams[1]), out,
                               batch_blocks=5) == len(data)
    assert out.getvalue() == data


def _corrupt_payload(spec, first_byte, bad_code):
    """A strict stream of one block whose sixth code is ``bad_code``,
    beyond the decoder's next index: pass 1 reports it."""
    data = bytes([first_byte]) + bytes((i * 7) % 40 for i in range(300))
    codes = oracle.encode_codes(data, spec)
    k = 6 if spec.variable else 5  # after the leading CLEAR, if any
    codes[k] = (bad_code, codes[k][1])
    return oracle.pack_codes(codes, spec.endianness)


def _numbered_container(spec, corrupt):
    """Eight blocks; block i starts with byte i + 1, so its first code is
    i + 1; ``corrupt`` maps block index -> the code that breaks it."""
    blocks = [bytes([i + 1]) + bytes((i * 5 + j) % 60 for j in range(BS - 1))
              for i in range(8)]
    payloads = [_corrupt_payload(spec, i + 1, corrupt[i]) if i in corrupt
                else oracle.encode_bytes(b, spec)
                for i, b in enumerate(blocks)]
    orig = sum(301 if i in corrupt else BS for i in range(8))
    return framing.pack_frame(spec, BS, orig, payloads)


@pytest.mark.parametrize("pass2", ["host", "device"])
@pytest.mark.parametrize("slow_range", [0, 1])
@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_first_failing_block_wins(name, slow_range, pass2, monkeypatch):
    # Blocks 1 (range 0) and 6 (range 1) fail pass 1; the range given a
    # delay finishes last, and block 1's code is raised either way.
    spec = from_reference_spec(REF[name])
    bad0, bad1 = BAD_CODES[name]
    container = _numbered_container(spec, {1: bad0, 6: bad1})
    pass1 = tdec.decode_pass1
    slow_first_code = 1 + 4 * slow_range

    def delayed(codes, *args, **kwargs):
        if int(codes[0, 0]) == slow_first_code:
            time.sleep(0.3)
        return pass1(codes, *args, **kwargs)

    monkeypatch.setattr(tdec, "decode_pass1", delayed)
    for k in (1, 2):
        codec = BlockParallelCodec(spec, BS, device=_cpus(k), pass2=pass2)
        with pytest.raises(UnexpectedCodeError) as ei:
            codec.decode(container)
        assert ei.value.code == bad0
    # Range 1's own error when range 0 is clean.
    container = _numbered_container(spec, {6: bad1})
    with pytest.raises(UnexpectedCodeError) as ei:
        BlockParallelCodec(spec, BS, device=_cpus(2), pass2=pass2).decode(
            container)
    assert ei.value.code == bad1


def _count_calls(monkeypatch, owner, name):
    calls = []
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("pass2", ["auto", "host", "device"])
def test_nonstrict_range_takes_the_one_device_route(pass2, tokyo_pixels,
                                                    monkeypatch):
    # Block 5, in the second of two ranges, is a foreign early-CLEAR
    # stream: the whole container takes the non-strict route, as on one
    # device, and the strict attempt stops at the host count recovery.
    spec = LzwSpec.gif(7)
    data = _data(tokyo_pixels, 7)
    _, payloads = framing.parse_frame(
        BlockParallelCodec(spec, BS, device="cpu").encode(data))
    payloads = [bytes(p) for p in payloads]
    payloads[5] = spliced_nonstrict_stream(data[5 * BS : 6 * BS], spec, 300)
    container = framing.pack_frame(spec, BS, len(data), payloads)
    pass1 = _count_calls(monkeypatch, tdec, "decode_pass1")
    native = _count_calls(monkeypatch, NativeRuntime, "decode_blocks")
    outs = [BlockParallelCodec(spec, BS, device=_cpus(k),
                               pass2=pass2).decode(container)
            for k in (1, 2)]
    assert outs == [data, data]
    assert pass1 == []
    assert len(native) == (0 if pass2 == "device" else 2)


@pytest.mark.parametrize("k", [1, 3])
def test_nonstrict_batch_returns_before_pass1(k, tokyo_pixels, monkeypatch):
    spec = LzwSpec.gif(7)
    data = tokyo_pixels[: 3 * BS]
    payloads = [spliced_nonstrict_stream(data[i : i + BS], spec, 400)
                for i in range(0, len(data), BS)]
    container = framing.pack_frame(spec, BS, len(data), payloads)
    pass1 = _count_calls(monkeypatch, tdec, "decode_pass1")
    unpack = _count_calls(monkeypatch, tdec._sched, "unpack_variable_device")
    codec = BlockParallelCodec(spec, BS, device=_cpus(k), pass2="host")
    assert codec.decode(container) == data
    assert pass1 == [] and unpack == []


def test_stage_keys_per_device(tokyo_pixels):
    data = _data(tokyo_pixels, 5)
    spec = LzwSpec.gif(7)
    one, two = {}, {}
    BlockParallelCodec(spec, BS, device="cpu", stage_times=one).encode(data)
    container = BlockParallelCodec(spec, BS, device=_cpus(2),
                                   stage_times=two).encode(data)
    names = {"enc_host_prep", "enc_h2d", "enc_kernel", "enc_pack", "enc_d2h"}
    assert set(one) == names
    assert set(two) == {f"{n}@cpu" for n in names}
    two.clear()
    BlockParallelCodec(spec, BS, device=_cpus(2), stage_times=two,
                       pass2="device").decode(container)
    # The join of the ranges' bytes is one stage of the whole codec.
    assert "dec_d2h_out" in two and "dec_pass1@cpu" in two
    assert all(key.endswith("@cpu") for key in two if key != "dec_d2h_out")


class _Yielding(dict):
    """A dict whose item reads let another thread run between reading the
    value and returning it."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value

    def get(self, key, default=None):
        value = super().get(key, default)
        time.sleep(0)
        return value


def _hammer(fn, threads=8):
    workers = [threading.Thread(target=fn) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)


def test_stage_times_under_threads(monkeypatch):
    # Each thread's fake clock advances by exactly 1 within a stage, so
    # the sum is exact unless an update is lost.
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0) + 1
        return float(local.t)

    monkeypatch.setattr(block, "time", types.SimpleNamespace(
        perf_counter=clock))
    times = _Yielding()
    codec = BlockParallelCodec(LzwSpec.gif(7), BS, device=_cpus(8),
                               stage_times=times)
    stage = codec._stage_fn(torch.device("cpu"))

    def work():
        for _ in range(300):
            with stage("dec_pass1"):
                pass

    _hammer(work)
    assert dict(times) == {"dec_pass1@cpu": 8 * 300.0}


def test_launch_counter_under_threads(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", _Yielding(
        {name: 0 for name in build.KERNELS}))

    def work():
        for _ in range(300):
            build.check_launch("decode_pass1", 0)

    _hammer(work)
    assert build.LAUNCHES["decode_pass1"] == 8 * 300
    build.reset_counts()
    assert set(build.LAUNCHES.values()) == {0}


def test_host_call_counter_under_threads(monkeypatch):
    # chip_smoke.py counts the native decode calls of the ranges' threads.
    for name in chip_smoke.HOST_CALLS:
        monkeypatch.setattr(NativeRuntime, name, lambda self, *a, **k: None)
    monkeypatch.setattr(chip_smoke, "HOST_CALLS", _Yielding(
        {name: 0 for name in chip_smoke.HOST_CALLS}))
    chip_smoke.count_host_calls()

    def work():
        for _ in range(300):
            NativeRuntime.apply_words(None)

    _hammer(work)
    assert chip_smoke.HOST_CALLS["apply_words"] == 8 * 300


@pytest.mark.parametrize("n_blocks", [0, 1, 5, 8, 9, 64, 65])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_ranges_are_contiguous_and_balanced(n_blocks, parts):
    codec = BlockParallelCodec(LzwSpec.gif(7), BS, device=_cpus(parts))
    ranges = codec._ranges(n_blocks)
    assert [r.lo for r in ranges[1:]] == [r.hi for r in ranges[:-1]]
    if n_blocks:
        assert ranges[0].lo == 0 and ranges[-1].hi == n_blocks
        per = -(-n_blocks // parts)
        assert all(0 < r.hi - r.lo <= per for r in ranges)
    else:
        assert ranges == []
    assert [block._part_slice(n_blocks, i, parts)
            for i in range(len(ranges))] == [(r.lo, r.hi) for r in ranges]


def test_device_arguments():
    spec = LzwSpec.gif(7)
    cpu = torch.device("cpu")
    assert BlockParallelCodec(spec, device="cpu").devices == (cpu,)
    assert BlockParallelCodec(spec, device=[cpu, "cpu"]).devices == (cpu,
                                                                     cpu)
    assert default_devices("cpu") == local_devices("cpu") == [cpu]
    with pytest.raises(ValueError, match="empty"):
        BlockParallelCodec(spec, device=[])
    with pytest.raises(ValueError, match="one type"):
        BlockParallelCodec(spec, device=["cpu", "meta"])
    with pytest.raises(TypeError):
        BlockParallelCodec(spec, device=3)
    with pytest.raises(ValueError):
        default_devices("tpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in ("cuda", ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockParallelCodec(LzwSpec.gif(7), device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        local_devices()
