"""The port's all-device decode against the JAX package's, on the CPU.

Pass 1's stride-2 pair rows, the plain pass 2, the strict variable and
fixed all-device decodes, and the container's ``pass2="device"`` route.
The JAX side runs its Pallas kernels in interpret mode at small shapes
(group=128 rows), as tests/test_epoch_split.py does; the port runs on CPU
tensors, i.e. the plain versions.  Inputs are made with numpy from a seed.
Codes, descriptors and bytes are integers: every comparison is exact
(tolerance 0).  The JAX package lays pass-1 rows out as (G, S, sub, 128);
the port keeps block-major [N, S].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.kernels import decode_pallas as dp
from lzw_tpu.kernels import schedule as jsched
from lzw_tpu.ops import reference as oracle
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec
from lzw_tpu.spec import TruncatedStreamError as JTruncated
from lzw_tpu.spec import UnexpectedCodeError as JUnexpected

from lzw_tpu_torch import (
    BlockParallelCodec, TruncatedStreamError, UnexpectedCodeError,
    from_reference_spec,
)
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.native.runtime import NativeRuntime
from lzw_tpu_torch.parallel import framing

N = 128  # one JAX kernel group
SPECS = {"gif7": JSpec.gif(7), "gif2": JSpec.gif(2), "tiff": JSpec.tiff(),
         "fixed": JSpec.fixed(JEndianness.LITTLE)}
VARIABLE = ["gif7", "gif2", "tiff"]


def _datas(spec, seed, sizes=(0, 1, 300, 2000, 4000)):
    """Random and compressible blocks in the spec's alphabet."""
    rng = np.random.default_rng(seed)
    hi = spec.max_code_value + 1 if spec.variable else 256
    out = [rng.integers(0, hi, size=n).astype(np.uint8).tobytes()
           for n in sizes]
    motif = rng.integers(0, hi, size=7).astype(np.uint8).tobytes()
    return out + [(motif * 600)[:4000], bytes([hi - 1]) * 3000]


def _matrix(payloads, multiple=1):
    pb = max(max(len(p) for p in payloads), 1)
    pb = -(-pb // multiple) * multiple
    mat = np.zeros((N, pb), np.uint8)
    plens = np.zeros(N, np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    return mat, plens


def _rows(pair4d):
    """JAX (G, S, sub, 128) pass-1 rows -> block-major [N, S]."""
    a = np.asarray(pair4d)
    G, S, sub, lanes = a.shape
    return a.transpose(0, 2, 3, 1).reshape(G * sub * lanes, S)


def _jax_pass1(name, datas, block_size, pair2=True):
    """JAX pass 1 with stride-2 rows (``pair2``) or stride-1 rows.  Returns
    (codes, n_codes, words, totals, errs, pair, sched) as numpy, pair
    block-major and sched None for fixed-12, and the JAX layout of the pair
    rows."""
    spec = SPECS[name]
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    if not spec.variable:
        mat, plens = _matrix(payloads, 3)
        words, nc, tot, err, _, (pair, codes) = dp.decode_pass1_fixed_tpu(
            jnp.asarray(mat), jnp.asarray(plens), block_size, interpret=True,
            group=128, cell=64, seg=64, pair2=pair2,
        )
        return (np.asarray(codes), np.asarray(nc), np.asarray(words),
                np.asarray(tot), np.asarray(err), _rows(pair), None), pair
    mat, plens = _matrix(payloads)
    counts, strict, sched, S = dp.prepare_variable_decode(mat, plens, spec, 64)
    assert strict.all()
    words, stats, pair, dense, ok = dp._variable_pass1_from_payloads(
        jnp.asarray(mat), jnp.asarray(counts.astype(np.int32)),
        jnp.asarray(sched), spec, S, block_size, True, 128, 64, 64,
        pair2=pair2,
    )
    assert np.asarray(ok).all()
    stats = np.asarray(stats)
    return (np.asarray(dense), counts.astype(np.int32), np.asarray(words),
            stats[:, 0], stats[:, 1], _rows(pair), sched), pair


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


@pytest.mark.parametrize("name", list(SPECS))
def test_pair2_rows_match_jax(name):
    datas = _datas(SPECS[name], seed=1)
    (codes, nc, words, tot, err, pair, sched), _ = _jax_pass1(name, datas,
                                                              8192)
    spec = from_reference_spec(SPECS[name])
    S = codes.shape[1]
    got = tdec.decode_pass1(
        _t(codes), _t(nc), spec if spec.variable else None, 8192,
        None if sched is None else _t(sched), rows="stride2",
    )
    p_words, p_tot, p_err, _, p_pair = (a.numpy() for a in got)
    np.testing.assert_array_equal(p_err, err)
    np.testing.assert_array_equal(p_tot, tot)
    np.testing.assert_array_equal(p_words, words[:, :S])
    np.testing.assert_array_equal(p_pair, pair[:, :S])
    assert (p_pair != 0).any()
    # The kind of pair rows leaves the other outputs as they were without
    # them.
    for rows, n_out in (("none", 4), ("stride1", 5)):
        other = tdec.decode_pass1(
            _t(codes), _t(nc), spec if spec.variable else None, 8192,
            None if sched is None else _t(sched), rows=rows)
        assert len(other) == n_out
        for a, b in zip(got[:4], other[:4]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(SPECS))
def test_plain_pass2_matches_jax(name):
    # Blocks of one dictionary epoch: the JAX walker's unit-local rows.
    spec = SPECS[name]
    datas = _datas(spec, seed=2, sizes=(0, 1, 2, 300, 1500))
    (codes, nc, words, tot, err, pair, sched), pair4d = _jax_pass1(
        name, datas, 4096)
    assert not err.any()
    if sched is not None:
        assert not sched[1].any(), "one epoch per block"
    want = np.asarray(dp.decode_pass2_stride2(
        jnp.asarray(codes), pair4d, jnp.asarray(nc), jnp.asarray(tot), 4096,
        alphabet=spec.alphabet_size if spec.variable else 256,
        interpret=True, group=128, cell=64, seg=32,
        first_free=spec.first_free_code if spec.variable else 256,
    ))
    pspec = from_reference_spec(spec)
    got = tdec.decode_pass2_stride2_reference(
        _t(codes), _t(words), _t(pair), _t(nc), 4096,
        pspec if spec.variable else None,
        None if sched is None else _t(sched),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    for i, d in enumerate(datas):
        assert got[i, : len(d)].tobytes() == d


@pytest.mark.parametrize("name", VARIABLE + ["cs8_multi_epoch"])
def test_variable_all_device_matches_jax(name):
    if name == "cs8_multi_epoch":
        spec = JSpec.variable(8, JEndianness.BIG)
        datas = _datas(spec, seed=3, sizes=(0, 1, 6000, 5000))
    else:
        spec = SPECS[name]
        datas = _datas(spec, seed=3)
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    mat, plens = _matrix(payloads)
    counts, _, sched, S = dp.prepare_variable_decode(mat, plens, spec)
    if name == "cs8_multi_epoch":
        assert sched[1].any(), "no dictionary reset"
    out, tot, errs, ecs, strict = dp.decode_variable_all_device(
        mat, plens, spec, 8192, interpret=True, group=128, cell=64, seg=64,
        group2=128, seg2=64,
    )
    p_out, p_tot, p_errs, p_ecs, p_strict = tdec.decode_variable_all_device(
        mat, plens, from_reference_spec(spec), 8192, device="cpu")
    np.testing.assert_array_equal(p_strict, strict)
    np.testing.assert_array_equal(p_tot.numpy(), np.asarray(tot))
    np.testing.assert_array_equal(p_errs.numpy(), np.asarray(errs))
    np.testing.assert_array_equal(p_ecs.numpy(), np.asarray(ecs))
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(out))
    for i, d in enumerate(datas):
        assert p_out[i, : len(d)].numpy().tobytes() == d


@pytest.mark.parametrize("little", [True, False], ids=["le", "be"])
def test_fixed_all_device_round_trip(little):
    spec = JSpec.fixed(JEndianness.LITTLE if little else JEndianness.BIG)
    datas = _datas(spec, seed=4)
    mat, plens = _matrix([oracle.encode_bytes(d, spec) for d in datas], 3)
    out, tot, errs, _ = tdec.decode_fixed_all_device(
        torch.from_numpy(mat), torch.from_numpy(plens), 4096, little
    )
    assert not errs.any()
    for i, d in enumerate(datas):
        assert int(tot[i]) == len(d)
        assert out[i, : len(d)].numpy().tobytes() == d
    assert not out[len(datas):].any()


def test_pass2_wrapper_checks_inputs():
    codes = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # pair rows of another shape
        tdec.decode_pass2_stride2(codes, codes, codes[:, :3].contiguous(), n,
                                  64)
    with pytest.raises(ValueError):  # variable spec without schedule rows
        tdec.decode_pass2_stride2(codes, codes, codes, n, 64,
                                  from_reference_spec(JSpec.gif(7)))
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_pass2_stride2(meta, meta, meta,
                                  torch.empty(2, dtype=torch.int32,
                                              device="meta"), 64)


# ---- the container's pass2="device" route ---------------------------------


@pytest.fixture
def no_host(monkeypatch):
    """Fail any call of the native runtime's decode entry points."""
    def host_called(*args, **kwargs):
        raise AssertionError("the device route called the native runtime")

    monkeypatch.setattr(NativeRuntime, "apply_words", host_called)
    monkeypatch.setattr(NativeRuntime, "decode_blocks", host_called)


def _device_codec(spec, block_size):
    return BlockParallelCodec(from_reference_spec(spec), block_size=block_size,
                              device="cpu", pass2="device")


@pytest.mark.parametrize("name", list(SPECS))
def test_container_device_route_round_trip(name, tokyo_pixels, no_host):
    spec = SPECS[name]
    hi = spec.max_code_value + 1 if spec.variable else 256
    data = bytes(b % hi for b in tokyo_pixels[:20000] + bytes(range(100)))
    container = JaxCodec(SPECS[name], block_size=4096).encode(data)
    codec = _device_codec(SPECS[name], 4096)
    assert codec.decode(container) == data
    assert codec.decode_range(container, 1, 3) == data[4096:12288]


def test_container_corrupt_stream_same_error_as_jax(no_host):
    # A strict gif2 stream whose second data code (7) is past the next
    # index (6): the JAX codec and the device route both name code 7.
    spec = JSpec.gif(2)
    pay, nb = jsched.pack_variable(np.array([[1, 7, 2, 0]], np.int32),
                                   np.array([3], np.int32), spec)
    container = framing.pack_frame(from_reference_spec(spec), 64, 4,
                                   [pay[0, : nb[0]].tobytes()])
    with pytest.raises(JUnexpected) as want:
        JaxCodec(spec, block_size=64).decode(container)
    with pytest.raises(UnexpectedCodeError) as got:
        _device_codec(spec, 64).decode(container)
    assert got.value.code == want.value.code == 7


def test_container_fixed_corrupt_code_same_error_as_jax(no_host):
    spec = JSpec.fixed(JEndianness.LITTLE)
    bad = oracle.pack_codes([(65, 12), (3000, 12)], JEndianness.LITTLE)
    container = framing.pack_frame(from_reference_spec(spec), 64, 2, [bad])
    with pytest.raises(JUnexpected) as want:
        JaxCodec(spec, block_size=64).decode(container)
    with pytest.raises(UnexpectedCodeError) as got:
        _device_codec(spec, 64).decode(container)
    assert got.value.code == want.value.code == 3000


def test_container_truncated_stream_same_error_as_jax(lorem_ipsum, no_host):
    spec = JSpec.gif(7)
    payload = oracle.encode_bytes(lorem_ipsum[:3000], spec)
    container = framing.pack_frame(from_reference_spec(spec), 4096, 3000,
                                   [payload[: len(payload) // 2]])
    with pytest.raises(JTruncated):
        JaxCodec(spec, block_size=4096).decode(container)
    with pytest.raises(TruncatedStreamError):
        _device_codec(spec, 4096).decode(container)


def test_pass2_route_option():
    spec = from_reference_spec(JSpec.gif(7))
    with pytest.raises(ValueError, match="pass2"):
        BlockParallelCodec(spec, device="cpu", pass2="gpu")
    # Blocks past MAX_BLOCK take the single-stream decoder on the device
    # route (tests/test_torch_stream.py).
    assert BlockParallelCodec(spec, block_size=tdec.MAX_BLOCK + 1,
                              device="cpu", pass2="device").pass2 == "device"
    assert BlockParallelCodec(spec, device="cpu").pass2 == "auto"


def test_auto_route_takes_the_device_without_the_runtime(monkeypatch,
                                                         lorem_ipsum):
    # The JAX codec's rule: no native runtime -> the all-device decode.
    import lzw_tpu_torch.parallel.block as block

    spec = from_reference_spec(JSpec.gif(7))
    container = BlockParallelCodec(spec, block_size=2048,
                                   device="cpu").encode(lorem_ipsum[:5000])

    def no_runtime():
        raise OSError("no compiler")

    monkeypatch.setattr(block, "get_runtime", no_runtime)
    codec = BlockParallelCodec(spec, block_size=2048, device="cpu")
    assert codec.decode(container) == lorem_ipsum[:5000]
    with pytest.raises(OSError):
        BlockParallelCodec(spec, block_size=2048, device="cpu",
                           pass2="host").decode(container)


@pytest.mark.parametrize("device,pass2,strict_on_host,nonstrict_native", [
    ("cpu", "auto", True, True),
    ("cuda", "auto", False, True),
    ("cpu", "host", True, True),
    ("cuda", "host", True, True),
    ("cpu", "device", False, False),
    ("cuda", "device", False, False),
])
def test_route_choice(device, pass2, strict_on_host, nonstrict_native):
    # "auto" on a CUDA device resolves strict blocks with the pass-2 kernel
    # and leaves non-strict ones to the native runtime; off the card both go
    # to the native runtime.  The device is set after construction so the
    # CUDA rows run without a card.
    codec = BlockParallelCodec(from_reference_spec(JSpec.gif(7)),
                               device="cpu", pass2=pass2)
    codec.device = torch.device(device)
    assert (codec._host_pass2() is not None) == strict_on_host
    assert (codec._native() is not None) == nonstrict_native


def test_auto_route_on_the_cpu_calls_apply_words(monkeypatch, lorem_ipsum):
    spec = from_reference_spec(JSpec.gif(7))
    data = lorem_ipsum[:6000]
    container = BlockParallelCodec(spec, block_size=2048,
                                   device="cpu").encode(data)
    calls = []
    apply_words = NativeRuntime.apply_words

    def counted(self, *args, **kwargs):
        calls.append(1)
        return apply_words(self, *args, **kwargs)

    monkeypatch.setattr(NativeRuntime, "apply_words", counted)
    assert BlockParallelCodec(spec, block_size=2048,
                              device="cpu").decode(container) == data
    assert calls == [1]


def test_runtime_build_failure_is_cached(monkeypatch):
    # A box without a compiler: the first call tries the build, later calls
    # raise the same error without starting the compiler again.
    from lzw_tpu_torch.native import runtime

    tries = []

    def failing_build(*args, **kwargs):
        tries.append(1)
        raise OSError("no compiler")

    monkeypatch.setattr(runtime, "_runtime", None)
    monkeypatch.setattr(runtime, "_build_error", None)
    monkeypatch.setattr(runtime, "NativeRuntime", failing_build)
    for _ in range(3):
        with pytest.raises(OSError, match="no compiler"):
            runtime.get_runtime()
    assert tries == [1]
