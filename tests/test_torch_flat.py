"""The word-offset scan and the flat pass-2 walks, on the CPU.

``word_ends`` (plain version on CPU tensors) against the prefix-sum formula
on random descriptors; the flat walks (the blocks' bytes back to back, as
the container returns them) against the padded walks' masked rows, against
the JAX package's K4 (``decode_pass2_stride2``) and K5
(``decode_pass2_device``) in interpret mode at group=128, and on corrupt
blocks, whose writes must stay inside their own range.  Inputs are made
with numpy from a seed; every comparison is of integers or bytes and exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.kernels import decode_pallas as dp
from lzw_tpu.ops import reference as oracle

from lzw_tpu_torch import BlockParallelCodec, from_reference_spec
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import nonstrict as tns
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.utils.testdata import spliced_nonstrict_stream

from test_torch_pass2 import SPECS, _datas, _jax_pass1, _matrix, _t


def _c(a):
    """A C-contiguous i32 tensor of ``a`` (the JAX rows are views)."""
    return torch.from_numpy(np.array(a, np.int32, order="C"))


def _scan_formula(words, n_codes, block_size):
    """ends[n, t] = min(sum of the live lengths of slots 0..t, block_size),
    slot by slot in Python."""
    N, S = words.shape
    ends = np.zeros((N, S), np.int64)
    for n in range(N):
        acc = 0
        for t in range(S):
            w = int(words[n, t])
            if t < n_codes[n] and (w >> 29) != tdec.KIND_HOLE:
                acc += (w >> 17) & 0xFFF
            ends[n, t] = min(acc, block_size)
    return ends


def _random_words(rng, N, S, max_len):
    kind = rng.integers(0, 8, (N, S))  # 2 is a hole; 3-7 occur in no pass 1
    lens = rng.integers(0, max_len + 1, (N, S))
    payload = rng.integers(0, 1 << 17, (N, S))
    w = ((kind << 29) | (lens << 17) | payload) & 0xFFFFFFFF
    return np.where(w >= 1 << 31, w - (1 << 32), w).astype(np.int32)


@pytest.mark.parametrize("case", ["holes", "short_rows", "clipped"])
def test_plain_scan_matches_formula(case):
    rng = np.random.default_rng({"holes": 0, "short_rows": 1,
                                 "clipped": 2}[case])
    N, S = 9, 300
    max_len, block_size = (4095, 1 << 17) if case != "clipped" else (40, 2000)
    words = _random_words(rng, N, S, max_len)
    n_codes = rng.integers(0, S + 1, N).astype(np.int32)
    if case == "short_rows":
        n_codes[:4] = [0, 1, S, S + 50]
        n_codes[4] = -3
    else:
        n_codes[0] = S
    got = tdec.word_ends(torch.from_numpy(words), torch.from_numpy(n_codes),
                         block_size)
    assert got.dtype == torch.int32 and got.shape == (N, S)
    want = _scan_formula(words, n_codes, block_size)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "clipped":
        assert (want == block_size).any() and (want < block_size).any()
    assert (got.numpy()[n_codes <= 0] == 0).all()


def test_word_ends_checks_inputs():
    w = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_size"):
        tdec.word_ends(w, n, tdec.MAX_BLOCK + 1)
    with pytest.raises(ValueError, match="block count"):
        tdec.word_ends(w, n[:1].contiguous(), 64)
    with pytest.raises(TypeError):
        tdec.word_ends(w.long(), n, 64)
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.word_ends(meta, torch.empty(2, dtype=torch.int32,
                                         device="meta"), 64)


def test_walk_plan_places_the_blocks_back_to_back():
    # The walks' launch inputs: the word ends, and in flat mode each block's
    # offset, the exclusive prefix sum of its totals (a negative total, which
    # no pass 1 gives, counts 0), and the output size.
    rng = np.random.default_rng(40)
    N, S = 14, 700
    n_codes = rng.integers(0, S + 1, N).astype(np.int32)
    totals = rng.integers(0, 4096, N).astype(np.int32)
    totals[2] = -5
    words = torch.from_numpy(_random_words(rng, N, S, 30))
    plan = tdec._walk_plan(words, torch.from_numpy(n_codes),
                           torch.from_numpy(totals), 4096)
    np.testing.assert_array_equal(
        plan.ends.numpy(), _scan_formula(words.numpy(), n_codes, 4096))
    t64 = np.maximum(totals, 0)
    assert plan.base.tolist() == (np.cumsum(t64) - t64).tolist()
    assert plan.size == int(t64.sum())
    padded = tdec._walk_plan(words, torch.from_numpy(n_codes), None, 4096)
    assert padded.base is None and padded.size == N * 4096
    empty = tdec._walk_plan(words[:0], torch.from_numpy(n_codes[:0]),
                            torch.from_numpy(totals[:0]), 4096)
    assert empty.size == 0 and empty.base.numel() == 0


def _pass1(name, datas, block_size, stride2):
    """The port's plain pass 1 of ``datas``' oracle payloads: (codes,
    n_codes, words, totals, err, pair, sched, spec or None)."""
    spec = SPECS[name]
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    rows = "stride2" if stride2 else "stride1"
    if not spec.variable:
        mat, plens = _matrix(payloads, 3)
        words, nc, tot, err, _, codes, pair = tdec.decode_pass1_fixed(
            torch.from_numpy(mat), torch.from_numpy(plens), block_size,
            rows=rows)
        return codes, nc, words, tot, err, pair, None, None
    mat, plens = _matrix(payloads)
    pspec = from_reference_spec(spec)
    p = tdec.variable_pass1(mat, plens, pspec, block_size, device="cpu",
                            rows=rows)
    assert p.strict.all()
    return p.dense, p.counts_t, p.words, p.totals, p.err, p.pair, p.sched, pspec


def _walks(stride2):
    if stride2:
        return tdec.decode_pass2_stride2, tdec.decode_pass2_stride2_flat
    return tdec.decode_pass2_device, tdec.decode_pass2_device_flat


def _masked(padded, totals):
    """The padded rows' first totals[n] bytes, back to back."""
    return b"".join(padded[i, : int(t)].numpy().tobytes()
                    for i, t in enumerate(totals))


@pytest.mark.parametrize("stride2", [True, False], ids=["stride2", "stride1"])
@pytest.mark.parametrize("name", list(SPECS))
def test_flat_walks_equal_padded_masked(name, stride2):
    datas = _datas(SPECS[name], seed=30, sizes=(0, 1, 1, 700, 0, 3000))
    codes, nc, words, tot, err, pair, sched, spec = _pass1(
        name, datas, 4096, stride2)
    assert not err.any()
    padded, flat = _walks(stride2)
    want = _masked(padded(codes, words, pair, nc, 4096, spec, sched), tot)
    got = flat(codes, words, pair, nc, tot, 4096, spec, sched)
    assert got.dtype == torch.uint8 and got.dim() == 1
    assert got.numpy().tobytes() == want == b"".join(datas)


@pytest.mark.parametrize("stride2", [True, False], ids=["stride2", "stride1"])
@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_all_device_flat_equals_padded(name, stride2):
    spec = SPECS[name]
    datas = _datas(spec, seed=31, sizes=(1, 0, 2500))
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    if spec.variable:
        mat, plens = _matrix(payloads)
        pspec = from_reference_spec(spec)
        runs = [tdec.decode_variable_all_device(
            mat, plens, pspec, 4096, device="cpu", stride2=stride2,
            flat=f)
            for f in (False, True)]
    else:
        mat, plens = _matrix(payloads, 3)
        runs = [tdec.decode_fixed_all_device(
            torch.from_numpy(mat), torch.from_numpy(plens), 4096,
            stride2=stride2, flat=f) for f in (False, True)]
    (padded, tot, *rest), (flat, tot_f, *rest_f) = runs
    assert torch.equal(tot, tot_f)
    for a, b in zip(rest, rest_f):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert flat.numpy().tobytes() == _masked(padded, tot) == b"".join(datas)


@pytest.mark.parametrize("name", list(SPECS))
def test_flat_stride2_walk_matches_jax(name):
    # K4 in interpret mode on blocks of one dictionary epoch (its unit-local
    # rows), masked to each block's total.
    spec = SPECS[name]
    datas = _datas(spec, seed=32, sizes=(0, 1, 2, 300, 1500))
    (codes, nc, words, tot, err, pair, sched), pair4d = _jax_pass1(
        name, datas, 4096)
    assert not err.any()
    want = np.asarray(dp.decode_pass2_stride2(
        jnp.asarray(codes), pair4d, jnp.asarray(nc), jnp.asarray(tot), 4096,
        alphabet=spec.alphabet_size if spec.variable else 256,
        interpret=True, group=128, cell=64, seg=32,
        first_free=spec.first_free_code if spec.variable else 256,
    ))
    pspec = from_reference_spec(spec)
    S = codes.shape[1]
    got = tdec.decode_pass2_stride2_flat(
        _t(codes), _c(words[:, :S]), _c(pair[:, :S]), _t(nc), _t(tot), 4096,
        pspec if spec.variable else None,
        None if sched is None else _t(sched)).numpy()
    assert got.tobytes() == b"".join(
        want[i, : int(t)].tobytes() for i, t in enumerate(tot))
    assert got.tobytes() == b"".join(datas)


@pytest.mark.parametrize("name", list(SPECS))
def test_flat_stride1_walk_matches_jax(name):
    # K5 in interpret mode; variable codes carry their step's epoch start
    # in their high bits, as the JAX package's whole-stream route gives it.
    spec = SPECS[name]
    datas = _datas(spec, seed=33, sizes=(0, 1, 2, 300, 1500))
    (codes, nc, words, tot, err, pair, sched), pair4d = _jax_pass1(
        name, datas, 4096, pair2=False)
    assert not err.any()
    if spec.variable:
        want = dp.decode_pass2_device(
            jnp.asarray(codes | (sched[1][None, :] << 12)), pair4d,
            jnp.asarray(nc), jnp.asarray(tot), 4096,
            alphabet=spec.alphabet_size, interpret=True, group=128, cell=64,
            seg=64, variable=True)
    else:
        want = dp.decode_pass2_device(
            jnp.asarray(codes), pair4d, jnp.asarray(nc), jnp.asarray(tot),
            4096, interpret=True, group=128, cell=64, seg=64)
    want = np.asarray(want)
    pspec = from_reference_spec(spec)
    S = codes.shape[1]
    got = tdec.decode_pass2_device_flat(
        _t(codes), _c(words[:, :S]), _c(pair[:, :S]), _t(nc), _t(tot), 4096,
        pspec if spec.variable else None,
        None if sched is None else _t(sched)).numpy()
    assert got.tobytes() == b"".join(
        want[i, : int(t)].tobytes() for i, t in enumerate(tot))
    assert got.tobytes() == b"".join(datas)


def _alone(name, datas, stride2, i):
    """Block i's flat bytes decoded on its own."""
    codes, nc, words, tot, _, pair, sched, spec = _pass1(
        name, [datas[i]], 4096, stride2)
    return _walks(stride2)[1](codes, words, pair, nc, tot, 4096, spec,
                              sched).numpy().tobytes()


@pytest.mark.parametrize("stride2", [True, False], ids=["stride2", "stride1"])
@pytest.mark.parametrize("name", ["gif7", "tiff", "fixed"])
def test_corrupt_middle_block_stays_in_its_range(name, stride2):
    # The middle block's descriptors claim long words and its pair rows are
    # noise: its writes stay inside [0, min(total, block_size)) of its own
    # range, and both neighbours read as they do alone.
    datas = _datas(SPECS[name], seed=34, sizes=(900, 1200, 700))[:3]
    codes, nc, words, tot, _, pair, sched, spec = _pass1(
        name, datas, 4096, stride2)
    rng = np.random.default_rng(35)
    words, pair, codes = words.clone(), pair.clone(), codes.clone()
    live = int(nc[1])
    words[1, :live] = (words[1, :live] & ~(0xFFF << 17)) | (4000 << 17)
    pair[1] = torch.from_numpy(rng.integers(-2**31, 2**31, pair.shape[1])
                               .astype(np.int32))
    codes[1, :live] = torch.from_numpy(
        rng.integers(0, 4096, live).astype(np.int32))
    flat = _walks(stride2)[1](codes, words, pair, nc, tot, 4096, spec,
                              sched).numpy()
    assert flat.size == int(tot.sum())
    b1, b2 = int(tot[0]), int(tot[0]) + int(tot[1])
    assert flat[:b1].tobytes() == _alone(name, datas, stride2, 0) == datas[0]
    assert flat[b2:].tobytes() == _alone(name, datas, stride2, 2) == datas[2]


def test_pass1_error_block_leaves_its_neighbours():
    # A gif2 block whose second code (7) is past the next index: pass 1
    # stops it there, and the flat walk leaves the blocks around it whole.
    from lzw_tpu.kernels import schedule as jsched

    spec = SPECS["gif2"]
    datas = _datas(spec, seed=36, sizes=(500, 800))[:2]
    bad, nb = jsched.pack_variable(np.array([[1, 7, 2, 0]], np.int32),
                                   np.array([3], np.int32), spec)
    payloads = [oracle.encode_bytes(datas[0], spec), bad[0, : nb[0]].tobytes(),
                oracle.encode_bytes(datas[1], spec)]
    mat, plens = _matrix(payloads)
    flat, tot, errs, ecs, strict = tdec.decode_variable_all_device(
        mat, plens, from_reference_spec(spec), 4096, device="cpu",
        flat=True)
    assert int(errs[1]) == 1 and int(ecs[1]) == 7 and not errs[[0, 2]].any()
    b = flat.numpy().tobytes()
    assert len(b) == int(tot.sum())
    assert b[: len(datas[0])] == datas[0]
    assert b[len(b) - len(datas[1]):] == datas[1]


def test_flat_wrapper_checks_totals():
    codes = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block count"):
        tdec.decode_pass2_stride2_flat(codes, codes, codes, n,
                                       n[:1].contiguous(), 64)
    with pytest.raises(TypeError):
        tdec.decode_pass2_device_flat(codes, codes, codes, n, n.long(), 64)
    empty = tdec.decode_pass2_stride2_flat(codes, codes, codes, n, n, 64)
    assert empty.shape == (0,) and empty.dtype == torch.uint8


def test_to_host_keeps_cpu_bytes():
    flat = torch.arange(10, dtype=torch.uint8)
    assert tdec.to_host(flat).tobytes() == bytes(range(10))


def test_container_device_route_checks_the_length(lorem_ipsum):
    # The flat bytes are checked against the container's size before the
    # copy to the host: a container that claims one byte more is refused.
    spec = from_reference_spec(SPECS["gif7"])
    data = lorem_ipsum[:5000]
    codec = BlockParallelCodec(spec, block_size=2048, device="cpu",
                               pass2="device", stage_times={})
    _, payloads = framing.parse_frame(codec.encode(data))
    good = framing.pack_frame(spec, 2048, len(data), payloads)
    assert codec.decode(good) == data
    assert "dec_d2h_out" in codec.stage_times
    with pytest.raises(framing.FramingError, match="claims 5001"):
        codec.decode(framing.pack_frame(spec, 2048, len(data) + 1, payloads))


def test_nonstrict_flat_decode_equals_native_decode_blocks(lorem_ipsum):
    spec = from_reference_spec(SPECS["gif7"])
    bs = 4096
    data = lorem_ipsum[:3 * bs + 500]
    payloads = [spliced_nonstrict_stream(data[i : i + bs], spec, 900)
                for i in range(0, len(data), bs)]
    mat = np.zeros((len(payloads), max(map(len, payloads))), np.uint8)
    plens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    got = tns.decode_variable_nonstrict_device(mat, plens, spec, bs,
                                               device="cpu")
    assert b"".join(got) == get_runtime().decode_blocks(payloads, spec, bs)
    assert b"".join(got) == data
