"""The port's plain encode parse against the JAX package's Pallas kernels.

The JAX side runs as its own tests run it (interpret mode, group=128, small
cells); the port runs ``encode_blocks_codes`` on CPU tensors, which is the
plain ``encode_blocks_codes_reference``.  Codes are integers, so every
comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.kernels import encode_pallas
from lzw_tpu.ops import reference as oracle
from lzw_tpu.spec import CodeSizeStrategy, Endianness, LzwSpec

from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.spec import from_reference_spec

SPECS = {
    "gif2": LzwSpec.gif(2), "gif7": LzwSpec.gif(7), "tiff": LzwSpec.tiff(),
    "var4": LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF),
}


def _matrix(blocks_list, B, rows):
    mat = np.zeros((rows, B), np.uint8)
    lens = np.zeros(rows, np.int32)
    for i, b in enumerate(blocks_list):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return mat, lens


def _port(blocks_list, spec, B):
    mat, lens = _matrix(blocks_list, B, len(blocks_list))
    out = tenc.encode_blocks_codes(
        torch.from_numpy(mat), torch.from_numpy(lens),
        None if spec is None else from_reference_spec(spec),
    )
    return [t.numpy() for t in out]


def _assert_same(jax_out, port_out, n):
    dense, counts, errs, err_codes = (np.asarray(a)[:n] for a in jax_out)
    p_dense, p_counts, p_errs, p_err_codes = port_out
    np.testing.assert_array_equal(p_counts, counts)
    np.testing.assert_array_equal(p_errs, errs)
    np.testing.assert_array_equal(p_err_codes, err_codes)
    for i in range(n):
        c = counts[i]
        np.testing.assert_array_equal(p_dense[i, :c], dense[i, :c],
                                      err_msg=f"block {i}")
        assert not p_dense[i, c:].any(), f"block {i}: nonzero past count"


def _random_blocks(seed, hi, n=8, max_len=128):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, hi, size=int(rng.integers(0, max_len + 1))).astype(
            np.uint8).tobytes()
        for _ in range(n)
    ]


@pytest.mark.parametrize("name", list(SPECS))
def test_stage_kernel_shapes(name):
    # K2 (single-launch stage kernel) shapes of
    # tests/test_encode_pallas_variable.py::test_stage_variant_matches_oracle.
    spec = SPECS[name]
    blocks = _random_blocks(6, 1 << spec.code_size) + [
        bytes(b % (1 << spec.code_size) for b in
              (b"compressible text " * 8)[:128]),
        bytes([1] * 128), b"",
    ]
    mat, lens = _matrix(blocks, 128, 128)
    want = encode_pallas.encode_blocks_variable_codes_tpu(
        jnp.asarray(mat), jnp.asarray(lens), spec, 128,
        interpret=True, group=128, cell=64, seg=64, compact="stage",
    )
    _assert_same(want, _port(blocks, spec, 128), len(blocks))


def test_chunked_kernel_shapes():
    # K1 (chunked driver) shapes of test_chunked_variable_matches_oracle.
    spec = LzwSpec.gif(7)
    rng = np.random.default_rng(31)
    B = 1024
    blocks = [
        (b"the quick brown fox jumps " * 64)[:B],
        rng.integers(0, 128, size=B).astype(np.uint8).tobytes(),
        b"",
        rng.integers(0, 128, size=700).astype(np.uint8).tobytes(),
    ]
    mat, lens = _matrix(blocks, B, 128)
    want = encode_pallas.encode_blocks_variable_codes_tpu(
        jnp.asarray(mat), jnp.asarray(lens), spec, B,
        interpret=True, group=128, cell=128, seg=128, chunk=512,
    )
    _assert_same(want, _port(blocks, spec, B), len(blocks))


def test_chunked_dictionary_reset():
    # Random bytes at cs=8 overflow the table inside the third chunk
    # (test_chunked_variable_dictionary_reset): the CLEAR reset must match.
    spec = LzwSpec.variable(8, Endianness.LITTLE)
    rng = np.random.default_rng(33)
    B = 4224
    blocks = [rng.integers(0, 256, size=B).astype(np.uint8).tobytes(),
              b"ab" * (B // 2)]
    mat, lens = _matrix(blocks, B, 128)
    want = encode_pallas.encode_blocks_variable_codes_tpu(
        jnp.asarray(mat), jnp.asarray(lens), spec, B,
        interpret=True, group=128, cell=128, seg=128, chunk=1152,
    )
    got = _port(blocks, spec, B)
    _assert_same(want, got, 2)
    assert got[1][0] > 4096 - spec.first_free_code, "no reset exercised"


@pytest.mark.parametrize("little", [True, False], ids=["le", "be"])
def test_fixed_stage_kernel(little):
    # Fixed-12 through the K2 stage kernel: dense codes and packed payloads.
    blocks = _random_blocks(0, 256) + [bytes([7] * 120), b"ab" * 64, b""]
    mat, lens = _matrix(blocks, 128, 128)
    n = len(blocks)
    want = encode_pallas._run_encode_kernel(
        jnp.asarray(mat), jnp.asarray(lens), 128, None, True, 128, 64, 64,
        compact="stage",
    )
    _assert_same(want, _port(blocks, None, 128), n)
    pay, nb = encode_pallas.encode_blocks_fixed_tpu(
        jnp.asarray(mat), jnp.asarray(lens), 128, little=little,
        interpret=True, group=128, cell=64, seg=64,
    )
    p_pay, p_nb = tenc.encode_blocks_fixed(
        torch.from_numpy(mat[:n]), torch.from_numpy(lens[:n]), little
    )
    np.testing.assert_array_equal(p_nb.numpy(), np.asarray(nb)[:n])
    pay = np.asarray(pay)
    for i in range(n):
        assert bytes(p_pay[i, : p_nb[i]].numpy()) == bytes(pay[i, : nb[i]])


def test_fixed_table_freeze():
    # Fixed-12 past 3840 misses: the table freezes at 4096 entries.  Held
    # against the JAX package's scalar oracle (the interpret-mode kernel at
    # this size is marked slow in the JAX suite).
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=4608).astype(np.uint8).tobytes()
    spec = LzwSpec.fixed(Endianness.LITTLE)
    mat, lens = _matrix([data], len(data), 1)
    pay, nb = tenc.encode_blocks_fixed(torch.from_numpy(mat),
                                       torch.from_numpy(lens), little=True)
    assert bytes(pay[0, : nb[0]].numpy()) == oracle.encode_bytes(data, spec)
    assert _port([data], None, len(data))[1][0] > 4096 - 256, "never froze"


@pytest.mark.parametrize("compact", [False, "bucket", True],
                         ids=["k6_step", "k7_bucket", "k8_compact"])
@pytest.mark.parametrize("name", ["gif7", "tiff", "fixed"])
def test_legacy_kernels(name, compact):
    # K6 (step-indexed table), K7 (bucketed table) and K8 (per-cell
    # compaction) differ from K2 only in the TPU's dictionary layout and
    # write the same step slots, so the port's one parse kernel stands for
    # them.  Shapes of the JAX variant tests (tests/test_encode_pallas*.py):
    # 128-byte blocks, as compact=False's step-indexed table allows at most
    # 4 KiB; interpret mode, group 128, cell 64.
    spec = None if name == "fixed" else SPECS[name]
    hi = 256 if spec is None else 1 << spec.code_size
    blocks = _random_blocks(len(name), hi) + [
        bytes(b % hi for b in (b"compressible text " * 8)[:128]),
        bytes([3] * 100), b"",
    ]
    mat, lens = _matrix(blocks, 128, 128)
    n = len(blocks)
    kw = dict(interpret=True, group=128, cell=64, seg=64, compact=compact)
    if spec is not None:
        want = encode_pallas.encode_blocks_variable_codes_tpu(
            jnp.asarray(mat), jnp.asarray(lens), spec, 128, **kw)
        _assert_same(want, _port(blocks, spec, 128), n)
        return
    want = encode_pallas._run_encode_kernel(
        jnp.asarray(mat), jnp.asarray(lens), 128, None, True, 128, 64, 64,
        compact=compact,
    )
    _assert_same(want, _port(blocks, None, 128), n)
    pay, nb = encode_pallas.encode_blocks_fixed_tpu(
        jnp.asarray(mat), jnp.asarray(lens), 128, little=True, **kw)
    p_pay, p_nb = tenc.encode_blocks_fixed(
        torch.from_numpy(mat[:n]), torch.from_numpy(lens[:n]), True)
    np.testing.assert_array_equal(p_nb.numpy(), np.asarray(nb)[:n])
    pay = np.asarray(pay)
    for i in range(n):
        assert bytes(p_pay[i, : p_nb[i]].numpy()) == bytes(pay[i, : nb[i]])


@pytest.mark.parametrize("data, err, code", [
    (bytes([0, 1, 8, 3]), 1, 8),      # out-of-range byte after the first
    (bytes([200]), 0, 0),             # the first byte is never checked
    (bytes([200, 1, 2, 250, 1]), 1, 250),
], ids=["later_byte", "first_byte", "both"])
def test_out_of_range_byte(data, err, code):
    spec = LzwSpec.gif(2)
    mat, lens = _matrix([data], 128, 128)
    want = encode_pallas.encode_blocks_variable_codes_tpu(
        jnp.asarray(mat), jnp.asarray(lens), spec, 128,
        interpret=True, group=128, cell=64, seg=64,
    )
    got = _port([data], spec, 128)
    _assert_same(want, got, 1)
    assert (got[2][0], got[3][0]) == (err, code)


def test_wrapper_checks_inputs():
    blocks = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tenc.encode_blocks_codes(blocks, torch.zeros(2, dtype=torch.int64),
                                 None)
    with pytest.raises(ValueError):
        tenc.encode_blocks_codes(blocks, torch.zeros(3, dtype=torch.int32),
                                 None)
    with pytest.raises(ValueError):
        tenc.encode_blocks_codes(blocks.t(), torch.zeros(8, dtype=torch.int32),
                                 None)
