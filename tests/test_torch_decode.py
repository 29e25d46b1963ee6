"""The port's plain decode pass 1 against the JAX package's Pallas pass 1.

The JAX side runs in interpret mode at the shapes of
tests/test_decode_pallas.py (group=128, cell=64, seg=64); the port runs on
CPU tensors, i.e. ``decode_pass1_reference``.  Descriptors, totals and error
planes are integers: every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.kernels import decode_pallas, schedule as jsched
from lzw_tpu.ops import reference as oracle
from lzw_tpu.spec import Endianness, LzwSpec

from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.spec import from_reference_spec

FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FIXED_BE = LzwSpec.fixed(Endianness.BIG)


def _matrix(payload_list, rows, multiple=1):
    pb = max((len(p) for p in payload_list), default=1)
    pb = max(((pb + multiple - 1) // multiple) * multiple, multiple)
    mat = np.zeros((rows, pb), np.uint8)
    plens = np.zeros(rows, np.int32)
    for i, p in enumerate(payload_list):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    return mat, plens


def _assert_same(want, got, n):
    """want/got: (words, totals, err, err_code); words compared over the
    port's S columns (the JAX package pads S to whole cells)."""
    words, totals, errs, err_codes = (np.asarray(a)[:n] for a in want)
    p_words, p_totals, p_errs, p_err_codes = (a.numpy() for a in got)
    np.testing.assert_array_equal(p_errs, errs)
    np.testing.assert_array_equal(p_err_codes, err_codes)
    np.testing.assert_array_equal(p_totals, totals)
    np.testing.assert_array_equal(p_words, words[:, : p_words.shape[1]])
    return p_words


def _fixed_pair(payload_list, spec, block_size):
    little = spec.endianness is Endianness.LITTLE
    n = len(payload_list)
    mat, plens = _matrix(payload_list, 128, 3)
    w, _, tot, e, ec, _ = decode_pallas.decode_pass1_fixed_tpu(
        jnp.asarray(mat), jnp.asarray(plens), block_size, little=little,
        interpret=True, group=128, cell=64, seg=64,
    )
    pw, _, ptot, pe, pec, _ = tdec.decode_pass1_fixed(
        torch.from_numpy(mat[:n]), torch.from_numpy(plens[:n]), block_size,
        little,
    )
    return _assert_same((w, tot, e, ec), (pw, ptot, pe, pec), n), ptot, pe


def _variable_pair(payload_list, spec, block_size):
    n = len(payload_list)
    mat, plens = _matrix(payload_list, 128)
    w, nc, tot, e, ec, strict, _ = decode_pallas.decode_pass1_variable_tpu(
        mat, plens, spec, block_size, interpret=True, group=128, cell=64,
        seg=64,
    )
    pw, pnc, ptot, pe, pec, pstrict = tdec.decode_pass1_variable(
        mat[:n], plens[:n], from_reference_spec(spec), block_size
    )
    np.testing.assert_array_equal(pstrict, strict[:n])
    np.testing.assert_array_equal(pnc, np.asarray(nc)[:n])
    return _assert_same((w, tot, e, ec), (pw, ptot, pe, pec), n), ptot, pe


def _apply(words, totals, block_size, n):
    out, lengths = get_runtime().apply_words(words[:n], block_size)
    assert (lengths == totals.numpy()[:n]).all()
    return [out[i, : lengths[i]].tobytes() for i in range(n)]


@pytest.mark.parametrize("spec", [FIXED_LE, FIXED_BE], ids=["le", "be"])
def test_fixed_random_and_compressible(spec):
    rng = np.random.default_rng(0)
    datas = [
        rng.integers(0, 256, size=int(rng.integers(0, 129))).astype(
            np.uint8).tobytes()
        for _ in range(8)
    ] + [bytes([7] * 120), (b"ababab" * 22)[:128], b"", b"\x41"]
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    words, totals, errs = _fixed_pair(payloads, spec, 128)
    assert not errs.any()
    assert _apply(words, totals, 128, len(datas)) == datas


def test_fixed_corrupt_code():
    # Code far beyond the next index on the second code: err 1.
    bad = oracle.pack_codes([(65, 12), (3000, 12)], Endianness.LITTLE)
    _, _, errs = _fixed_pair([bad], FIXED_LE, 128)
    assert errs.tolist() == [1]


def test_fixed_output_overflow():
    # 128 decoded bytes into a 64-byte block: err 2 at the overflowing code.
    data = bytes(range(100)) + bytes([3] * 28)
    _, _, errs = _fixed_pair([oracle.encode_bytes(data, FIXED_LE)], FIXED_LE,
                             64)
    assert errs.tolist() == [2]


@pytest.mark.parametrize("spec", [LzwSpec.gif(7), LzwSpec.tiff(),
                                  LzwSpec.gif(2)],
                         ids=["gif7", "tiff", "gif2"])
def test_variable_strict(spec):
    rng = np.random.default_rng(0)
    hi = 1 << spec.code_size
    datas = [
        rng.integers(0, hi, size=int(rng.integers(0, 129))).astype(
            np.uint8).tobytes()
        for _ in range(8)
    ] + [bytes([1] * 100)]
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    words, totals, errs = _variable_pair(payloads, spec, 128)
    assert not errs.any()
    assert _apply(words, totals, 128, len(datas)) == datas


def test_variable_wide_block():
    # block_size > 4096: the TPU's two-plane layout and 17-bit payloads.
    spec = LzwSpec.gif(7)
    rng = np.random.default_rng(11)
    datas = [rng.integers(0, 128, size=300).astype(np.uint8).tobytes(),
             (b"waxwax" * 60)[:300]]
    payloads = [oracle.encode_bytes(d, spec) for d in datas]
    words, totals, _ = _variable_pair(payloads, spec, 8192)
    assert _apply(words, totals, 8192, 2) == datas


def test_variable_corrupt_code():
    # A strict-schedule stream whose second data code (7) is past the next
    # index (6): err 1 with code 7.
    spec = LzwSpec.gif(2)
    dense = np.array([[1, 7, 2, 0]], np.int32)
    pay, nb = jsched.pack_variable(dense, np.array([3], np.int32), spec)
    _, _, errs = _variable_pair([pay[0, : nb[0]].tobytes()], spec, 128)
    assert errs.tolist() == [1]


def test_variable_output_overflow():
    spec = LzwSpec.gif(7)
    data = bytes(range(100)) + bytes([3] * 28)
    _, _, errs = _variable_pair([oracle.encode_bytes(data, spec)], spec, 64)
    assert errs.tolist() == [2]


def test_variable_nonstrict_flagged():
    # An early CLEAR: recovered as non-strict, as in the JAX package.
    spec = LzwSpec.gif(2)
    enc = oracle.pack_codes([(4, 3), (0, 3), (4, 3), (0, 3), (5, 3)],
                            spec.endianness)
    mat, plens = _matrix([enc], 1)
    *_, strict = tdec.decode_pass1_variable(mat, plens,
                                            from_reference_spec(spec), 128)
    assert not strict[0]


def test_dictionary_reset_round_trip():
    # A cs=8 stream long enough to CLEAR-reset, through the plain pass 1 and
    # the native apply_words, against the oracle (interpret mode at this
    # size is marked slow in the JAX suite).
    spec = LzwSpec.variable(8, Endianness.LITTLE)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=4096).astype(np.uint8).tobytes()
    payload = oracle.encode_bytes(data, spec)
    mat, plens = _matrix([payload], 1)
    words, counts, totals, errs, _, strict = tdec.decode_pass1_variable(
        mat, plens, from_reference_spec(spec), 4096
    )
    sched = jsched.emission_schedule(spec, int(counts[0]))
    assert sched.clear_after[: int(counts[0]) - 1].any(), "no reset"
    assert strict.all() and not errs.numpy().any()
    assert _apply(words.numpy(), totals, 4096, 1) == [data]


def test_wrapper_checks_inputs():
    codes = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # variable spec without schedule rows
        tdec.decode_pass1(codes, n, from_reference_spec(LzwSpec.gif(7)), 64)
    with pytest.raises(TypeError):
        tdec.decode_pass1(codes.long(), n, None, 64)
    with pytest.raises(ValueError):
        tdec.decode_pass1(codes, n, None, tdec.MAX_BLOCK + 1)
