"""The port's stride-1 all-device decode against the JAX package's, on the
CPU.

Pass 1's stride-1 pair rows (``rows="stride1"``), the plain stride-1 pass 2
(``decode_pass2_device_reference``), and the strict variable and fixed
all-device decodes with ``stride2=False``, against the three JAX routes that
reach the stride-1 walk: ``decode_variable_all_device(epoch_split=False)``,
``decode_variable_epochs_run(stride2=False)`` and the fixed-12
``decode_pass1_fixed_tpu`` + ``decode_pass2_device``.  The JAX side runs its
Pallas kernels in interpret mode at group=128, as tests/test_torch_pass2.py
does; the port runs on CPU tensors, i.e. the plain versions.  Inputs are
made with numpy from a seed.  Codes, descriptors and bytes are integers:
every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.kernels import decode_pallas as dp
from lzw_tpu.ops import reference as oracle
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.kernels import decode as tdec

# The JAX pass 1 and its (G, S, sub, 128) -> [N, S] row layout helper.
from test_torch_pass2 import SPECS, _datas, _jax_pass1, _matrix, _t


@pytest.mark.parametrize("name", list(SPECS))
def test_stride1_rows_match_jax(name):
    datas = _datas(SPECS[name], seed=5)
    (codes, nc, words, tot, err, pair, sched), _ = _jax_pass1(
        name, datas, 8192, pair2=False)
    spec = from_reference_spec(SPECS[name])
    S = codes.shape[1]
    got = tdec.decode_pass1(
        _t(codes), _t(nc), spec if spec.variable else None, 8192,
        None if sched is None else _t(sched), rows="stride1",
    )
    p_words, p_tot, p_err, _, p_pair = (a.numpy() for a in got)
    np.testing.assert_array_equal(p_err, err)
    np.testing.assert_array_equal(p_tot, tot)
    np.testing.assert_array_equal(p_words, words[:, :S])
    np.testing.assert_array_equal(p_pair, pair[:, :S])
    # Row t names the code created at step t in its top 12 bits; from code
    # 2048 on that sets the sign bit of the i32 row (gif2's four-symbol
    # blocks stay below code 2048).
    first_free = spec.first_free_code if spec.variable else 256
    made = p_pair != 0
    assert ((p_pair[made].view(np.uint32) >> 20) >= first_free).all()
    assert (p_pair < 0).any() == (name != "gif2")


@pytest.mark.parametrize("block_size", [128, 1024])
def test_plain_pass2_device_matches_jax_fixed(block_size):
    # The JAX walk as tests/test_decode_pallas.py's TestDevicePass2 calls it.
    spec = SPECS["fixed"]
    datas = [d[:block_size] for d in _datas(spec, seed=6,
                                            sizes=(0, 1, 2, 100, 1024))]
    (codes, nc, words, tot, err, pair, _), pair4d = _jax_pass1(
        "fixed", datas, block_size, pair2=False)
    assert not err.any()
    want = np.asarray(dp.decode_pass2_device(
        jnp.asarray(codes), pair4d, jnp.asarray(nc), jnp.asarray(tot),
        block_size, interpret=True, group=128, cell=64, seg=64,
    ))
    got = tdec.decode_pass2_device_reference(
        _t(codes), _t(words), _t(pair), _t(nc), block_size).numpy()
    np.testing.assert_array_equal(got, want)
    for i, d in enumerate(datas):
        assert got[i, : len(d)].tobytes() == d


def _variable_case(name):
    if name == "cs8_multi_epoch":
        spec = JSpec.variable(8, JEndianness.BIG)
        datas = _datas(spec, seed=7, sizes=(0, 1, 6000, 5000))
    else:
        spec = SPECS[name]
        datas = _datas(spec, seed=7, sizes=(0, 1, 300, 2000))
    mat, plens = _matrix([oracle.encode_bytes(d, spec) for d in datas])
    return spec, datas, mat, plens


def _assert_port_matches(spec, datas, mat, plens, out, tot, errs, ecs):
    p_out, p_tot, p_errs, p_ecs, p_strict = tdec.decode_variable_all_device(
        mat, plens, from_reference_spec(spec), 8192, device="cpu",
        stride2=False)
    assert p_strict.all()
    np.testing.assert_array_equal(p_tot.numpy(), np.asarray(tot))
    np.testing.assert_array_equal(p_errs.numpy(), np.asarray(errs))
    np.testing.assert_array_equal(p_ecs.numpy(), np.asarray(ecs))
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(out))
    for i, d in enumerate(datas):
        assert p_out[i, : len(d)].numpy().tobytes() == d


VARIABLE_CASES = ["gif7", "gif2", "tiff", "cs8_multi_epoch"]


@pytest.mark.parametrize("name", VARIABLE_CASES)
def test_variable_stride1_matches_jax_whole_stream(name):
    spec, datas, mat, plens = _variable_case(name)
    if name == "cs8_multi_epoch":
        _, _, sched, _ = dp.prepare_variable_decode(mat, plens, spec)
        assert sched[1].any(), "no dictionary reset"
    out, tot, errs, ecs, strict = dp.decode_variable_all_device(
        mat, plens, spec, 8192, interpret=True, group=128, cell=64, seg=64,
        group2=128, seg2=64, epoch_split=False,
    )
    assert strict.all()
    _assert_port_matches(spec, datas, mat, plens, out, tot, errs, ecs)


@pytest.mark.parametrize("name", VARIABLE_CASES)
def test_variable_stride1_matches_jax_per_epoch(name):
    spec, datas, mat, plens = _variable_case(name)
    counts, strict, sched, S = dp.prepare_variable_decode(mat, plens, spec, 64)
    assert strict.all()
    out, tot, errs, ecs, ok = dp.decode_variable_epochs_run(
        mat, counts, sched, spec, S, 8192, interpret=True, group=128,
        cell=64, seg=64, cell2=64, seg2=64, group2=128, stride2=False,
    )
    assert np.asarray(ok).all()
    _assert_port_matches(spec, datas, mat, plens, out, tot, errs, ecs)


@pytest.mark.parametrize("little", [True, False], ids=["le", "be"])
def test_fixed_stride1_round_trip(little):
    spec = JSpec.fixed(JEndianness.LITTLE if little else JEndianness.BIG)
    datas = _datas(spec, seed=8)
    mat, plens = _matrix([oracle.encode_bytes(d, spec) for d in datas], 3)
    args = (torch.from_numpy(mat), torch.from_numpy(plens), 4096, little)
    out, tot, errs, ecs = tdec.decode_fixed_all_device(*args, stride2=False)
    for a, b in zip((out, tot, errs, ecs), tdec.decode_fixed_all_device(
            *args)):
        assert torch.equal(a, b)
    assert not errs.any()
    for i, d in enumerate(datas):
        assert int(tot[i]) == len(d)
        assert out[i, : len(d)].numpy().tobytes() == d
    assert not out[len(datas):].any()


def test_pass2_device_wrapper_checks_inputs():
    codes = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):  # pair rows of another dtype
        tdec.decode_pass2_device(codes, codes, codes.long(), n, 64)
    with pytest.raises(ValueError):  # pair rows of another shape
        tdec.decode_pass2_device(codes, codes, codes[:, :3].contiguous(), n,
                                 64)
    with pytest.raises(ValueError):  # variable spec without schedule rows
        tdec.decode_pass2_device(codes, codes, codes, n, 64,
                                 from_reference_spec(JSpec.gif(7)))
    with pytest.raises(ValueError, match="rows must be one of"):
        tdec.decode_pass1(codes, n, None, 64, rows="stride3")
    before = dict(build.LAUNCHES)
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_pass2_device(meta, meta, meta,
                                 torch.empty(2, dtype=torch.int32,
                                             device="meta"), 64)
    assert build.LAUNCHES == before
