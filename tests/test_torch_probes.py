"""The port's probes P3 and P4 against the JAX package's Pallas kernels.

The JAX kernels sit inside closures of ``scripts/probe_i16.py`` and
``scripts/probe_tpu.py``.  A module fixture runs those scripts' probe
functions with ``pallas_call`` wrapped to run in interpret mode and to
record each call's inputs and output as numpy, and with ``jax.jit`` made the
identity for the duration (inside a jit the recorder would see tracers).
The port's functions then run on the recorded inputs as CPU tensors, which
is their plain versions.  Outputs are integers: every comparison is exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from lzw_tpu_torch.kernels import probe
from lzw_tpu_torch.scripts import (ablate2, ablate_kernel, probe_gpu,
                                   probe_i16)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 64  # probe_i16's T, cut from 512 for the interpreter


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def recorded():
    """{probe: [(inputs, output), ...]} of every pallas_call the JAX
    probes make."""
    pi = _script("probe_i16")
    pt = _script("probe_tpu")
    calls = {}
    tag = [None]
    real_call = pl.pallas_call

    def recording(kernel, *args, **kwargs):
        run = real_call(kernel, *args, **dict(kwargs, interpret=True))

        def call(*inputs):
            out = run(*inputs)
            calls.setdefault(tag[0], []).append(
                ([np.array(i) for i in inputs], np.array(out)))
            return out

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        mp.setattr(jax, "jit", lambda fn, *a, **k: fn)
        mp.setattr(pi, "T", STEPS)
        rng = np.random.default_rng(0)
        for dtype in (jnp.int32, jnp.int16):
            tag[0] = f"P3 {np.dtype(dtype).name}"
            x = rng.integers(-2000, 2000, (1, STEPS, pi.SUB, 128))
            pi.make(dtype)(jnp.asarray(x.astype(dtype)))
        for name, fn in (("a", pt.probe_a_basic_pallas),
                         ("b", pt.probe_b_gather_in_pallas),
                         ("b2", pt.probe_b2_gather_loop_pallas),
                         ("b3", pt.probe_b3_small_gather)):
            tag[0] = name
            fn()
    return calls


@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_scan_matches_jax(recorded, dtype):
    [(inputs, out)] = recorded[f"P3 {dtype}"]
    x = torch.from_numpy(inputs[0])
    got = probe.probe_scan(x, rows=1024)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), out)
    assert not out.any()  # zero for any input


def test_scan_plain_version_sweeps():
    # The table is zero-filled, so only the sign of each value matters:
    # any positive value selects 0, and max(0, -30000) is 0 as well.
    for dtype in (torch.int32, torch.int16):
        x = torch.full((1, 3, 16, 2), -5, dtype=dtype)
        x[0, 1, 3, 1] = 7
        got = probe.probe_scan(x, rows=8)
        assert got.shape == (1, 16, 2) and not got.any()
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe_scan(torch.zeros((1, 2, 16), dtype=torch.int16),
                         fill=40000)
    with pytest.raises(ValueError, match="multiple of 16"):
        probe.probe_scan(torch.zeros((1, 2, 8), dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        probe.probe_scan(torch.zeros((1, 2, 16), dtype=torch.int64))


@pytest.mark.parametrize("fill", [-700, 0, 500])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_scan_plain_version_fill(dtype, fill):
    # acc starts at 0: a column is the fill where some step's value exceeds
    # a positive fill, and 0 everywhere else.
    rng = np.random.default_rng(5)
    x = rng.integers(0, 600, (1, 3, 16, 4))
    x[0, :, 0] = 500  # equal to the fill is not below it
    got = probe.probe_scan(torch.from_numpy(x).to(dtype), rows=5, fill=fill)
    want = np.where((x[0] > fill).any(axis=0), max(fill, 0), 0)
    np.testing.assert_array_equal(got.numpy()[0], want)
    if fill == 500:
        assert 0 < (want == 500).sum() < want.size


def test_affine_matches_jax(recorded):
    (inputs, out), *_ = recorded["a"]
    got = probe.affine(torch.from_numpy(inputs[0]))
    np.testing.assert_array_equal(got.numpy(), out)
    np.testing.assert_array_equal(out, inputs[0] * 2 + 1)
    x = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32)
    assert probe.affine(x).tolist() == [-1, 1]  # wraps as int32


@pytest.mark.parametrize("name", ["b", "b3"])
def test_gather_matches_jax(recorded, name):
    heights = set()
    for (tab, idx), out in recorded[name]:
        got = probe.gather_lanes(torch.from_numpy(tab), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), out)
        np.testing.assert_array_equal(
            out[0], tab[idx[0], np.arange(tab.shape[1])])
        heights.add(tab.shape[0])
    assert heights == ({8192} if name == "b" else set(probe_gpu.HEIGHTS))


def test_gather_loop_matches_jax(recorded):
    calls = recorded["b2"]
    assert calls
    for (tab, idx), out in calls:
        got = probe.gather_loop(torch.from_numpy(tab), torch.from_numpy(idx),
                                256)
        np.testing.assert_array_equal(got.numpy(), out)


def test_gather_checks():
    tab = torch.zeros((6, 4), dtype=torch.int32)
    idx = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        probe.gather_loop(tab, idx)
    with pytest.raises(ValueError, match="lanes"):
        probe.gather_lanes(tab, idx[:, :3].contiguous())


@pytest.mark.parametrize("cli,argv", [
    (ablate_kernel, ["all"]), (ablate2, []), (probe_i16, []),
    (probe_gpu, ["all"])])
def test_cli_raises_without_a_card(cli, argv, monkeypatch):
    # A measurement has no CPU run.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


@pytest.mark.parametrize("cli,argv", [
    (ablate_kernel, ["scan"]), (ablate2, ["ring"]), (probe_i16, ["int16"]),
    (probe_gpu, ["f"])])
def test_cli_rejects_other_arguments(cli, argv):
    with pytest.raises(SystemExit, match="usage"):
        cli.main(argv)
