"""The port's ablations P1 and P2 against the JAX package's Pallas kernels.

The JAX kernels come from ``scripts/ablate_kernel.py`` and
``scripts/ablate2.py`` and run in interpret mode, with the scripts' own
grids, block specs and scratch shapes (the lane count of P1 narrowed to
keep the tests short); the port runs ``ablate_parse`` / ``ablate_ring`` on
CPU tensors, which is their plain versions.  Inputs are made with numpy
from seeds.  Outputs are integers: every comparison is exact.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lzw_tpu_torch.kernels import ablate
from lzw_tpu_torch.scripts import ablate2 as port_ablate2
from lzw_tpu_torch.scripts import ablate_kernel as port_ablate_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ak = _script("ablate_kernel")
a2 = _script("ablate2")

P1_ORIG = ("empty", "scan_noinsert", "scan_wininsert", "scan", "seg2")
P1_GRID = ("gempty", "gscan_noins", "gscan")
GRID_TWIN = {"gempty": "empty", "gscan_noins": "scan_noinsert",
             "gscan": "scan"}


def _p1_input(kind):
    """[G, B, L] inputs: ``random`` bytes push nxt past 2048 (seg2 then
    differs); ``mixed`` makes half the lanes binary, which keeps the
    lockstep min(nxt) low (scan_wininsert then drops inserts); ``wide`` is
    random + 4, so bytes reach 259; ``full`` is mixed at the scripts' 128
    lanes and two groups."""
    rng = np.random.default_rng({"random": 1, "mixed": 2, "wide": 3,
                                 "full": 4}[kind])
    G, B, L = (2, 1024, 128) if kind == "full" else (1, 2048, 16)
    x = rng.integers(0, 256, (G, B, L)).astype(np.int32)
    if kind in ("mixed", "full"):
        x[:, :, : L // 2] &= 1
    return x + 4 if kind == "wide" else x


@functools.cache
def _jax_p1(variant, kind):
    x = _p1_input(kind)
    G, B, L = x.shape
    old = ak.LANES
    ak.LANES = L  # the kernels read it when traced
    try:
        if variant in P1_GRID:
            kernel, grid, rows = ak.make_grid_kernel(variant), (G, B // 8), 8
        else:
            kernel, grid, rows = (ak.make_kernel(variant),
                                  (G, B // ak.CHUNK), ak.CHUNK)
        f = pl.pallas_call(
            kernel, grid=grid,
            in_specs=[pl.BlockSpec((1, rows, L), lambda g, c: (g, c, 0))],
            out_specs=pl.BlockSpec((1, rows, L), lambda g, c: (g, c, 0)),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
            scratch_shapes=[pltpu.VMEM((ak.T, L), jnp.int32),
                            pltpu.VMEM((8, L), jnp.int32)],
            interpret=True,
        )
        return np.asarray(jax.jit(f)(jnp.asarray(x)))
    finally:
        ak.LANES = old


@functools.cache
def _port_p1(variant, kind):
    x = torch.from_numpy(_p1_input(kind))
    return ablate.ablate_parse(x, variant, table_rows=ak.T,
                               seg=ak.SEG).numpy()


@pytest.mark.parametrize("kind", ["random", "mixed", "wide", "full"])
@pytest.mark.parametrize("variant", P1_ORIG)
def test_parse_matches_jax(variant, kind):
    np.testing.assert_array_equal(_port_p1(variant, kind),
                                  _jax_p1(variant, kind))


@pytest.mark.parametrize("variant", P1_GRID)
def test_grid_parse_matches_jax(variant):
    got = _port_p1(variant, "mixed")
    np.testing.assert_array_equal(got, _jax_p1(variant, "mixed"))
    # The grid kernel computes what the chunked one does.
    np.testing.assert_array_equal(_jax_p1(variant, "mixed"),
                                  _jax_p1(GRID_TWIN[variant], "mixed"))


def test_p1_data_separates_the_variants():
    # Each variant must compute something its neighbours do not on some
    # input, or the tests above could not tell them apart.
    def differ(a, b, kind):
        return not np.array_equal(_port_p1(a, kind), _port_p1(b, kind))

    assert differ("seg2", "scan", "random")
    assert differ("seg2", "scan_wininsert", "random")
    assert differ("scan_wininsert", "scan", "mixed")
    assert differ("scan_wininsert", "scan", "full")
    assert differ("scan", "scan_noinsert", "random")
    assert _p1_input("wide").max() == 259
    # Without inserts every step misses, as in empty, on non-negative keys.
    for kind in ("random", "wide"):
        assert not differ("scan_noinsert", "empty", kind)


def test_parse_variants_and_checks():
    assert set(ablate.PARSE_VARIANTS) == {*P1_ORIG, *P1_GRID,
                                          "scan_reduce_only"}
    assert port_ablate_kernel.ORIG == P1_ORIG
    assert port_ablate_kernel.GRID == P1_GRID
    x = torch.zeros((1, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        ablate.ablate_parse(x, "scan_all")
    with pytest.raises(ValueError, match="table_rows"):
        ablate.ablate_parse(x, "scan", table_rows=4096)
    with pytest.raises(TypeError, match="dtype"):
        ablate.ablate_parse(x.long(), "scan")


def _p2_input(steps=1024):
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (steps, 8, 128)).astype(np.int32)


def _run_p2_kernel(x, variant, cell):
    f = pl.pallas_call(
        a2.make_kernel(variant, cell),
        grid=(x.shape[0] // cell,),
        in_specs=[pl.BlockSpec((cell, 8, 128), lambda c: (c, 0, 0))],
        out_specs=pl.BlockSpec((cell, 8, 128), lambda c: (c, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        scratch_shapes=[pltpu.VMEM((a2.T, 8, 128), jnp.int32),
                        pltpu.VMEM((a2.RING, 8, 128), jnp.int32),
                        pltpu.VMEM((2, 8, 128), jnp.int32)],
        interpret=True,
    )
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@functools.cache
def _jax_p2(variant, cell):
    return _run_p2_kernel(_p2_input(), variant, cell)


@functools.cache
def _port_p2(variant, cell):
    x = torch.from_numpy(_p2_input())
    return ablate.ablate_ring(x, variant, cell=cell, ring=a2.RING,
                              table_rows=a2.T).numpy()


@pytest.mark.parametrize("variant,cell", [("empty", 512), ("scan", 512),
                                          ("ring", 512), ("ring", 256)])
def test_ring_matches_jax(variant, cell):
    np.testing.assert_array_equal(_port_p2(variant, cell),
                                  _jax_p2(variant, cell))


def test_p2_data_separates_the_variants():
    # The ring finds repeated keys; with cells of 256 steps its rows
    # 256-511 stay -1, which changes what it finds.
    assert not np.array_equal(_port_p2("ring", 512), _port_p2("scan", 512))
    assert not np.array_equal(_port_p2("ring", 256), _port_p2("ring", 512))
    # The table no variant writes finds nothing.
    np.testing.assert_array_equal(_port_p2("scan", 512),
                                  _port_p2("empty", 512))


def test_ring_plain_version_on_negative_keys():
    # The key -1 matches every row of the never-written table and of the
    # ring's unwritten rows, as in the JAX kernel's compare-max.
    x = np.full((512, 8, 128), -1, np.int32)
    x[1::2] = 3
    np.testing.assert_array_equal(
        ablate.ablate_ring_reference(torch.from_numpy(x), "ring").numpy(),
        _run_p2_kernel(x, "ring", 512))


def test_ring_variants_and_checks():
    assert tuple(ablate.RING_VARIANTS) == port_ablate2.VARIANTS == (
        "empty", "scan", "ring")
    x = torch.zeros((512, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        ablate.ablate_ring(x, "ring2")
    with pytest.raises(ValueError, match="multiple of cell"):
        ablate.ablate_ring(x, "ring", cell=300)
    with pytest.raises(ValueError, match="ring"):
        ablate.ablate_ring(x, "ring", ring=6)
