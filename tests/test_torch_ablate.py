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
from test_torch_bind import _constants

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
    # The ring's index names a row in 12 bits: ring in [1, 4095], on
    # every device.
    for ring in (0, ablate.RING_LAYOUT.max_ring + 1):
        with pytest.raises(ValueError, match="ring must be in"):
            ablate.ablate_ring(x, "ring", ring=ring)
    # Neither a ring that is no multiple of 4 nor a lane count that is no
    # multiple of 8 is refused.
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 4, (512, 100)).astype(np.int32))
    for ring in (6, 512):
        got = ablate.ablate_ring(x, "ring", ring=ring)
        assert got.shape == (512, 100)
        assert torch.equal(got, ablate.ablate_ring_reference(x, "ring",
                                                             ring=ring))


def _ring_index_model(x: np.ndarray, cell: int, ring: int,
                      k: dict[str, int]) -> tuple[np.ndarray, int]:
    """The ``ring`` variant as ``ablate_ring.cu`` computes it, lane by lane:
    the ring of keys beside an index of ``kSlots`` slots of tag << kRowBits
    | row + 1, linear probing from the key's hash; the slot of a key that
    leaves the ring becomes ``kTomb``, and an insert takes the first
    tombstone of its walk, else the empty slot that ended it.  Returns
    (out i32[steps, lanes], the longest walk in slots)."""
    slots_n, bits = k["kSlots"], k["kRowBits"]
    steps, lanes = x.shape
    out = np.empty_like(x)
    longest = 0
    for lane in range(lanes):
        slots = [0] * slots_n
        rows = [-1] * (ring + 1)  # rows[-1], a tombstone's row, stays -1
        row_slot = [0] * ring  # each row's slot + 1, 0 none
        prefix, nxt = 0, 256
        for s in range(steps):
            kk = int(x[s, lane])
            key = ((prefix * 256 + kk + 2**31) % 2**32) - 2**31  # int32
            mix = (key % 2**32) * k["kHash"] % 2**32
            h = mix * slots_n >> 32
            tag = (mix >> k["kTagShift"]) & 15
            matched, walked, tomb = -1, 1, -1
            while slots[h]:
                if slots[h] == k["kTomb"] and tomb < 0:
                    tomb = h
                if slots[h] >> bits == tag:
                    row = (slots[h] & ((1 << bits) - 1)) - 1
                    if rows[row] == key:
                        matched = row
                        break
                h = (h + 1) % slots_n
                walked += 1
            longest = max(longest, walked)
            end = h if tomb < 0 else tomb
            miss = matched < 0
            out[s, lane] = prefix if miss else -1
            ins = miss and nxt < k["kTableFull"]
            w = (s % cell) % ring
            if row_slot[w]:  # w's old key leaves the ring
                slots[row_slot[w] - 1] = k["kTomb"]
            rows[w] = key if ins else -1
            row_slot[w] = end + 1 if ins else 0
            if ins:
                slots[end] = tag << bits | (w + 1)
            prefix = kk if miss else matched
            nxt += ins
    return out, longest


@pytest.mark.parametrize("case", list(port_ablate2.ring_cases(1024, 4, 3)))
def test_ring_index_model_matches_plain(case):
    # The kernel's design, held against the compare-scan of every ring row
    # (no JAX): inputs of chip_smoke.py phase 8 at 2048 steps (4096 for
    # the largest ring, so that its last rows are written) and 8 lanes.
    steps = 4096 if case == "ring max" else 2048
    x, cell, ring = port_ablate2.ring_cases(steps, 8, 5, seed=7)[case]
    k = _constants("ablate_ring.cu")
    assert ring <= k["kMaxRing"] < 1 << k["kRowBits"]
    got, longest = _ring_index_model(x, cell, ring, k)
    want = ablate.ablate_ring_reference(torch.from_numpy(x), "ring",
                                        cell=cell, ring=ring).numpy()
    np.testing.assert_array_equal(got, want)
    # Every walk ended at an empty slot: none went round the index.
    assert longest < k["kSlots"], longest
    # The ring found keys: the case tells the index apart from a miss.
    assert (want < 0).any() and (want >= 0).any()
