"""The port's per-block encode against the JAX package's ``encode_block``.

``lzw_tpu_torch.ops.encode.encode_block`` on CPU tensors (the encode-parse
kernel's plain version, positions instance) against
``jax.vmap(lzw_tpu.ops.encode.encode_block)`` on JAX's CPU backend, on the
same rows made with numpy from a seed; then ``pack_codes_torch`` on the
port's slots against ``pack_codes_jax`` on JAX's.  Tolerance: ``widths``,
``error``, ``error_code`` and ``error_pos`` exactly, ``codes`` exactly
wherever ``widths > 0`` and on every reset-CLEAR, head and EOI slot (the
JAX scan writes its running prefix into an empty miss slot, the port 0;
neither is part of the contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzw_tpu.ops import bitpack as jbitpack
from lzw_tpu.ops import encode as jencode
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels.encode import encode_blocks_codes_reference
from lzw_tpu_torch.ops import bitpack, encode
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.spec import MAX_WIDTH
from lzw_tpu_torch.utils import testdata

SPECS = {
    "gif7": JSpec.gif(7),
    "gif2": JSpec.gif(2),
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
}
# Wide enough that a random gif7 row passes 4093 misses (a reset).
B = 5600


def _quirk_row(spec):
    """A short seeded row whose stream has the EOI width quirk."""
    for seed in range(20):
        for n in range(2, 600):
            rng = np.random.default_rng(seed)
            data = rng.integers(0, 1 << spec.code_size, size=n).astype(
                np.uint8)
            if oracle.eoi_width_quirk(
                    oracle.encode_codes(data.tobytes(), spec), spec):
                return data
    raise AssertionError("no quirk input found")


def _rows(jspec):
    """Rows of lengths 0, 1, 2, B-1 and B, a long repeat, the EOI quirk
    (variable specs), a byte past the alphabet at index 0 (not checked),
    at 1, and deep in a row after a reset."""
    spec = from_reference_spec(jspec)
    rng = np.random.default_rng(11)
    hi = spec.alphabet_size if spec.variable else 256
    mat = rng.integers(0, hi, size=(10, B)).astype(np.uint8)
    lens = np.array([0, 1, 2, B - 1, B, B, 0, B, B, B], np.int32)
    mat[5] = np.resize(mat[5, :7], B)  # a long repeated phrase
    if spec.variable:
        quirk = _quirk_row(spec)
        mat[6, : len(quirk)] = quirk
        lens[6] = len(quirk)
    if hi < 256:
        mat[7, 0] = 255  # the first byte is never checked
        mat[8, 1] = 255
        mat[9, 5000] = hi
    return mat, lens


def _jax_encode(jspec, mat, lens, fix):
    out = jax.vmap(lambda b, n: jencode.encode_block(
        b, n, jspec, fix_eoi_width=fix))(jnp.asarray(mat), jnp.asarray(lens))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("fix", [False, True], ids=["salzweg", "fix_eoi"])
@pytest.mark.parametrize("name", list(SPECS))
def test_encode_block_matches_jax(name, fix):
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    mat, lens = _rows(jspec)
    want = _jax_encode(jspec, mat, lens, fix)
    got = encode.encode_block(torch.from_numpy(mat), torch.from_numpy(lens),
                              spec, fix_eoi_width=fix)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["codes"].shape == (len(lens), encode.encoder_output_slots(B))
    assert got["codes"].dtype == got["widths"].dtype == np.int32
    np.testing.assert_array_equal(got["widths"], want["widths"])
    filled = want["widths"] > 0
    np.testing.assert_array_equal(got["codes"][filled], want["codes"][filled])
    for key in ("error", "error_code", "error_pos"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if spec.variable:
        # The head, every reset-CLEAR slot and EOI hold JAX's codes.
        for cols in (np.s_[:, 0], np.s_[:, 2 : 2 * B + 1 : 2], np.s_[:, -1]):
            np.testing.assert_array_equal(got["codes"][cols],
                                          want["codes"][cols])
        clears = got["widths"][:, 2 : 2 * B + 1 : 2] == MAX_WIDTH
        if name == "gif7":
            assert clears[4].any(), "the random gif7 row has no reset"
            assert clears[9, :5000].any(), "no reset before the bad byte"
        if spec.alphabet_size < 256:
            assert got["error"][7] == 0
            assert got["error"][8] == 1 and got["error_pos"][8] == 1
            assert got["error"][9] == 1 and got["error_pos"][9] == 5000
    else:
        np.testing.assert_array_equal(got["codes"][:, 1 : 2 * B : 2], 0)
    # The two settings differ only on the quirk row's EOI.
    if spec.variable and fix:
        salzweg = encode.encode_block(
            torch.from_numpy(mat), torch.from_numpy(lens), spec)["widths"]
        diff = np.nonzero(salzweg.numpy() != got["widths"])
        assert diff[0].tolist() == [6] and diff[1].tolist() == [2 * B + 2]


@pytest.mark.parametrize("fix", [False, True], ids=["salzweg", "fix_eoi"])
@pytest.mark.parametrize("name", list(SPECS))
def test_pack_codes_matches_jax(name, fix):
    """pack_codes_torch on the port's slots == pack_codes_jax on JAX's,
    rows at once and one row at a time."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    mat, lens = _rows(jspec)
    want = _jax_encode(jspec, mat, lens, fix)
    out_bytes = jencode.packed_bound(B, jspec)
    want_b, want_n = jax.vmap(lambda c, w: jbitpack.pack_codes_jax(
        c, w, jspec.endianness, out_bytes))(want["codes"], want["widths"])
    got = encode.encode_block(torch.from_numpy(mat), torch.from_numpy(lens),
                              spec, fix_eoi_width=fix)
    got_b, got_n = bitpack.pack_codes_torch(got["codes"], got["widths"],
                                            spec.endianness, out_bytes)
    assert got_b.shape == (len(lens), out_bytes)
    assert got_b.dtype == torch.uint8 and got_n.dtype == torch.int64
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    for r in (0, 4, 6):
        one_b, one_n = bitpack.pack_codes_torch(
            got["codes"][r], got["widths"][r], spec.endianness, out_bytes)
        assert one_n.dim() == 0 and int(one_n) == int(want_n[r])
        np.testing.assert_array_equal(one_b.numpy(), np.asarray(want_b)[r])


def test_pack_codes_drops_bytes_past_the_buffer():
    """A buffer shorter than the stream keeps its first bytes, as
    pack_codes_jax does, and still reports the stream's whole length."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 1 << 12, size=(3, 40)).astype(np.int32)
    widths = rng.integers(0, 13, size=(3, 40)).astype(np.int32)
    for endian in (JEndianness.LITTLE, JEndianness.BIG):
        want_b, want_n = jax.vmap(lambda c, w: jbitpack.pack_codes_jax(
            c, w, endian, 7))(codes, widths)
        got_b, got_n = bitpack.pack_codes_torch(
            torch.from_numpy(codes), torch.from_numpy(widths),
            from_reference_spec(JSpec.fixed(endian)).endianness, 7)
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_encode_block_rejects_rows_past_max_row(monkeypatch):
    monkeypatch.setattr(encode, "MAX_ROW", 8)
    blocks = torch.zeros((1, 9), dtype=torch.uint8)
    with pytest.raises(ValueError, match="i32"):
        encode.encode_block(blocks, torch.tensor([9], dtype=torch.int32),
                            from_reference_spec(JSpec.gif(7)))
    with pytest.raises(ValueError, match="unsupported device"):
        encode.encode_block(blocks[:, :8].to("meta"),
                            torch.tensor([8], dtype=torch.int32).to("meta"),
                            from_reference_spec(JSpec.gif(7)))


CASES = testdata.encode_edge_cases(full=False)


@pytest.mark.parametrize("case", CASES, ids=[c.label for c in CASES])
def test_reference_positions_flag(case):
    """The positions flag adds pos and changes none of the four outputs;
    each code's byte rises along the row, lies below the row's length for
    a miss, and is the length for the final prefix."""
    blocks = torch.from_numpy(case.blocks)
    lens = torch.from_numpy(case.lens)
    plain = encode_blocks_codes_reference(blocks, lens, case.spec)
    dense, counts, err, err_code, pos = encode_blocks_codes_reference(
        blocks, lens, case.spec, positions=True)
    for a, b in zip(plain, (dense, counts, err, err_code)):
        assert torch.equal(a, b)
    assert pos.shape == dense.shape and pos.dtype == torch.int32
    for r, length in enumerate(case.lens):
        n, ok = int(counts[r]), int(err[r]) == 0
        p = pos[r, :n].numpy()
        assert (pos[r, n:] == 0).all()
        assert (np.diff(p) > 0).all()
        if n and ok:
            assert p[-1] == length and (p[:-1] < length).all()
        else:
            assert (p < length).all()
        assert (p[: n - ok] >= 1).all()
