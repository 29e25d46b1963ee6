"""Host halves of the port against the JAX package: schedules, bit-pack,
count recovery, framing, the error taxonomy, specs and the corpus reader.

Inputs are made from seeds with numpy; every comparison is exact.
"""

import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lzw_tpu.kernels import schedule as jsched
from lzw_tpu.ops import encode as jencode
from lzw_tpu.parallel import framing as jframing
from lzw_tpu import spec as jspec
from lzw_tpu.utils.corpus import load_tokyo_pixels as jax_load_tokyo

import lzw_tpu_torch
from lzw_tpu_torch import spec as tspec
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.ops.encode import packed_bound
from lzw_tpu_torch.parallel import framing as tframing
from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

ROOT = pathlib.Path(__file__).resolve().parent.parent
J = jspec.LzwSpec
REF_SPECS = {
    **{f"gif{cs}": J.gif(cs) for cs in range(2, 9)},
    "tiff": J.tiff(),
    "var4be": J.variable(4, jspec.Endianness.BIG, jspec.CodeSizeStrategy.TIFF),
    "fixed_le": J.fixed(jspec.Endianness.LITTLE),
    "fixed_be": J.fixed(jspec.Endianness.BIG),
}
VARIABLE = [k for k, s in REF_SPECS.items() if s.variable]


def _port(spec):
    return tspec.from_reference_spec(spec)


@pytest.mark.parametrize("name", list(REF_SPECS))
def test_emission_schedule_equal(name):
    ref = REF_SPECS[name]
    a = jsched.emission_schedule(ref, 9000)
    b = tsched.emission_schedule(_port(ref), 9000)
    for field in ("widths", "clear_after", "nxt_of", "epoch_start",
                  "bit_off", "next_width"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                      err_msg=field)
    for fix in (True, False):
        off, w, total = b.eoi_tables(fix)
        for n in (0, 1, 2, 100, 3000, 4090, 8999):
            assert total[n] == a.total_bits(n, fix)
            assert w[n] == a.eoi_width(n, fix)
            assert off[n] == a.total_bits(n, fix) - a.eoi_width(n, fix)


def _random_dense(spec, N, S, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, S + 1, N)
    counts[0], counts[1] = 0, S
    dense = np.zeros((N, S), np.int32)
    hi = spec.first_free_code - 2  # data codes never equal CLEAR/EOI
    for i in range(N):
        dense[i, : counts[i]] = rng.integers(0, hi, counts[i])
    return dense, counts.astype(np.int32)


@pytest.mark.parametrize("fix", [True, False], ids=["fix_eoi", "no_fix"])
@pytest.mark.parametrize("name", ["gif2", "gif7", "gif8", "tiff", "var4be"])
def test_pack_unpack_equal(name, fix):
    ref = REF_SPECS[name]
    spec = _port(ref)
    dense, counts = _random_dense(spec, 6, 9000, seed=len(name))
    want, want_len = jsched.pack_variable(dense, counts, ref, fix_eoi=fix)
    got, got_len = tsched.pack_variable(
        torch.from_numpy(dense), torch.from_numpy(counts), spec, fix_eoi=fix
    )
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got.numpy(), want)

    c_ref, strict_ref, S_ref = jsched.recover_counts(
        want, want_len.astype(np.int64), ref)
    c, strict, S = tsched.recover_counts(want, want_len.astype(np.int64),
                                         spec)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(strict, strict_ref)
    assert S == S_ref
    assert (c == counts).all() and strict.all()

    d_ref, ok_ref = jsched._unpack_segments(
        np.pad(want.astype(np.int64), ((0, 0), (0, 4))), c_ref, ref, S_ref,
        np)
    d, ok = tsched.unpack_variable_device(
        torch.from_numpy(want), torch.from_numpy(c), spec, S)
    np.testing.assert_array_equal(d.numpy(), d_ref)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)


def test_unpack_flags_control_codes_in_data_slots():
    spec = _port(REF_SPECS["gif7"])
    dense = np.array([[5, spec.clear_code, 7], [5, 6, 7]], np.int32)
    counts = np.array([3, 3], np.int32)
    pay, _ = jsched.pack_variable(dense, counts, REF_SPECS["gif7"])
    _, ok = tsched.unpack_variable_device(
        torch.from_numpy(pay), torch.from_numpy(counts), spec, 3)
    assert ok.tolist() == [False, True]


@pytest.mark.parametrize("name", list(REF_SPECS))
def test_frames_and_streams_byte_identical(name):
    ref = REF_SPECS[name]
    spec = _port(ref)
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, int(rng.integers(0, 50))).astype(
        np.uint8).tobytes() for _ in range(5)]
    a = jframing.pack_frame(ref, 4096, 12345, payloads)
    b = tframing.pack_frame(spec, 4096, 12345, payloads)
    assert a == b
    header, views = tframing.parse_frame(a)
    assert header.spec == spec and header.n_blocks == 5
    assert [bytes(v) for v in views] == payloads

    sa, sb = io.BytesIO(), io.BytesIO()
    for fr, sp, dst in ((jframing, ref, sa), (tframing, spec, sb)):
        fr.write_stream_header(dst, sp, 4096)
        for p in payloads:
            fr.write_stream_record(dst, p)
        fr.write_stream_end(dst, 777)
    assert sa.getvalue() == sb.getvalue()
    src = io.BytesIO(sa.getvalue())
    assert tframing.read_stream_header(src) == (spec, 4096)
    assert [tframing.read_stream_record(src) for _ in payloads] == payloads
    assert tframing.read_stream_record(src) == 777


def test_framing_errors():
    with pytest.raises(tframing.FramingError):
        tframing.parse_frame(b"NOPE" + bytes(40))
    assert issubclass(tframing.FramingError, tspec.DecodingError)


@pytest.mark.parametrize("make", [
    lambda m: m.CodeSizeError(9),
    lambda m: m.UnexpectedCodeError(8, 2),
    lambda m: m.UnexpectedCodeError(258),
    lambda m: m.MissingClearCodeError(),
    lambda m: m.TruncatedStreamError(),
    lambda m: m.VerificationError(3, "detail"),
], ids=["code_size", "unexpected_enc", "unexpected_dec", "missing_clear",
        "truncated", "verification"])
def test_error_taxonomy(make):
    a, b = make(jspec), make(tspec)
    assert type(a).__name__ == type(b).__name__
    assert str(a) == str(b)
    assert [c.__name__ for c in type(a).__mro__] == [
        c.__name__ for c in type(b).__mro__]


def test_error_names_exported():
    for name in jspec.__all__:
        assert hasattr(tspec, name), name
    assert tspec.MAX_TABLE_SIZE == jspec.MAX_TABLE_SIZE
    assert tspec.MAX_WIDTH == jspec.MAX_WIDTH
    assert tspec.MAX_WORD_LEN == jspec.MAX_WORD_LEN
    with pytest.raises(lzw_tpu_torch.CodeSizeError, match="was 9"):
        lzw_tpu_torch.LzwSpec.gif(9).validate()


@pytest.mark.parametrize("name", list(REF_SPECS))
def test_from_reference_spec(name):
    ref = REF_SPECS[name]
    spec = tspec.from_reference_spec(ref)
    for field in ("code_size", "variable", "first_free_code", "clear_code",
                  "end_code", "initial_width", "max_code_value"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert spec.endianness.value == ref.endianness.value
    assert spec.strategy.value == ref.strategy.value
    assert tspec.from_reference_spec(spec) == spec  # round trip
    for bs in (64, 4096, 1 << 16):
        assert packed_bound(bs, spec) == jencode.packed_bound(bs, ref)


def test_png_reader_matches_pil():
    path = ROOT / "test-assets" / "tokyo_128_colors.png"
    assert load_tokyo_pixels(path) == jax_load_tokyo(path)


def test_import_is_jax_free():
    # Every module of the package, and chip_smoke.py, in a fresh process.
    code = (
        "import importlib, pkgutil, sys, lzw_tpu_torch, chip_smoke; "
        "names = [m.name for m in pkgutil.walk_packages("
        "lzw_tpu_torch.__path__, 'lzw_tpu_torch.')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert 'lzw_tpu_torch.scripts.probe_gpu' in names, names; "
        "assert {'lzw_tpu_torch.api', 'lzw_tpu_torch.entry', "
        "'lzw_tpu_torch.parallel.multihost', 'lzw_tpu_torch.ops.reference', "
        "'lzw_tpu_torch.utils.gifwrap'} <= set(names), names; "
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'lzw_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_native_source_is_the_ports_own_copy():
    from lzw_tpu_torch.native import runtime

    assert runtime.SOURCE == (ROOT / "lzw_tpu_torch" / "native"
                              / "lzw_native.cpp")
    assert runtime.SOURCE.read_bytes() == (
        ROOT / "lzw_tpu" / "native" / "lzw_native.cpp").read_bytes()


def _code_strings(path):
    """String constants of a Python file that are not docstrings."""
    import ast

    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_no_path_into_the_jax_package():
    # The port reads no file of lzw_tpu/: no string of its code names that
    # directory, and no CUDA source includes from it.
    import re

    pkg = ROOT / "lzw_tpu_torch"
    into = re.compile(r"(^|[/\\])lzw_tpu([/\\]|$)")
    bad = [(str(p.relative_to(ROOT)), s) for p in sorted(pkg.rglob("*.py"))
           for s in _code_strings(p) if into.search(s)]
    for p in sorted([*pkg.rglob("*.cu"), *pkg.rglob("*.cuh")]):
        for line in p.read_text().splitlines():
            if line.lstrip().startswith("#include") and "lzw_tpu/" in line:
                bad.append((str(p.relative_to(ROOT)), line))
    assert not bad, bad
