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


DAMAGED = ["intact", "flip_byte", "cut", "flip_last", "bad_lead", "bad_mid",
           "empty_row", "mixed", "shared_length"]


def _write_symbol(row, off, width, value, little):
    """Overwrite the ``width``-bit symbol at bit ``off`` of a u8 row."""
    for i in range(width):
        pos = off + i
        bit = (value >> (i if little else width - 1 - i)) & 1
        mask = 1 << (pos & 7) if little else 0x80 >> (pos & 7)
        row[pos >> 3] = (int(row[pos >> 3]) & ~mask & 0xFF) | (mask * bit)


def _damaged_batch(ref, case, fix, rng):
    """(payloads u8[N, PB], plens) of streams packed by the JAX package,
    then damaged as ``case`` says."""
    spec = _port(ref)
    little = spec.endianness.value == "little"
    n_rows = 6
    dense, counts = _random_dense(spec, n_rows, 9000, rng.integers(1 << 30))
    if case in ("mixed", "shared_length"):
        # Short streams beside long ones: at code size 2 several counts
        # share a byte length, and the EOI read picks among them.
        counts[2:] = rng.integers(0, 40, n_rows - 2)
    pay, plens = jsched.pack_variable(dense, counts, ref, fix_eoi=fix)
    pay, plens = pay.copy(), plens.astype(np.int64)
    sched = tsched.Schedule(spec, 9001)
    period = int(np.nonzero(sched.clear_after)[0][0]) + 1
    rows = range(1, n_rows)
    if case == "flip_byte":
        for i in rows:
            pay[i, rng.integers(plens[i])] ^= 1 << rng.integers(8)
    elif case == "cut":
        for i in rows:
            cut = 1 + i % 3
            pay[i, plens[i] - cut:] = 0
            plens[i] -= cut
    elif case == "flip_last":
        for i in rows:
            pay[i, plens[i] - 1] ^= 0xFF
    elif case == "bad_lead":
        for i in rows[::2]:
            _write_symbol(pay[i], 0, spec.initial_width, spec.clear_code ^ 1,
                          little)
    elif case == "bad_mid":
        # The CLEAR after the first epoch, in the rows that have one.
        m = period - 1
        off = int(sched.bit_off[m] + sched.widths[m])
        hit = [i for i in range(n_rows) if counts[i] > period]
        assert hit
        for i in hit:
            _write_symbol(pay[i], off, 12, spec.end_code, little)
    elif case == "empty_row":
        pay[[0, 3]] = 0
        plens[[0, 3]] = 0
    elif case == "shared_length":
        # Write an EOI where every other count of the same byte length
        # would end, so that several candidates read one and their order
        # decides; in odd rows break the stream's own EOI as well.
        _, _, total = sched.eoi_tables(fix)
        nbytes = (total + 7) // 8
        shared = 0
        for i in range(2, n_rows):
            n = int(counts[i])
            others = [int(k) for k in np.nonzero(nbytes == nbytes[n])[0]
                      if k != n]
            shared += bool(others)
            for k, value in [(k, spec.end_code) for k in others] + (
                    [(n, 0)] if i % 2 else []):
                w = sched.eoi_width(k, fix)
                _write_symbol(pay[i], int(total[k] - w), w, value, little)
        if ref.code_size == 2:
            assert shared
    return pay, plens


@pytest.mark.parametrize("fix", [True, False], ids=["fix_eoi", "no_fix"])
@pytest.mark.parametrize("case", DAMAGED)
@pytest.mark.parametrize("name", ["gif2", "gif7", "gif8", "tiff", "var4be"])
def test_recover_counts_on_damaged_streams(name, case, fix):
    ref = REF_SPECS[name]
    rng = np.random.default_rng([len(name), DAMAGED.index(case), fix])
    pay, plens = _damaged_batch(ref, case, fix, rng)
    # The whole matrix, then the same cut narrower than its longest row.
    for cut, mat in enumerate((pay, pay[:, : pay.shape[1] // 2 + 1])):
        lens = np.minimum(plens, mat.shape[1])
        c_ref, strict_ref, S_ref = jsched.recover_counts(mat, lens, ref)
        c, strict, S = tsched.recover_counts(mat, lens, _port(ref))
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_array_equal(strict, strict_ref)
        assert S == S_ref
        if case == "intact" and not cut:
            assert strict.all()


@pytest.mark.parametrize("name", ["gif2", "gif7", "gif8", "tiff", "var4be"])
def test_schedule_tables_are_prefix_consistent(name):
    ref = REF_SPECS[name]
    spec = _port(ref)
    period = int(np.nonzero(tsched.Schedule(spec, 9000).clear_after)[0][0]) + 1
    sizes = {0, 1, 2, 3, 5}
    for edge in (64, 4096, 8192, period, 2 * period):
        sizes |= {edge - 1, edge, edge + 1}
    for S in sorted(sizes):
        fresh = tsched.Schedule(spec, S)
        sliced = tsched.emission_schedule(spec, S)
        assert sliced.n_max == S
        for field in ("widths", "clear_after", "nxt_of", "epoch_start",
                      "bit_off", "next_width"):
            np.testing.assert_array_equal(getattr(sliced, field),
                                          getattr(fresh, field),
                                          err_msg=f"{field} at {S}")
        tabs = tsched._tables(spec, S)
        assert tabs.sched.n_max >= S
        for rule, fix in enumerate((False, True)):
            off, w, total = fresh.eoi_tables(fix)
            np.testing.assert_array_equal(tabs.eoi_off[rule, : S + 1], off)
            np.testing.assert_array_equal(tabs.eoi_w[rule, : S + 1], w)
            np.testing.assert_array_equal(tabs.nbytes[rule, : S + 1],
                                          (total + 7) // 8)
            dev = tsched._device_tables(spec, S, fix, torch.device("cpu"))
            np.testing.assert_array_equal(dev["eoi_off"].numpy(), off)
            np.testing.assert_array_equal(dev["eoi_w"].numpy(), w)
            assert dev["max_bits"] == total[S]
        clear_m = np.nonzero(fresh.clear_after)[0]
        k = np.searchsorted(tabs.clear_m, S)
        np.testing.assert_array_equal(tabs.clear_m[:k], clear_m)
        np.testing.assert_array_equal(
            tabs.clear_off[:k], fresh.bit_off[clear_m] + fresh.widths[clear_m])
        np.testing.assert_array_equal(dev["clear_m"].numpy(), clear_m)
        np.testing.assert_array_equal(dev["bit_off"].numpy(),
                                      fresh.bit_off[:S])
        np.testing.assert_array_equal(
            tsched.schedule_rows(spec, S),
            np.stack([fresh.nxt_of - 1, fresh.epoch_start]).astype(np.int32))
        # The byte lengths never fall, over the whole cached table.
        assert (np.diff(tabs.nbytes, axis=1) >= 0).all()
    # The reference's schedule at one size on each side of the period.
    for S in (period - 1, period + 1):
        a, b = jsched.Schedule(ref, S), tsched.emission_schedule(spec, S)
        for field in ("widths", "clear_after", "bit_off", "next_width"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field))


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
        "'lzw_tpu_torch.utils.gifwrap', 'lzw_tpu_torch.ops.decode', "
        "'lzw_tpu_torch.ops.encode', 'lzw_tpu_torch.ops.bitpack'} "
        "<= set(names), names; "
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
