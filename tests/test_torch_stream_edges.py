"""The single-stream decoder's edge cases and the epoch design of its
kernels, on the CPU.

``lzw_tpu_torch.utils.testdata.stream_edge_rows`` (one launch of rows of
very different lengths, random bytes past each stream) through the plain
versions of ``lzw_tpu_torch.ops.decode`` against ``lzw_tpu.ops.decode`` on
JAX's CPU backend, field by field; the cases against what they claim; the
epoch width pattern ``epoch_widths`` against the encoder's ``Schedule``
and the plain pass 1's bit cursor; and the kernels' shared bytes and grids
against their sources.  Every value is an integer: tolerance 0.
The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py::test_stream_edge_cases_match_plain``).
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.ops import decode as jdecode
from lzw_tpu.ops import reference as joracle
from lzw_tpu.spec import CodeSizeStrategy as JStrategy
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels import chains
from lzw_tpu_torch.kernels.schedule import Schedule
from lzw_tpu_torch.ops import decode
from lzw_tpu_torch.spec import MAX_TABLE_SIZE
from lzw_tpu_torch.utils import testdata

SPECS = {
    "gif2": JSpec.gif(2),
    "gif7": JSpec.gif(7),
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
    "var4_be_tiff": JSpec.variable(4, JEndianness.BIG, JStrategy.TIFF),
}
CSRC = pathlib.Path(decode.__file__).resolve().parent.parent / "kernels" / "csrc"


@functools.lru_cache(maxsize=None)
def _edge(name):
    """(labels, rows, n_valid, plain pass 1 outputs as numpy)."""
    spec = from_reference_spec(SPECS[name])
    labels, mat, lens = testdata.stream_edge_rows(spec)
    out = decode.decode_pass1_reference(torch.from_numpy(mat),
                                        torch.from_numpy(lens), spec)
    return labels, mat, lens, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_rows_pass1_match_jax(name):
    _, mat, lens, plain = _edge(name)
    for row in range(len(lens)):
        want = jdecode.decode_pass1(jnp.asarray(mat[row]),
                                    jnp.int32(lens[row]), SPECS[name])
        for key, w in want.items():
            np.testing.assert_array_equal(plain[key][row], np.asarray(w),
                                          err_msg=f"row {row} {key}")


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_rows_decode_block_match_jax(name):
    labels, mat, lens, plain = _edge(name)
    spec = from_reference_spec(SPECS[name])
    bound = int(plain["total_len"].max())
    got = decode.decode_block(torch.from_numpy(mat), torch.from_numpy(lens),
                              spec, bound)
    for row in range(len(lens)):
        want = jdecode.decode_block(jnp.asarray(mat[row]),
                                    jnp.int32(lens[row]), SPECS[name], bound)
        for key, w in want.items():
            np.testing.assert_array_equal(
                got[key][row].numpy(), np.asarray(w),
                err_msg=f"{labels[row]}: {key}")


def _claims(spec, G):
    """What each case must show on the plain pass 1: (n_words, error,
    error_code) checks and a check of its words, by label."""
    ff, top = spec.first_free_code, (1 << spec.initial_width) - 1

    def step_after_clears(n):
        return lambda o, r: int(np.flatnonzero(
            (o["out_len"][r] == 0) & (np.arange(o["out_len"].shape[1])
                                      < o["n_words"][r]))[n - 1]) + 1

    def err(kind, code=None):
        return lambda o, r: o["error"][r] == kind and (
            code is None or o["error_code"][r] == code)

    if not spec.variable:
        return {
            "long past the freeze": lambda o, r: err(0)(o, r)
            and o["n_words"][r] > MAX_TABLE_SIZE + 1 - ff + 1000
            and o["glocal"][r].max() == MAX_TABLE_SIZE - 1,
            "first code reads UNINIT": lambda o, r: o["out_g"][r][0] == G - 1
            and o["out_lit"][r][0] and o["out_g"][r][1] == 256,
            "KwKwK at step 1": lambda o, r: o["out_g"][r][1] == 256
            and o["out_len"][r][1] == 2,
            "bad code at step 1": lambda o, r: err(1, 257)(o, r)
            and o["n_words"][r] == 2,
            "bad code at the last insert": lambda o, r: err(1, 4095)(o, r)
            and o["n_words"][r] == MAX_TABLE_SIZE - ff,
            "truncated inside a code": lambda o, r: err(0)(o, r),
            "truncated on a code boundary": lambda o, r: err(0)(o, r),
            "empty": lambda o, r: err(0)(o, r) and o["n_words"][r] == 1,
        }
    first = step_after_clears(2)
    return {
        "CLEAR, CLEAR": lambda o, r: err(0)(o, r)
        and o["out_len"][r][:2].tolist() == [0, 0],
        "no leading CLEAR": lambda o, r: err(0)(o, r) and o["out_lit"][r][0],
        "first code reads UNINIT": lambda o, r: o["out_g"][r][1] == G - 1
        and o["out_lit"][r][1] and err(0)(o, r),
        # Step 0 of the second epoch names an id of the first.
        "first code reads a stale entry": lambda o, r: err(0)(o, r)
        and spec.alphabet_size <= o["out_g"][r][first(o, r)] < G - 1
        and o["glocal"][r][o["out_g"][r][first(o, r)]] == min(ff + 5, top),
        "KwKwK at step 1": lambda o, r: o["out_g"][r][2] == spec.alphabet_size
        and o["out_len"][r][2] == 2,
        "bad code at step 1": lambda o, r: err(1, ff + 1)(o, r)
        and o["n_words"][r] == 3,
        "bad code at a width bump": lambda o, r: err(
            1, (1 << (spec.initial_width + 1)) - 1)(o, r),
        "truncated inside a code": lambda o, r: err(3)(o, r),
        "truncated on a code boundary": lambda o, r: err(3)(o, r),
        "missing CLEAR at a full table": lambda o, r: err(2)(o, r),
        "EOI at a width bump": lambda o, r: err(0)(o, r),
        # The old width reads the EOI with one more bit: truncated when it
        # ends on a byte, EOI again LSB-first, twice EOI MSB-first.
        "EOI at a width bump, old width": lambda o, r: o["n_words"][r] > 3,
        "full epochs": lambda o, r: err(0)(o, r)
        and (o["out_lit"][r]).sum() == 3,
        "empty": lambda o, r: err(3)(o, r) and o["n_words"][r] == 1,
    }


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_cases_show_their_edge(name):
    labels, mat, _, plain = _edge(name)
    spec = SPECS[name]
    G = plain["gprefix"].shape[1]
    claims = _claims(spec, G)
    assert sorted(claims) == sorted(labels)
    for row, label in enumerate(labels):
        assert claims[label](plain, row), label
    # Rows of very different lengths in one launch.
    n = plain["n_words"]
    assert n.max() > 1000 * n.min()


# ---- the epoch width pattern ----------------------------------------------

@pytest.mark.parametrize("name", list(SPECS))
def test_epoch_widths_match_the_schedule(name):
    spec = from_reference_spec(SPECS[name])
    widths, bits = decode.epoch_widths(spec)
    sched = Schedule(spec, len(widths) + 5)
    # The encoder's epoch is its data codes up to its CLEAR; the decoder's
    # runs on at 12 bits to the step that must end it.
    period = int(np.argmax(sched.epoch_start > 0)) or len(widths)
    assert len(widths) - period in ((1, 2) if spec.variable else (0,))
    np.testing.assert_array_equal(widths[:period], sched.widths[:period])
    np.testing.assert_array_equal(
        bits[:period], sched.bit_off[:period] - spec.initial_width)
    assert (widths[period:] == 12).all()
    np.testing.assert_array_equal(bits[1:], np.cumsum(widths))


def _real_streams(spec):
    rng = np.random.default_rng(3)
    hi = spec.alphabet_size if spec.variable else 256
    phrase = rng.integers(0, hi, 300).astype(np.uint8)
    datas = [rng.integers(0, hi, 30000).astype(np.uint8).tobytes(),
             np.resize(phrase, 60000).tobytes()]
    return [joracle.encode_bytes(d, SPECS[n]) for d in datas
            for n in SPECS if from_reference_spec(SPECS[n]) == spec]


@pytest.mark.parametrize("name", ["gif7", "tiff", "gif2", "fixed_le"])
def test_epoch_widths_reach_the_plain_cursor(name):
    spec = from_reference_spec(SPECS[name])
    widths, bits = decode.epoch_widths(spec)
    for stream in _real_streams(spec):
        S, G = decode._shapes(len(stream), spec)
        _, (_, out_len, _), _, _, (n, err, _, _), _, cursor = (
            decode._pass1_row(stream, len(stream), spec, S, G))
        assert err == 0
        if spec.variable:
            # Words have a length; the CLEARs and the EOI end the epochs.
            ends = np.flatnonzero(np.asarray(out_len[:n]) == 0)
            sizes = np.diff(np.concatenate([[-1], ends]))
            assert ends[-1] == n - 1 and len(ends) > 2
            assert cursor == int(bits[sizes].sum())
        else:
            # One epoch to the frozen table, 12 bits a step after it.
            K = len(widths)
            assert n > K and cursor == int(bits[K]) + 12 * (n - K)


# ---- the kernels' layouts -------------------------------------------------

def _constants(source: str) -> dict[str, int]:
    """The integer ``constexpr int`` constants of a kernel source, each
    expression evaluated over the ones before it."""
    text = (CSRC / source).read_text()
    out: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) =\s*([^;]+);",
                                 text):
        out[name] = int(eval(" ".join(expr.split()), {}, dict(out)))
    return out


@pytest.mark.parametrize("name", list(decode.STREAM_LAYOUTS))
def test_stream_layouts_match_the_sources(name):
    k = _constants(f"{name}.cu")
    layout = decode.STREAM_LAYOUTS[name]
    assert layout == (k["kThreads"], k["kSharedBytes"])
    assert layout.threads <= 1024 and layout.threads % 32 == 0
    assert layout.shared_bytes <= chains.MAX_SHARED_BYTES
    if name == "stream_pass2":
        assert k["kChunk"] == decode.PASS2_CHUNK
        assert k["kRoots"] == 256


@pytest.mark.parametrize("name", list(SPECS))
def test_an_epoch_fits_the_cta(name):
    # Each of pass 1's threads owns kPer steps of an epoch.
    spec = from_reference_spec(SPECS[name])
    k = _constants("stream_pass1.cu")
    widths, bits = decode.epoch_widths(spec)
    assert len(widths) < k["kSteps"] == k["kThreads"] * k["kPer"]
    assert k["kTable"] == MAX_TABLE_SIZE
    assert bits.dtype == np.int32 and not bits.flags.writeable


@pytest.mark.parametrize("rows, S, grid", [
    (1, 1, 1), (1, 2048, 1), (1, 2049, 2), (3, 2049, 6), (3, 0, 0),
    (0, 9, 0),
    # 32 x 1 MiB gif7 container rows, a 16 MiB gif7 facade stream.
    (32, 411_025, 32 * 201), (1, 5_395_045, 2635),
])
def test_pass2_grid(rows, S, grid):
    assert decode.pass2_grid(rows, S) == grid
