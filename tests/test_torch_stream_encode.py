"""The single-stream encoder's edge cases and its kernel's layout, on the
CPU.

``lzw_tpu_torch.utils.testdata.stream_encode_edge_cases`` through the plain
version of ``lzw_tpu_torch.kernels.encode.encode_stream_codes`` against the
dense codes of ``lzw_tpu.ops.encode.encode_block`` on JAX's CPU backend
(read out of its slots), and ``lzw_tpu_torch.ops.encode.encode_stream_bytes``
against the JAX facade's ``_encode_jax`` and the port's oracle; each case
against the edge it claims; the wrapper's refusals; the kernel's CTA
against its source; the plain chain of the chain-step probe.  Every value is an integer: tolerance 0.  The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py::test_stream_encode_edge_cases_match_plain``).
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzw_tpu.api import LzwCodec as JCodec
from lzw_tpu.ops import encode as jencode
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels import chains, probe
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.ops import encode as tencode
from lzw_tpu_torch.ops import reference as toracle
from lzw_tpu_torch.scripts import chain_probe
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, UnexpectedCodeError
from lzw_tpu_torch.utils import testdata
from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

SPECS = {
    "gif2": JSpec.gif(2),
    "gif7": JSpec.gif(7),
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
}
ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"
CSRC = pathlib.Path(tenc.__file__).resolve().parent / "csrc"
# JAX compiles its scan once per row width: rows are padded to these.
BUCKET = 16384


@functools.lru_cache(maxsize=None)
def _edge(name):
    """(labels, rows, lens, plain outputs as numpy, with positions)."""
    spec = from_reference_spec(SPECS[name])
    labels, mat, lens = testdata.stream_encode_rows(spec)
    got = tenc.encode_stream_codes(torch.from_numpy(mat),
                                   torch.from_numpy(lens), spec)
    pos = tenc.encode_blocks_codes_reference(
        torch.from_numpy(mat), torch.from_numpy(lens), spec,
        positions=True)[4]
    return labels, mat, lens, [g.numpy() for g in got] + [pos.numpy()]


def _jax_dense(data: bytes, jspec):
    """The dense codes, err and err_code of the JAX ``encode_block`` on
    ``data``: the miss slots' codes where a width is set, then the final
    prefix's slot."""
    B = max(-(-len(data) // BUCKET) * BUCKET, BUCKET)
    block = np.zeros(B, np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    out = jencode.encode_block(jnp.asarray(block), jnp.int32(len(data)),
                               jspec)
    codes, widths = np.asarray(out["codes"]), np.asarray(out["widths"])
    first = 1 if jspec.variable else 0
    miss = slice(first, first + 2 * B, 2)
    final = first + 2 * B
    dense = codes[miss][widths[miss] > 0].tolist()
    if widths[final] > 0:
        dense.append(int(codes[final]))
    return dense, int(out["error"]), int(out["error_code"])


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_rows_match_jax(name):
    labels, mat, lens, (dense, counts, err, err_code, _) = _edge(name)
    for row, label in enumerate(labels):
        want, e, ec = _jax_dense(mat[row, : lens[row]].tobytes(), SPECS[name])
        n = int(counts[row])
        assert dense[row, :n].tolist() == want, label
        assert not dense[row, n:].any(), label
        assert (int(err[row]), int(err_code[row])) == (e, ec), label


def _claims(spec, lens, dense, counts, err, err_code, pos):
    """What each case must show, as a predicate of its row."""
    ff = spec.first_free_code
    R = spec.alphabet_size if spec.variable else 256
    P = testdata.epoch_misses(spec) if spec.variable else None

    def codes(r):
        return dense[r, : counts[r]]

    def ok(r):
        return err[r] == 0

    return {
        "empty": lambda r: counts[r] == 0 and ok(r),
        "one byte": lambda r: counts[r] == 1 and ok(r),
        # Phrases of 1, 2, 3, ... bytes: each miss emits the code its miss
        # before inserted (the final prefix is a part of a phrase).
        "one byte repeated": lambda r: ok(r) and counts[r] > 50 and (
            codes(r)[1:-1] == ff + np.arange(counts[r] - 2)).all(),
        # (a, a) missed, inserted, then hit on the next step.
        "a a a": lambda r: codes(r)[1:].tolist() == [ff] and ok(r),
        # Every step misses: one code a byte.
        "every pair once": lambda r: counts[r] == lens[r] and ok(r),
        "reset on the last byte": lambda r: ok(r) and counts[r] == P + 1
        and pos[r, P - 1] == lens[r] - 1,
        # The byte after the reset misses in the empty table.
        "one byte past a reset": lambda r: ok(r) and counts[r] == P + 2
        and pos[r, P - 1] == lens[r] - 2 and pos[r, P] == lens[r] - 1,
        "several full epochs": lambda r: ok(r) and counts[r] > 3 * P,
        # The second epoch repeats the first one's strings on empty
        # tables: its j-th code is a root or one of the j entries it has
        # inserted, never a code of the first epoch.
        "the same strings in two epochs": lambda r: ok(r)
        and (codes(r)[P: P + 50] < ff + np.arange(50)).all(),
        "long past the freeze": lambda r: ok(r)
        and counts[r] > MAX_TABLE_SIZE - ff + 5000,
        "bad byte at index 1": lambda r: err[r] == 1 and counts[r] == 0
        and err_code[r] > spec.max_code_value,
        "bad byte at index 0": lambda r: ok(r)
        and codes(r)[0] > spec.max_code_value,
        # The bad byte ends a phrase of several bytes: the step before it
        # was a hit.
        "bad byte in a run of hits": lambda r: err[r] == 1
        and err_code[r] > spec.max_code_value and pos[r, counts[r] - 1] < 599,
    }


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_cases_show_their_edge(name):
    labels, _, lens, out = _edge(name)
    spec = from_reference_spec(SPECS[name])
    claims = _claims(spec, lens, *out)
    for row, label in enumerate(labels):
        assert claims[label](row), label
    # Rows of very different lengths in one launch.
    assert lens.max() > 1000 * max(lens.min(), 1)


@functools.lru_cache(maxsize=None)
def _corpora():
    lorem = (ASSETS / "lorem_ipsum.txt").read_bytes()
    tokyo = load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")
    size = 1 << 16
    return {"text": (lorem * (-(-size // len(lorem))))[:size],
            "image": (tokyo * (-(-size // len(tokyo))))[:size]}


@pytest.mark.parametrize("name", list(SPECS))
def test_stream_bytes_match_jax_facade(name):
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    streams = [c.data for c in testdata.stream_encode_edge_cases(spec)
               if not c.label.startswith("bad byte at index 1")
               and c.label != "bad byte in a run of hits"]
    # The corpora where the alphabet holds their bytes.
    streams += [d for d in _corpora().values()
                if max(d) <= spec.max_code_value]
    jax_codec = JCodec(jspec, backend="jax")
    for data in streams:
        got = tencode.encode_stream_bytes(data, spec, device="cpu")
        assert got == jax_codec._encode_jax(data), len(data)
        assert got == toracle.encode_bytes(data, spec), len(data)


@pytest.mark.parametrize("name", ["gif2", "gif7"])
def test_stream_bytes_raise_on_a_bad_byte(name):
    spec = from_reference_spec(SPECS[name])
    for case in testdata.stream_encode_edge_cases(spec):
        if case.label in ("bad byte at index 1", "bad byte in a run of hits"):
            with pytest.raises(UnexpectedCodeError) as exc:
                tencode.encode_stream_bytes(case.data, spec, device="cpu")
            assert exc.value.code > spec.max_code_value


def test_wrapper_refuses_other_inputs():
    spec = from_reference_spec(SPECS["gif7"])
    blocks = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(TypeError):
        tenc.encode_stream_codes(blocks.to(torch.int32), lens, spec)
    with pytest.raises(ValueError):
        tenc.encode_stream_codes(torch.zeros((64, 2), dtype=torch.uint8).t(),
                                 lens, spec)
    with pytest.raises(ValueError):
        tenc.encode_stream_codes(blocks, lens[:1], spec)
    with pytest.raises(ValueError):
        tenc.encode_stream_codes(blocks.to("meta"), lens.to("meta"), spec)


def test_wrapper_plain_equals_the_container_plain():
    # On the CPU both wrappers run the one plain version.
    spec = from_reference_spec(SPECS["tiff"])
    _, mat, lens, out = _edge("tiff")
    got = tenc.encode_blocks_codes(torch.from_numpy(mat),
                                   torch.from_numpy(lens), spec)
    for g, w in zip(got, out):
        np.testing.assert_array_equal(g.numpy(), w)


# ---- the kernel's CTA -----------------------------------------------------

def _constants() -> dict[str, int]:
    """The integer ``constexpr int`` constants at the top level of
    ``stream_encode.cu``, each expression evaluated over the ones before
    it."""
    text = (CSRC / "stream_encode.cu").read_text()
    out: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) =\s*([^;]+);",
                                 text, re.M):
        out[name] = int(eval(" ".join(expr.split()).replace("/", "//"),
                             {}, dict(out)))
    return out


def test_layout_matches_the_source():
    k = _constants()
    assert chains.STREAM_ENCODE == (k["kThreads"], k["kSharedBytes"])
    assert k["kSharedBytes"] == k["kHashBytes"] + k["kRingBytes"] + \
        k["kBaseBytes"]
    assert chains.STREAM_ENCODE.shared_bytes <= chains.MAX_SHARED_BYTES
    assert k["kThreads"] % 32 == 0 and k["kThreads"] <= 1024
    # The hash holds a whole epoch at a load factor of a quarter, and its
    # slots are 2 * code ^ m(byte): twice the codes' range.
    assert 4 * MAX_TABLE_SIZE <= k["kHashSlots"]
    assert k["kHashSlots"] & (k["kHashSlots"] - 1) == 0
    assert k["kRingBytes"] % k["kChunk"] == 0 and k["kChunk"] % 16 == 0


@pytest.mark.parametrize("name", list(SPECS))
def test_every_flavor_fits_the_cta(name):
    # Every flavor takes the one CTA: its codes fit the link (code << 4 in
    # 16 bits), a root's slot (byte << 4 ^ m) stays in the table, and the
    # first free code leaves room below the table size.
    spec = from_reference_spec(SPECS[name])
    k = _constants()
    R = spec.alphabet_size if spec.variable else 256
    assert (MAX_TABLE_SIZE - 1) << 4 < 1 << 16
    assert (R - 1) << 4 < k["kHashBytes"]
    assert spec.first_free_code < MAX_TABLE_SIZE
    assert chains.STREAM_ENCODE.shared_bytes <= chains.MAX_SHARED_BYTES


# ---- the chain-step probe -------------------------------------------------

@pytest.mark.parametrize("mode", list(probe.CHAIN_MODES))
def test_chain_probe_plain_follows_its_table(mode):
    # The probe's tables keep each chain inside them, and the plain chain
    # steps as the kernel's does: the load chain walks one cycle of every
    # word, the stream chain's links stay 16-byte offsets.
    host, start = chain_probe.table(mode)
    assert host.shape == (probe.CHAIN_WORDS,) and host.dtype == np.int32
    steps = 64
    got = probe.chain_steps_reference(torch.from_numpy(host), start, mode,
                                      steps)
    words = host.astype(np.int64) & 0xFFFFFFFF
    x, k = start, 0
    seen = set()
    for _ in range(steps):
        if mode in ("load", "branch", "store"):
            x = int(words[x])
            seen.add(x)
        elif mode == "parse":
            key = (x * ((2654435761 << 8) & 0xFFFFFFFF)
                   + k * 2654435761) & 0xFFFFFFFF
            x = int(words[(key * 7168) >> 32]) & 0xFFF
        else:
            assert x % 16 == 0 and x < 1 << 16
            mix = ((k * 0x9E3779B1) & 0xFFFFFFFF) >> 16 & 0xFFF8
            x = int(words[((x ^ mix) >> 2) + 1])
        k = (k + 37) & 127
    assert got == x
    if mode in ("load", "branch", "store"):
        assert len(seen) == steps


def test_chain_probe_needs_the_card():
    host, start = chain_probe.table("load")
    with pytest.raises(ValueError):
        probe.chain_steps(torch.from_numpy(host), start, "load", 1, 8)
