"""The single-stream encoder's edge cases and its kernel's layout, on the
CPU.

``lzw_tpu_torch.utils.testdata.stream_encode_edge_cases`` through the plain
version of ``lzw_tpu_torch.kernels.encode.encode_stream_codes`` against the
dense codes of ``lzw_tpu.ops.encode.encode_block`` on JAX's CPU backend
(read out of its slots), and ``lzw_tpu_torch.ops.encode.encode_stream_bytes``
against the JAX facade's ``_encode_jax`` and the port's oracle; each case
against the edge it claims; the plain mirror of the kernel's table
(``stream_table_reference``) against the plain version, and its hash and
layout against the kernel's source; the wrapper's refusals; the plain chain
of the chain-step probe.  Every value is an integer: tolerance 0.  The
kernel itself, its steps too, is held against the plain version on the
card (``tests/test_torch_cuda.py::test_stream_encode_edge_cases_match_plain``).
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


@functools.lru_cache(maxsize=None)
def _table(name):
    """The mirror of the kernel's table on the edge rows, as numpy."""
    spec = from_reference_spec(SPECS[name])
    _, mat, lens, _ = _edge(name)
    return [w.numpy() for w in tenc.stream_table_reference(
        torch.from_numpy(mat), torch.from_numpy(lens), spec)]


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


def _claims(spec, lens, dense, counts, err, err_code, pos, walk):
    """What each case must show, as a predicate of its row."""
    ff = spec.first_free_code
    R = spec.alphabet_size if spec.variable else 256
    P = testdata.epoch_misses(spec) if spec.variable else None
    chunk = chains.STREAM_ENCODE_CHUNK

    def codes(r):
        return dense[r, : counts[r]]

    def ok(r):
        return err[r] == 0

    def phrases(r):
        """(start, length) of each code's phrase."""
        ends = pos[r, : counts[r]].astype(np.int64)
        starts = np.concatenate([[0], ends[:-1]])
        return starts, ends - starts

    def longest(n):
        # Phrases of 1..n bytes, then one of another byte and a last one.
        return lambda r: ok(r) and phrases(r)[1].tolist() == \
            list(range(1, n + 1)) + [1, 1]

    def across(r):
        starts, lengths = phrases(r)
        ends = starts + lengths
        return ok(r) and any(
            s < m * chunk < e and e - s > tenc.LANES + 1
            for s, e in zip(starts, ends) for m in (1, 2))

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
        **{f"a phrase of {n} bytes": longest(n) for n in (32, 33, 34, 64, 65)},
        "a long phrase across a chunk": across,
        # A probe met an entry of the other string with the very hash and
        # last byte, looking up a string too long for one step: the
        # rounds of all lanes probe past it.
        "two strings with one content hash": lambda r: ok(r)
        and walk[r, 1] > 0 and walk[r, 2] > tenc.LANES + 1,
        # Phrases of 1..31 bytes, then 32 hits and the bad byte.
        "bad byte as a phrase's 33rd": lambda r: err[r] == 1
        and counts[r] == 31 and err_code[r] > spec.max_code_value,
        "bad byte as a phrase's 34th": lambda r: err[r] == 1
        and counts[r] == 32 and err_code[r] > spec.max_code_value,
        # first_free names the first step's key, reached only as the child
        # of the code that the first byte's value takes later.
        "the first byte's key hit": lambda r: ok(r)
        and codes(r)[0] > spec.max_code_value and ff in codes(r)[1:],
    }


@pytest.mark.parametrize("name", list(SPECS))
def test_edge_cases_show_their_edge(name):
    labels, _, lens, out = _edge(name)
    spec = from_reference_spec(SPECS[name])
    claims = _claims(spec, lens, *out, _table(name)[4])
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
               if not c.label.startswith("bad byte")
               or c.label == "bad byte at index 0"]
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
        if case.label.startswith("bad byte") and \
                case.label != "bad byte at index 0":
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


# ---- the kernel's CTA and the mirror of its walk ----------------------

def _source() -> str:
    return (CSRC / "stream_encode.cu").read_text()


def _constants() -> dict[str, int]:
    """The integer ``constexpr`` constants at the top level of
    ``stream_encode.cu``, each expression evaluated over the ones before
    it."""
    out: dict[str, int] = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|uint32_t) (k\w+) =\s*([^;]+);", _source(),
            re.M):
        expr = re.sub(r"\b(0x[0-9A-Fa-f]+)u\b", r"\1", " ".join(expr.split()))
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


def test_layout_matches_the_source():
    k = _constants()
    assert chains.STREAM_ENCODE == (k["kThreads"], k["kSharedBytes"])
    assert chains.STREAM_ENCODE_CHUNK == k["kChunk"]
    assert k["kSharedBytes"] == (k["kHashBytes"] + k["kPrefixBytes"]
                                 + k["kRingBytes"] + k["kFlagBytes"])
    assert chains.STREAM_ENCODE.shared_bytes <= chains.MAX_SHARED_BYTES
    # Two warps: the chain's and the ring's.
    assert k["kThreads"] == 2 * k["kLanes"] == 64
    # Two slots a bucket; the narrow step's 2-byte strings hash with the
    # base squared (mod 2^32 in the kernel's u32).
    assert k["kBucketBits"] == k["kSlotBits"] - 1
    assert k["kPair"] == k["kHashBase"] ** 2
    # The table holds a whole epoch at a load factor of a quarter.
    assert 4 * MAX_TABLE_SIZE <= k["kHashSlots"] == 1 << k["kSlotBits"]
    assert k["kHashBytes"] == 8 * k["kHashSlots"]
    # A round at offset o < kChunk of its chunk reads bytes kLead + o - 1 ..
    # kLead + o + kLanes - 1 and prefix hashes up to kLead + o + kLanes of
    # the chunk's span, and a span is kLanes pieces of 16 bytes.
    assert k["kSpan"] >= k["kLead"] + k["kChunk"] + k["kLanes"] + 1
    assert k["kLead"] % 16 == 0 and k["kSpan"] % 16 == 0
    assert k["kPiece"] * k["kLanes"] == k["kSpan"]
    assert k["kPrefixStride"] > k["kSpan"] and k["kPrefixStride"] % 4 == 0
    assert k["kRingBytes"] == k["kRing"] * k["kSpan"]
    assert k["kPrefixBytes"] == 4 * k["kRing"] * k["kPrefixStride"]


def test_mirror_follows_the_source():
    # The plain mirror's hash and table take the kernel's constants: the
    # base, the slot and bucket bits, the lanes, the tags, and the byte mix
    # (murmur3's finaliser of b + 1, its constants as the source has them).
    k = _constants()
    assert (tenc.HASH_BASE, tenc.SLOT_BITS, tenc.BUCKET_BITS, tenc.LANES,
            tenc.TAGS) == (k["kHashBase"], k["kSlotBits"], k["kBucketBits"],
                           k["kLanes"], k["kTags"])
    body = re.search(r"uint32_t mixed\(uint32_t b\) \{(.*?)\n\}", _source(),
                     re.S).group(1)
    m1, m2 = (int(x, 16) for x in re.findall(r"0x([0-9A-Fa-f]+)u", body))
    shifts = [int(x) for x in re.findall(r">> (\d+)", body)]
    assert "b + 1" in body and shifts == [16, 13, 16]
    for b in range(256):
        h = b + 1
        h ^= h >> 16
        h = (h * m1) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * m2) & 0xFFFFFFFF
        assert tenc.MIXED[b] == h ^ (h >> 16)
    data = bytes(range(7, 40))
    assert tenc.content_hash(data) == tenc.content_hash(
        data[10:], tenc.content_hash(data[:10]))
    # The first slot of the last bucket; buckets start at even slots.
    assert tenc.home_slot(0xFFFFFFFF) == k["kHashSlots"] - 2
    assert {tenc.home_slot(h) % 2 for h in (0, 1 << 19, 12345678)} == {0}


def test_hash_collision_is_one():
    a, b = testdata.hash_collision()
    assert a != b and len(a) == len(b) and set(a + b) <= {0, 1, 2, 3}
    assert tenc.content_hash(a) == tenc.content_hash(b)


@pytest.mark.parametrize("name", list(SPECS))
def test_table_mirror_matches_plain(name):
    # The mirror of the kernel's table gives the plain version's outputs on
    # every edge row and on 64 KiB of image and text; the collision row's
    # probes meet the other string's hash, a candidate among them.
    labels, _, _, out = _edge(name)
    table = _table(name)
    for g, w in zip(table[:4], out[:4]):
        np.testing.assert_array_equal(g, w)
    row = labels.index("two strings with one content hash")
    assert table[4][row, 0] >= table[4][row, 1] > 0
    assert (table[4][:, 1] <= table[4][:, 0]).all()
    spec = from_reference_spec(SPECS[name])
    for data in _corpora().values():
        if max(data) > spec.max_code_value:
            continue
        row = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
        lens = torch.tensor([len(data)], dtype=torch.int32)
        got = tenc.stream_table_reference(row, lens, spec)
        want = tenc.encode_blocks_codes_reference(row, lens, spec)
        for g, w in zip(got[:4], want):
            assert torch.equal(g, w)


def test_wrapper_counts_steps_on_the_cpu():
    # With stats the CPU wrapper gives the plain version's phrases as its
    # steps (the codes, and one for an error) and no rounds.
    spec = from_reference_spec(SPECS["gif7"])
    _, mat, lens, out = _edge("gif7")
    got = tenc.encode_stream_codes(torch.from_numpy(mat),
                                   torch.from_numpy(lens), spec, stats=True)
    for g, w in zip(got[:4], out[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[4].numpy()[:, 0], out[1] + out[2])
    assert not got[4].numpy()[:, 1].any()


@pytest.mark.parametrize("name", list(SPECS))
def test_every_flavor_fits_the_cta(name):
    # Every flavor takes the one CTA: an entry's 12-bit code and parent
    # fields hold every code, its byte field every root, and the first free
    # code leaves room below the table size.
    spec = from_reference_spec(SPECS[name])
    R = spec.alphabet_size if spec.variable else 256
    assert MAX_TABLE_SIZE <= 1 << 12 and R <= 1 << 8
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
