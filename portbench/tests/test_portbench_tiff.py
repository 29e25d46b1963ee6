"""The TIFF-strips configuration (``configs/tiff-strips.json``): its
loading, the reference against the program's container at the
early-change edges and on a whole page, the program's decode of the
reference's strips, and the readers of host work a block.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import generator, harness
from portbench.corpus import load_plane
from portbench.reference import container, lzw
from portbench.reference.lzw import Wire

CONFIG = harness.HERE / "configs" / "tiff-strips.json"
CELL = "tiff-strips-image-one"
STRIP = 8192
TIFF = Wire.from_dict({"flavor": "variable", "code_size": 8,
                       "endianness": "big", "strategy": "tiff"})
# The table's next index at which the width grows, early: the data codes
# of a strip whose table ends there (258 + codes - 1 entries).
EDGES = {511: 254, 1023: 766, 2047: 1790}
# An 8 KiB window of the plane whose strip ends on the 2,047 edge.
FULL_EDGE_AT = 652800


@pytest.fixture(scope="module")
def plane():
    return load_plane(harness.HERE / "data" / "tokyo_128_colors.png")


def _codes(x: bytes) -> int:
    return len(lzw.parse_stream(x, TIFF))


def _cut(plane, start: int, n_codes: int) -> bytes:
    """The shortest run of the plane from ``start`` that parses into
    ``n_codes`` codes (a byte more adds at most one code)."""
    lo, hi = 1, STRIP
    while lo < hi:
        mid = (lo + hi) // 2
        if _codes(plane[start:start + mid].tobytes()) < n_codes:
            lo = mid + 1
        else:
            hi = mid
    x = plane[start:start + lo].tobytes()
    assert _codes(x) == n_codes
    return x


def _edge_page(plane, edge: int, delta: int, seed: int) -> bytes:
    """A full strip from a seeded offset, then a short last strip of
    ``EDGES[edge] + delta`` codes."""
    start = int(np.random.default_rng(seed).integers(0, len(plane) - STRIP))
    return plane[start:start + STRIP].tobytes() + _cut(
        plane, start + STRIP, EDGES[edge] + delta)


def _page(plane, seed: int) -> bytes:
    """The cell's input: the plane rotated by a seeded offset."""
    mix = generator.load_mix(harness.HERE / "traffic" / "one-image.json")
    mix.update(inputs=2)
    return generator.make_inputs(mix, plane, STRIP, seed)[0].data


def _case(plane, name: str) -> bytes:
    if name == "page":
        return _page(plane, 2**31 + 41)
    if name == "full-2047":
        middle = plane[FULL_EDGE_AT:FULL_EDGE_AT + STRIP].tobytes()
        assert _codes(middle) == EDGES[2047]
        return (plane[:STRIP].tobytes() + middle
                + _cut(plane, FULL_EDGE_AT + STRIP, 100))
    _, edge, delta = name.split(":")
    return _edge_page(plane, int(edge), int(delta), int(edge) + int(delta))


CASES = [f"last:{e}:{d}" for e in EDGES for d in (-1, 0, 1)] + [
    "full-2047", "page"]


@pytest.mark.parametrize("name", CASES)
def test_tiff_container_equals_the_programs(plane, name):
    from lzw_tpu_torch import BlockParallelCodec, LzwSpec

    x = _case(plane, name)
    codec = BlockParallelCodec(LzwSpec.tiff(), STRIP, device="cpu",
                               verify=False, pass2="host")
    assert container.encode(x, TIFF, STRIP) == codec.encode(x)


def test_a_page_is_86_strips(plane):
    from lzw_tpu_torch.parallel import framing

    x = _page(plane, 7)
    assert len(x) == 700416
    assert framing.block_count(container.encode(x, TIFF, STRIP)) == 86
    assert len(x) - 85 * STRIP == 4096
    # Every strip crosses the bumps at 511 and 1,023, and none fills the
    # table: no CLEAR after the first.
    counts = [_codes(x[i:i + STRIP]) for i in range(0, len(x), STRIP)]
    assert min(counts) > EDGES[1023]
    assert 258 + max(counts) - 1 < TIFF.threshold(12)


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_the_programs_decode_reads_the_references_strips(plane, edge):
    """The device route (on the CPU its plain versions): count recovery
    and the unpack, MSB-first, of strips that end on an edge."""
    from lzw_tpu_torch import BlockParallelCodec, LzwSpec

    x = _edge_page(plane, edge, 0, edge)
    want = container.encode(x, TIFF, STRIP)
    codec = BlockParallelCodec(LzwSpec.tiff(), STRIP, device="cpu",
                               verify=False, pass2="device")
    assert codec.decode(want) == x
    assert container.decode(want) == x


def test_the_configuration_loads(plane):
    from lzw_tpu_torch import LzwSpec

    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, CELL)
    assert cell.config == json.loads(CONFIG.read_text())
    assert harness.entry(cell.config) == "container"
    assert harness.block_size(cell.config) == STRIP
    assert cell.config["codec"] == {"pass2": "auto", "verify": True}
    spec = harness.program_spec(cell.config["wire"])
    assert spec.wire_equivalent(LzwSpec.tiff())
    assert Wire.from_dict(cell.config["wire"]) == TIFF
    inputs = generator.make_inputs(cell.mix, plane, STRIP, 2**31 + 5)
    assert [len(i.data) for i in inputs] == [700416] * 8
    assert len({i.data for i in inputs}) == 8
    (entry,) = [c for c in bench["configs"] if c["name"] == "tiff-strips"]
    assert entry["reduced"] == [] and entry["file"].endswith(CONFIG.name)
    # The per-block readers list the three container cells.
    for name in ("block.enc_host_us_per_block", "block.dec_host_us_per_block"):
        for w in ("gif7-image-one", "fixed12-image-one", CELL):
            assert name in {m["name"] for m in harness.metric_entries(
                bench, w, True)}


def _run(profiled: bool):
    cell = harness.Cell("c", 1, {}, {})
    calls = [harness.Call(op, "profiled", 0, 1, 1e-4)
             for op in ("encode", "encode", "decode")]
    return harness.Run(cell, 0, profiled, 1.0, calls, [],
                       {"encode": {}, "decode": {}} if profiled else None)


@pytest.fixture
def tally(monkeypatch):
    from lzw_tpu_torch.utils import spans as program_spans

    fresh = program_spans.Tally()
    monkeypatch.setattr(program_spans, "PROFILED", fresh)
    return fresh


def _read(name, run):
    return harness.load_reader(name).read(run)


def test_the_per_block_readers(tally):
    for name, seconds in (("lzw.enc_host_prep", 0.002),
                          ("lzw.enc_payloads", 0.001),
                          ("lzw.enc_verify", 0.003), ("lzw.pack_frame", 0.002),
                          ("lzw.enc_kernel", 0.5), ("lzw.enc_pack", 0.5),
                          ("lzw.parse_frame", 0.001),
                          ("lzw.dec_host_prep", 0.002),
                          ("lzw.dec_errors", 0.0005),
                          ("lzw.dec_count_recovery", 0.5)):
        tally.add(name, seconds)
    run = _run(True)
    # A parent without the counters: nothing to read, and no raise.
    assert _read("block.enc_host_us_per_block", run) is None
    assert _read("block.dec_host_us_per_block", run) is None
    tally.add("encode.blocks", 172)
    tally.add("decode.blocks", 86)
    # (2 + 1 + 3 + 2) ms over 172 blocks; (1 + 2 + 0.5) ms over 86.
    assert _read("block.enc_host_us_per_block", run) == \
        pytest.approx(8000 / 172)
    assert _read("block.dec_host_us_per_block", run) == \
        pytest.approx(3500 / 86)
    # An untraced run reads nothing.
    assert _read("block.enc_host_us_per_block", _run(False)) is None


def test_the_per_block_readers_without_a_counter_tick(tally):
    tally.add("lzw.enc_host_prep", 0.001)
    tally.add("encode.blocks", 0)
    assert _read("block.enc_host_us_per_block", _run(True)) is None
    assert _read("block.dec_host_us_per_block", _run(True)) is None
