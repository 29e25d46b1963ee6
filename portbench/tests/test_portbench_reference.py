"""The benchmark's NumPy reference against salzweg's golden file and the
program's container on the CPU, and its decode's round trip.

Run from the repository root: ``python -m pytest portbench/tests -q``.
These tests may import the program; the reference itself may not.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import pathlib

import numpy as np
import pytest

from portbench import check, generator
from portbench.corpus import load_plane
from portbench.reference import container, lzw
from portbench.reference.lzw import Wire

DATA = pathlib.Path(__file__).resolve().parents[1] / "data"

WIRES = {
    "gif7": {"flavor": "variable", "code_size": 7},
    "fixed12": {"flavor": "fixed", "endianness": "little"},
    "fixed12-be": {"flavor": "fixed", "endianness": "big"},
    "tiff": {"flavor": "variable", "code_size": 8, "endianness": "big",
             "strategy": "tiff"},
    "gif2": {"flavor": "variable", "code_size": 2},
}


def _program_spec(name):
    from lzw_tpu_torch.spec import Endianness, LzwSpec

    return {"gif7": LzwSpec.gif(7),
            "fixed12": LzwSpec.fixed(Endianness.LITTLE),
            "fixed12-be": LzwSpec.fixed(Endianness.BIG),
            "tiff": LzwSpec.tiff(),
            "gif2": LzwSpec.gif(2)}[name]


def _sample(name: str, n: int, seed: int) -> bytes:
    """``n`` bytes of the image plane from a seeded offset, cut to the
    wire's alphabet."""
    plane = load_plane(DATA / "tokyo_128_colors.png")
    start = np.random.default_rng(seed).integers(0, len(plane) - n)
    x = plane[start:start + n]
    if name == "gif2":
        x = x & 3
    return x.tobytes()


def test_gif7_encode_is_salzwegs_golden_file():
    text = (DATA / "lorem_ipsum.txt").read_bytes()
    golden = (DATA / "lorem_ipsum_encoded.bin").read_bytes()
    assert lzw.encode_stream(text, Wire.from_dict(WIRES["gif7"])) == golden


@pytest.mark.parametrize("name", sorted(WIRES))
@pytest.mark.parametrize("seed,n,block", [(1, 20000, 4096), (2, 9000, 8192),
                                           (3, 3 * 4096, 4096)])
def test_container_equals_the_programs(name, seed, n, block):
    from lzw_tpu_torch import BlockParallelCodec

    x = _sample(name, n, seed)
    codec = BlockParallelCodec(_program_spec(name), block_size=block,
                               device="cpu", verify=False, pass2="host")
    assert container.encode(x, Wire.from_dict(WIRES[name]), block) == \
        codec.encode(x)


@pytest.mark.parametrize("name", sorted(WIRES))
def test_decode_round_trips(name):
    wire = Wire.from_dict(WIRES[name])
    x = _sample(name, 5 * 4096 + 123, 4)
    assert container.decode(container.encode(x, wire, 4096)) == x


def test_a_full_table_resets_and_round_trips():
    """A 64 KiB gif7 block fills the dictionary several times."""
    wire = Wire.from_dict(WIRES["gif7"])
    x = _sample("gif7", 65536, 5)
    codes, counts = lzw.parse(np.frombuffer(x, np.uint8)[None, :], wire)
    assert counts[0] > 2 * len(lzw.epoch_widths(wire))
    assert container.decode(container.encode(x, wire, 65536)) == x


def test_control_loses_each_blocks_last_word():
    wire = Wire.from_dict(WIRES["gif7"])
    x = _sample("gif7", 4 * 4096, 6)
    control = container.encode(x, wire, 4096, flush=False)
    assert control != container.encode(x, wire, 4096)
    y = container.decode(control)
    assert len(y) < len(x)


def test_pool_gives_the_same_containers():
    wire = Wire.from_dict(WIRES["fixed12"])
    xs = [_sample("fixed12", 6 * 4096 + 77, s) for s in (7, 8)]
    want = container.encode_many(xs, wire, 4096)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as ex:
        got = container.encode_many(xs, wire, 4096, executor=ex, shards=3)
        decoded = container.decode(
            container.assemble(wire, 4096, len(xs[0]), *got[0][:2]), ex, 3)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert decoded == xs[0]


def test_the_plane_is_the_programs():
    from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

    assert load_plane(DATA / "tokyo_128_colors.png").tobytes() == \
        load_tokyo_pixels(DATA / "tokyo_128_colors.png")


@pytest.mark.parametrize("name", sorted(WIRES))
@pytest.mark.parametrize("seed,n", [(9, 2), (10, 5000), (11, 70000)])
def test_one_stream_by_a_dictionary_is_the_lockstep_streams(name, seed, n):
    """The facade's reference, the dictionary parse of one stream, against
    the lockstep parse of one row: the same codes with and without the
    last, the same bytes, and a round trip through the decoder."""
    wire = Wire.from_dict(WIRES[name])
    x = _sample(name, n, seed)
    row = np.frombuffer(x, np.uint8)[None, :]
    for flush in (True, False):
        codes, counts = lzw.parse(row, wire, flush=flush)
        np.testing.assert_array_equal(
            lzw.parse_stream(x, wire, flush=flush), codes[0, :counts[0]])
        payload, _ = lzw.pack(codes, counts, wire, fix_eoi=False)
        got = lzw.encode_stream(x, wire, flush=flush)
        assert got == payload.tobytes()
        back = lzw.decode(np.frombuffer(got, np.uint8), [len(got)], wire)
        assert (back.tobytes() == x) == flush


def test_one_stream_is_salzwegs_golden_file():
    text = (DATA / "lorem_ipsum.txt").read_bytes()
    golden = (DATA / "lorem_ipsum_encoded.bin").read_bytes()
    wire = Wire.from_dict(WIRES["gif7"])
    assert lzw.encode_stream(text, wire) == golden
    raw = np.frombuffer(golden, np.uint8)
    assert lzw.decode(raw, [len(raw)], wire).tobytes() == text
    with pytest.raises(lzw.DecodeError):
        lzw.decode(raw[:-3], [len(raw) - 3], wire)


@pytest.mark.parametrize("pool", [False, True])
def test_a_facades_expected_streams_are_the_oracles(pool):
    from lzw_tpu_torch import GifCodec

    plane = load_plane(DATA / "tokyo_128_colors.png")
    mix = generator.load_mix(DATA.parent / "traffic" / "one-image.json")
    mix.update(inputs=3, bytes_per_call=30000)
    inputs = generator.make_inputs(mix, plane, None, 2**31 + 17)
    wire = Wire.from_dict(WIRES["gif7"])
    if pool:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as ex:
            want = check.expected_streams(inputs, wire, ex)
    else:
        want = check.expected_streams(inputs, wire)
    oracle = GifCodec(7, backend="oracle")
    for x, exp in zip(inputs, want):
        assert exp.container == oracle.encode(x.data)
        assert exp.payload_bytes == len(exp.container) and exp.blocks == 1
        assert exp.codes == len(lzw.parse_stream(x.data, wire))
        assert oracle.decode(exp.container) == x.data
