"""The agreed divergence: a container block that decodes past its size.

A block whose words pass ``block_size`` is corrupt.  The JAX package gives
three answers for it: its XLA route (the one its tests run) cuts the block
at ``block_size`` and returns the container's size in bytes, its native
``decode_blocks`` raises ``AssertionError("native output buffer undersized
(bug)")``, and its Pallas pass 1 (the TPU route) flags the code whose word
passes the block, the reference's chain-corruption class.  The port
follows the Pallas pass 1 on every route: ``BlockParallelCodec`` with
``pass2`` ``"auto"``, ``"host"`` and ``"device"``, for strict blocks (pass
1), foreign early-CLEAR blocks (the native ``decode_blocks`` or the
non-strict device route) and blocks past ``MAX_BLOCK`` (``decode_blocks``
or the single-stream decoder) alike, all on the CPU here.  The port's
native ``decode_blocks`` cannot name the code (``BlockOverflowError``); the
container names it through the device route.  The code is held against
the JAX package: its Pallas pass 1 (interpret mode, at the shapes of
tests/test_decode_pallas.py) on the strict block or on the foreign
stream's crossing epoch, and its single-stream pass 1 past ``MAX_BLOCK``;
the oracle bounded at ``block_size`` is held to the same code.  The two
faults of the reference are asserted as they stand, so that a change on
either side shows.  Inputs are made with ``numpy.random.default_rng``
from fixed seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lzw_tpu.native.runtime import get_runtime as jget_runtime
from lzw_tpu.native.runtime import native_available as jnative_available
from lzw_tpu.ops import decode as jdecode
from lzw_tpu.ops import reference as joracle
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import (
    BlockOverflowError, BlockParallelCodec, UnexpectedCodeError,
    from_reference_spec,
)
from lzw_tpu_torch.kernels.decode import MAX_BLOCK
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.utils.testdata import (
    spliced_nonstrict_stream, uninit_literal_stream,
)
from torch_differential import (
    BLOCKS, ROUTES, SPECS, VARIABLE, pallas_pass1, routes, runs_data,
)


def _data(jspec, n: int, seed: int) -> bytes:
    """``n`` bytes, the first quarter random, then runs."""
    return runs_data(jspec, n, seed, head=n // 4).tobytes()


def _overflow_container(jspec, block_size: int, stream: bytes, seed: int):
    """Three blocks of data with block 1's payload replaced by ``stream``,
    a stream that decodes past ``block_size``."""
    spec = from_reference_spec(jspec)
    data = _data(jspec, 3 * block_size, seed)
    payloads = [bytes(p) for p in framing.parse_frame(
        BlockParallelCodec(spec, block_size, device="cpu").encode(data))[1]]
    payloads[1] = stream
    return data, payloads, framing.pack_frame(spec, block_size, len(data),
                                              payloads)


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", list(SPECS))
def test_block_past_block_size(name, block_size):
    """The agreed divergence.  Block 1 holds a valid stream of
    ``block_size + 300`` bytes: every port route raises
    ``UnexpectedCodeError`` with the JAX Pallas pass 1's code (err 2) and
    the bounded oracle's; the JAX XLA route returns the container's size,
    block 1 cut at ``block_size``; the JAX native ``decode_blocks`` raises
    ``AssertionError``."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    longer = _data(jspec, block_size + 300, seed=block_size + 1)
    stream = get_runtime().encode(longer, spec, fix_eoi=True)
    data, payloads, frame = _overflow_container(jspec, block_size, stream,
                                                seed=len(name))
    err, code, strict = pallas_pass1(jspec, stream, block_size)
    assert strict and err == 2
    bounded = oracle.block_error([stream], spec, block_size)
    assert isinstance(bounded, UnexpectedCodeError) and bounded.code == code
    assert routes(spec, block_size, frame) == {
        r: ("UnexpectedCodeError", code) for r in ROUTES}
    assert JaxCodec(jspec, block_size=block_size).decode(frame) == (
        data[:block_size] + longer[:block_size] + data[2 * block_size :])
    if jnative_available():
        with pytest.raises(AssertionError, match="undersized"):
            jget_runtime().decode_blocks(payloads, jspec, block_size)


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", VARIABLE)
def test_nonstrict_block_past_block_size(name, block_size):
    """A foreign (early-CLEAR) stream of ``block_size + 2000`` bytes, in
    epochs of 1500, in block 1 takes the native ``decode_blocks`` on
    "auto" and "host" and the non-strict device route on "device".  Each
    raises ``UnexpectedCodeError`` with the code the JAX Pallas pass 1
    flags on the epoch that crosses ``block_size``, bounded at the room
    the earlier epochs leave (at 512 bytes the first epoch passes it
    alone; at 4096 the first three pass it together).  The JAX XLA route
    cuts the block."""
    piece = 1500
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    longer = _data(jspec, block_size + 2000, seed=5)
    stream = spliced_nonstrict_stream(longer, spec, piece)
    data, _, frame = _overflow_container(jspec, block_size, stream, seed=6)
    k, room = divmod(block_size, piece)
    epoch = joracle.encode_bytes(longer[k * piece : (k + 1) * piece], jspec)
    err, code, strict = pallas_pass1(jspec, epoch, room)
    assert strict and err == 2
    bounded = oracle.block_error([stream], spec, block_size)
    assert isinstance(bounded, UnexpectedCodeError) and bounded.code == code
    assert routes(spec, block_size, frame) == {
        r: ("UnexpectedCodeError", code) for r in ROUTES}
    assert JaxCodec(jspec, block_size=block_size).decode(frame) == (
        data[:block_size] + longer[:block_size] + data[2 * block_size :])


def _xla_passing_code(jspec, stream: bytes, bound: int) -> int:
    """The wire code whose word first ends past ``bound``, from the JAX
    single-stream pass 1 (XLA): the word's offset and length, and the code
    its dictionary entry was inserted under."""
    p1 = jdecode.decode_pass1(jnp.asarray(np.frombuffer(stream, np.uint8)),
                              jnp.int32(len(stream)), jspec)
    length = np.asarray(p1["out_len"])
    ends = np.asarray(p1["out_off"]).astype(np.int64) + length
    step = int(np.argmax((length > 0) & (ends > bound)))
    assert ends[step] > bound
    return int(np.asarray(p1["glocal"])[int(np.asarray(p1["out_g"])[step])])


@pytest.mark.parametrize("name", ["gif7", "fixed_be"])
def test_big_block_past_block_size(name):
    """Blocks past ``MAX_BLOCK`` take the native ``decode_blocks`` on
    "auto" and "host" and the single-stream decoder on "device": a block
    that decodes past its size raises, on each, ``UnexpectedCodeError``
    with the code whose word passes it in the JAX single-stream pass 1."""
    jspec = JSpec.gif(7) if name == "gif7" else SPECS[name]
    spec = from_reference_spec(jspec)
    block_size = 2 * MAX_BLOCK
    longer = _data(jspec, block_size + 700, seed=8)
    stream = get_runtime().encode(longer, spec, fix_eoi=True)
    data = _data(jspec, block_size + 100, seed=9)
    head = get_runtime().encode(data[:block_size], spec, fix_eoi=True)
    frame = framing.pack_frame(spec, block_size, len(data), [head, stream])
    code = _xla_passing_code(jspec, stream, block_size)
    bounded = oracle.block_error([stream], spec, block_size)
    assert isinstance(bounded, UnexpectedCodeError) and bounded.code == code
    assert routes(spec, block_size, frame) == {
        r: ("UnexpectedCodeError", code) for r in ROUTES}


@pytest.mark.parametrize("name", ["gif7", "tiff"])
def test_big_block_uninit_literal_past_block_size(name):
    """A block of ``2 * MAX_BLOCK`` whose stream fills the block exactly,
    then holds a CLEAR and a first code naming an entry never inserted:
    that one-byte literal passes ``block_size``.  Every route raises
    ``UnexpectedCodeError`` with the code read, the bounded oracle's.  The
    single-stream pass 1, the JAX package's as the port's, maps that code
    to its UNINIT entry, whose ``glocal`` names 0: the port names the code
    from pass 1's ``out_code``."""
    jspec = JSpec.gif(7) if name == "gif7" else SPECS[name]
    spec = from_reference_spec(jspec)
    block_size = 2 * MAX_BLOCK
    stream, code = uninit_literal_stream(spec, block_size)
    frame = framing.pack_frame(spec, block_size, block_size, [stream])
    bounded = oracle.block_error([stream], spec, block_size)
    assert isinstance(bounded, UnexpectedCodeError) and bounded.code == code
    assert code == (1 << spec.initial_width) - 1
    assert _xla_passing_code(jspec, stream, block_size) == 0
    assert routes(spec, block_size, frame) == {
        r: ("UnexpectedCodeError", code) for r in ROUTES}


@pytest.mark.parametrize("name", list(SPECS))
def test_native_decode_blocks_refuses_a_block_past_its_size(name):
    """The port's native ``decode_blocks`` raises ``BlockOverflowError``,
    with no code (the library reports only its full buffer), for a block
    that passes its size; the JAX package's raises ``AssertionError``."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    longer = _data(jspec, 812, seed=10)
    stream = get_runtime().encode(longer, spec, fix_eoi=True)
    ok = get_runtime().encode(longer[:512], spec, fix_eoi=True)
    with pytest.raises(BlockOverflowError) as info:
        get_runtime().decode_blocks([ok, stream, stream], spec, 512)
    assert info.value.block_size == 512
    assert not hasattr(info.value, "code")
    if jnative_available():
        with pytest.raises(AssertionError, match="undersized"):
            jget_runtime().decode_blocks([ok, stream, stream], jspec, 512)
