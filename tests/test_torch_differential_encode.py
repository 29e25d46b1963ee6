"""The port's public encode routes against the JAX package's, case by case.

Each case makes its input with ``numpy.random.default_rng`` from a fixed
seed and encodes it through the port on the CPU (the kernels' plain
versions) and through the JAX package on its CPU backend:

* the block container, ``BlockParallelCodec(device="cpu")`` against the
  JAX ``BlockParallelCodec`` (its XLA route, the one its tests run), and
  each payload against the port's oracle and its native single-stream
  encode;
* the per-block encode, ``ops.encode.encode_block`` + ``pack_codes_torch``
  against ``encode_block`` + ``pack_codes_jax``;
* the facades, ``backend="torch", device="cpu"`` against ``backend="jax"``.

Inputs: clean data, a first byte past the alphabet in every block (never
range-checked: the first code is masked to its slot, as the oracle and
``pack_codes_jax`` do), and one byte past the alphabet mid-stream (the same
``UnexpectedCodeError`` code everywhere).  Bytes are compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from lzw_tpu import api as japi
from lzw_tpu.ops import bitpack as jbitpack
from lzw_tpu.ops import encode as jencode
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import LzwError as JLzwError

from lzw_tpu_torch import (
    BlockParallelCodec, FixedCodec, GifCodec, LzwError, TiffCodec,
    VariableCodec, from_reference_spec,
)
from lzw_tpu_torch.kernels.encode import encode_blocks_codes
from lzw_tpu_torch.native.runtime import get_runtime
from lzw_tpu_torch.ops import bitpack, encode
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.parallel import framing
from torch_differential import BLOCKS, NARROW, SPECS, outcome, runs_data


def _data(jspec, block_size: int, seed: int) -> np.ndarray:
    """Two and a half blocks, the first half random, then runs."""
    n = 2 * block_size + block_size // 2
    return runs_data(jspec, n, seed, head=n // 2)


def _first_bytes_past(jspec, data: np.ndarray, block_size: int,
                      seed: int) -> np.ndarray:
    """``data`` with the first byte of every block set past the alphabet."""
    rng = np.random.default_rng(seed)
    out = data.copy()
    starts = np.arange(0, len(out), block_size)
    out[starts] = rng.integers(1 << jspec.code_size, 256, size=len(starts))
    return out


def _codecs(name: str, block_size: int):
    jspec = SPECS[name]
    return (JaxCodec(jspec, block_size=block_size),
            BlockParallelCodec(from_reference_spec(jspec), block_size,
                               device="cpu"))


def _payloads(container: bytes) -> list[bytes]:
    return [bytes(p) for p in framing.parse_frame(container)[1]]


def _assert_payloads_are_single_streams(name, container, data, block_size):
    """Each payload is its block's single-stream encode: the port's native
    encoder with the container's EOI width, and the oracle wherever that
    width is salzweg's (no EOI width quirk)."""
    spec = from_reference_spec(SPECS[name])
    rt = get_runtime()
    quirks = 0
    for i, p in enumerate(_payloads(container)):
        block = bytes(data[i * block_size : (i + 1) * block_size])
        assert p == rt.encode(block, spec, fix_eoi=True), i
        if oracle.eoi_width_quirk(oracle.encode_codes(block, spec), spec):
            quirks += 1
        else:
            assert p == oracle.encode_bytes(block, spec), i
    assert quirks < len(_payloads(container))


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", list(SPECS))
def test_clean_containers_agree(name, block_size):
    data = _data(SPECS[name], block_size, seed=block_size + len(name))
    ref, codec = _codecs(name, block_size)
    got = codec.encode(data.tobytes())
    assert got == ref.encode(data.tobytes())
    _assert_payloads_are_single_streams(name, got, data, block_size)


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", NARROW)
def test_first_byte_past_the_alphabet(name, block_size):
    """Every block's first code is masked to its slot: the port's container
    equals the JAX container's XLA route and each payload its block's
    oracle and native single-stream encode.  The parse's dense codes (the
    kernel's boundary array) keep the whole byte."""
    jspec = SPECS[name]
    data = _first_bytes_past(
        jspec, _data(jspec, block_size, seed=7 * block_size), block_size,
        seed=len(name))
    ref, codec = _codecs(name, block_size)
    got = codec.encode(data.tobytes())
    assert got == ref.encode(data.tobytes())
    _assert_payloads_are_single_streams(name, got, data, block_size)
    blocks = torch.from_numpy(data[: 2 * block_size].reshape(2, block_size))
    dense = encode_blocks_codes(blocks, torch.full((2,), block_size,
                                                   dtype=torch.int32),
                                from_reference_spec(jspec))[0]
    np.testing.assert_array_equal(dense[:, 0].numpy(),
                                  data[[0, block_size]])


@pytest.mark.parametrize("name", NARROW)
def test_verify_flags_a_first_byte_past_the_alphabet(name):
    """``verify=True`` decodes the largest payload back and finds the masked
    first byte: both containers raise VerificationError for the same
    block."""
    jspec = SPECS[name]
    data = _first_bytes_past(jspec, _data(jspec, 512, seed=3), 512, seed=4)
    spec = from_reference_spec(jspec)
    errors = []
    for codec in (JaxCodec(jspec, block_size=512, verify=True),
                  BlockParallelCodec(spec, 512, device="cpu", verify=True)):
        with pytest.raises((JLzwError, LzwError)) as info:
            codec.encode(data.tobytes())
        errors.append((type(info.value).__name__, info.value.block_index))
    assert errors[0] == errors[1]
    assert errors[0][0] == "VerificationError"


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", NARROW)
def test_byte_past_the_alphabet_mid_stream(name, block_size):
    jspec = SPECS[name]
    data = _data(jspec, block_size, seed=11)
    at = block_size + block_size // 3
    data[at] = 255 - len(name)
    ref, codec = _codecs(name, block_size)
    want = outcome(ref.encode, data.tobytes())
    assert want == ("UnexpectedCodeError", int(data[at]))
    assert outcome(codec.encode, data.tobytes()) == want
    block = data[block_size : 2 * block_size].tobytes()
    assert outcome(_facade(name, "torch").encode, block) == want
    assert outcome(_facade(name, "jax").encode, block) == want


@pytest.mark.parametrize("fix", [False, True], ids=["salzweg", "fix_eoi"])
@pytest.mark.parametrize("name", NARROW)
def test_encode_block_and_pack_codes(name, fix):
    """``encode_block`` + ``pack_codes_torch`` == ``encode_block`` +
    ``pack_codes_jax`` on rows whose first byte lies past the alphabet:
    the oracle's bytes (salzweg), the container's payloads (fix_eoi)."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    B = 512
    data = _first_bytes_past(jspec, _data(jspec, B, seed=5), B, seed=6)
    mat = np.zeros((3, B), np.uint8)
    mat.reshape(-1)[: len(data)] = data
    lens = np.array([B, B, len(data) - 2 * B], np.int32)
    out_bytes = jencode.packed_bound(B, jspec)

    def jax_one(b, n):
        res = jencode.encode_block(b, n, jspec, fix_eoi_width=fix)
        return jbitpack.pack_codes_jax(res["codes"], res["widths"],
                                       jspec.endianness, out_bytes)

    want_b, want_n = (np.asarray(a) for a in jax.vmap(jax_one)(mat, lens))
    res = encode.encode_block(torch.from_numpy(mat), torch.from_numpy(lens),
                              spec, fix_eoi_width=fix)
    got_b, got_n = bitpack.pack_codes_torch(res["codes"], res["widths"],
                                            spec.endianness, out_bytes)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    rows = [got_b[i, : int(got_n[i])].numpy().tobytes() for i in range(3)]
    if fix:
        container = BlockParallelCodec(spec, B, device="cpu").encode(
            data.tobytes())
        assert rows == _payloads(container)
    else:
        assert rows == [oracle.encode_bytes(mat[i, : lens[i]].tobytes(),
                                            spec) for i in range(3)]


def _facade(name: str, backend: str):
    """The named facade of ``name``'s spec: the port's on the CPU with
    ``backend="torch"``, the JAX package's with ``backend="jax"``."""
    jspec = SPECS[name]
    if backend == "jax":
        mod, spec, kw = japi, jspec, {"backend": "jax"}
    else:
        mod = None
        spec = from_reference_spec(jspec)
        kw = {"backend": "torch", "device": "cpu"}
    if name.startswith("gif"):
        return (mod.GifCodec if mod else GifCodec)(spec.code_size, **kw)
    if name == "tiff":
        return (mod.TiffCodec if mod else TiffCodec)(**kw)
    if name.startswith("fixed"):
        return (mod.FixedCodec if mod else FixedCodec)(spec.endianness, **kw)
    return (mod.VariableCodec if mod else VariableCodec)(
        spec.code_size, spec.endianness, spec.strategy, **kw)


@pytest.mark.parametrize("name,kind", [(n, "clean") for n in SPECS] + [
    (n, "first_byte_past") for n in NARROW])
def test_facades_encode_alike(name, kind):
    """The port's "torch" facade == the JAX "jax" facade == the oracle, on
    one stream of each kind."""
    data = _data(SPECS[name], 512, seed=2)
    if kind == "first_byte_past":
        data = _first_bytes_past(SPECS[name], data, len(data), seed=9)
    got = _facade(name, "torch").encode(data.tobytes())
    assert got == _facade(name, "jax").encode(data.tobytes())
    assert got == oracle.encode_bytes(data.tobytes(),
                                      from_reference_spec(SPECS[name]))
