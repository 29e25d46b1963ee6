"""The port's public decode routes against the JAX package's, case by case.

Each case makes a container with ``numpy.random.default_rng`` from a fixed
seed, corrupts one payload byte, and decodes it through the port's
``BlockParallelCodec(device="cpu")`` on every ``pass2`` route (``"auto"``,
``"host"``, ``"device"``: the kernels' plain versions and the native
runtime) and through the JAX package's ``BlockParallelCodec`` (its XLA
route, the one its tests run); then one corrupt stream through the
facades, ``backend="torch", device="cpu"`` against ``backend="jax"``.

The port's container contract is the oracle's decode of each block with
its output bounded at ``block_size`` (``reference.decode_bytes(...,
out_bound=block_size)``): the first failing block's first error in
container order, and a ``FramingError`` for a length the frame does not
give.  The JAX XLA route decodes each block whole and cuts it at
``block_size``.  The two agree, bytes or error class and code, on every
block that stays within its size; a block that passes it is the agreed
divergence of tests/test_torch_differential_overflow.py, and there the
port's code is the JAX Pallas pass 1's (interpret mode, at the shapes of
tests/test_decode_pallas.py).
"""

import numpy as np
import pytest

from lzw_tpu import api as japi
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec

from lzw_tpu_torch import BlockParallelCodec, LzwCodec, from_reference_spec
from lzw_tpu_torch.ops import reference as oracle
from lzw_tpu_torch.parallel import framing
from torch_differential import (
    BLOCKS, ROUTES, SPECS, outcome, pallas_pass1, routes, runs_data,
)


def _data(jspec, n: int, seed: int) -> bytes:
    """``n`` bytes, the first quarter random, then runs."""
    return runs_data(jspec, n, seed, head=n // 4).tobytes()


def _model(payloads, spec, block_size: int, orig_size: int,
           bounded: bool):
    """The container decode block by block with the oracle: each block's
    output bounded at ``block_size`` (the port's contract), or decoded
    whole and cut there (the JAX XLA route)."""
    out = []
    for p in payloads:
        got = oracle.decode_bytes(bytes(p), spec,
                                  out_bound=block_size if bounded else None)
        out.append(got[:block_size])
    out = b"".join(out)
    if len(out) != orig_size:
        raise framing.FramingError(f"decoded {len(out)} bytes")
    return out


@pytest.mark.parametrize("block_size", BLOCKS)
@pytest.mark.parametrize("name", list(SPECS))
def test_corrupt_payload_byte(name, block_size):
    """One payload byte XOR-ed, four seeds: every port route gives the
    bounded oracle's outcome, and the JAX XLA route the cut one; the two
    differ only where the corrupt block passes ``block_size``, and there
    the port's code is the JAX Pallas pass 1's."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    data = _data(jspec, 2 * block_size + block_size // 2, seed=block_size)
    ref = JaxCodec(jspec, block_size=block_size)
    container = BlockParallelCodec(spec, block_size, device="cpu").encode(
        data)
    assert ref.decode(container) == data
    payloads = [bytearray(p) for p in framing.parse_frame(container)[1]]
    kinds = set()
    for seed in range(4):
        rng = np.random.default_rng([seed, block_size, len(name)])
        bad = [bytearray(p) for p in payloads]
        b = int(rng.integers(0, len(bad)))
        bad[b][int(rng.integers(0, len(bad[b])))] ^= int(rng.integers(1, 256))
        frame = framing.pack_frame(spec, block_size, len(data),
                                   [bytes(p) for p in bad])
        want = outcome(_model, bad, spec, block_size, len(data), True)
        cut = outcome(_model, bad, spec, block_size, len(data), False)
        got = routes(spec, block_size, frame)
        assert got == {r: want for r in ROUTES}, seed
        assert outcome(ref.decode, frame) == cut, seed
        if want != cut:
            kinds.add("overflow")
            err, code, strict = pallas_pass1(jspec, bytes(bad[b]),
                                              block_size)
            if strict:
                assert (err, code) == (2, want[1]), seed
        else:
            kinds.add(want[0])
    assert kinds != {"ok"}, "no corruption was detected"


@pytest.mark.parametrize("name", list(SPECS))
def test_facades_decode_alike(name):
    """The port's "torch" facade == the JAX "jax" facade == the oracle on
    a clean stream and on six corrupt ones (a stream has no block bound)."""
    jspec = SPECS[name]
    spec = from_reference_spec(jspec)
    data = _data(jspec, 900, seed=12)
    stream = oracle.encode_bytes(data, spec)
    port = LzwCodec(spec, backend="torch", device="cpu")
    ref = japi.LzwCodec(jspec, backend="jax")
    assert port.decode(stream) == ref.decode(stream) == data
    for seed in range(6):
        rng = np.random.default_rng([seed, len(name)])
        bad = bytearray(stream)
        bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        want = outcome(oracle.decode_bytes, bytes(bad), spec)
        assert outcome(port.decode, bytes(bad)) == want, seed
        assert outcome(ref.decode, bytes(bad)) == want, seed
