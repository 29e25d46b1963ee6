"""What the differential suites (tests/test_torch_differential_*.py) share:
the spec table, the input maker, the outcome of a call, the port's
container routes and the JAX Pallas pass 1 as a witness.  Not a test
module: pytest collects nothing here."""

import jax.numpy as jnp
import numpy as np

from lzw_tpu.kernels import decode_pallas
from lzw_tpu.spec import CodeSizeStrategy as JStrategy
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwError as JLzwError
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import BlockParallelCodec, LzwError

SPECS = {
    "gif2": JSpec.gif(2),
    "gif3": JSpec.gif(3),
    "gif5": JSpec.gif(5),
    "gif8": JSpec.gif(8),
    "tiff": JSpec.tiff(),
    "fixed_le": JSpec.fixed(JEndianness.LITTLE),
    "fixed_be": JSpec.fixed(JEndianness.BIG),
    "var6_be_tiff": JSpec.variable(6, JEndianness.BIG, JStrategy.TIFF),
}
# The specs whose alphabet leaves bytes past it (code size below 8).
NARROW = ["gif2", "gif3", "gif5", "var6_be_tiff"]
VARIABLE = [n for n, s in SPECS.items() if s.variable]
BLOCKS = [512, 4096]
ROUTES = ("auto", "host", "device")


def runs_data(jspec, n: int, seed: int, head: int) -> np.ndarray:
    """``n`` bytes: ``head`` random over the alphabet's first 16 values (or
    all of it), then runs of 12 of them (long phrases, KwKwK-heavy, and few
    codes a block: the plain pass 1 steps through a block's codes one by
    one)."""
    rng = np.random.default_rng(seed)
    hi = min(1 << jspec.code_size, 16)
    data = rng.integers(0, hi, size=n).astype(np.uint8)
    runs = np.repeat(rng.integers(0, hi, size=n // 12 + 1), 12)
    data[head:] = runs[: n - head].astype(np.uint8)
    return data


def outcome(fn, *args):
    """("ok", result) or (error class name, code or None)."""
    try:
        return "ok", fn(*args)
    except (LzwError, JLzwError) as exc:
        return type(exc).__name__, getattr(exc, "code", None)


def routes(spec, block_size: int, container: bytes) -> dict:
    """The port's container decode on every ``pass2`` route, on the CPU."""
    return {r: outcome(BlockParallelCodec(spec, block_size, device="cpu",
                                          pass2=r).decode, container)
            for r in ROUTES}


def pallas_pass1(jspec, payload: bytes, block_size: int):
    """(err, err_code, strict) of the JAX Pallas pass 1 on one payload, in
    interpret mode at the shapes of tests/test_decode_pallas.py (group=128,
    cell=64, seg=64).  err 2 is a word past ``block_size``."""
    mat = np.zeros((128, ((len(payload) + 2) // 3) * 3 + 3), np.uint8)
    plens = np.zeros(128, np.int32)
    mat[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    plens[0] = len(payload)
    if jspec.variable:
        _, _, _, err, code, strict, _ = (
            decode_pallas.decode_pass1_variable_tpu(
                mat, plens, jspec, block_size, interpret=True, group=128,
                cell=64, seg=64))
        return int(np.asarray(err)[0]), int(np.asarray(code)[0]), bool(
            strict[0])
    _, _, _, err, code, _ = decode_pallas.decode_pass1_fixed_tpu(
        jnp.asarray(mat[:, : mat.shape[1] - 3]), jnp.asarray(plens),
        block_size, little=jspec.endianness is JEndianness.LITTLE,
        interpret=True, group=128, cell=64, seg=64)
    return int(np.asarray(err)[0]), int(np.asarray(code)[0]), True
