"""The port's container encode self-check (``verify=``), on the CPU.

Mirrors tests/test_verify.py at 4 KiB blocks: a clean round trip, a bit
flip, wrong content and corruption injected between the encode and the
framing must raise :class:`VerificationError`.  Where the native runtime
cannot build, the sample is decoded by the kernels' plain versions on the
CPU instead, with the same verdicts.  Payloads and bytes are compared
exactly.
"""

import numpy as np
import pytest

from lzw_tpu.ops import reference as oracle
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

import lzw_tpu_torch.parallel.block as block
from lzw_tpu_torch import (
    BlockParallelCodec, VerificationError, from_reference_spec,
)
from lzw_tpu_torch.kernels.decode import MAX_BLOCK
from lzw_tpu_torch.native.runtime import NativeRuntime
from lzw_tpu_torch.parallel import framing

BS = 4096
SPECS = {"gif7": JSpec.gif(7), "tiff": JSpec.tiff(),
         "fixed": JSpec.fixed(JEndianness.LITTLE)}


def _codec(name="gif7", block_size=BS, **kw):
    return BlockParallelCodec(from_reference_spec(SPECS[name]),
                              block_size=block_size, device="cpu", **kw)


def _data(name, n, seed):
    spec = SPECS[name]
    hi = spec.max_code_value + 1 if spec.variable else 256
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, n).astype(np.uint8).tobytes()


def _flipped(payload: bytes, mask: int) -> bytes:
    mut = bytearray(payload)
    mut[len(mut) // 2] ^= mask
    return bytes(mut)


@pytest.fixture
def no_runtime(monkeypatch):
    """A host whose native runtime cannot build; the runtime's decoders
    fail if anything still reaches them."""
    def cannot_build():
        raise OSError("g++: not found")

    def host_called(*args, **kwargs):
        raise AssertionError("verify called the native runtime")

    monkeypatch.setattr(block, "get_runtime", cannot_build)
    for name in ("decode", "decode_blocks", "apply_words"):
        monkeypatch.setattr(NativeRuntime, name, host_called)


def test_verify_clean_roundtrip():
    data = _data("gif7", 2 * BS + 100, seed=0)
    c = _codec(verify=True)
    assert c.verify
    out = c.encode(data)
    assert c.decode(out) == data


def test_verify_sample_rejects_bitflip():
    data = _data("gif7", BS, seed=1)
    c = _codec(verify=True)
    bad = _flipped(oracle.encode_bytes(data, SPECS["gif7"]), 0x40)
    with pytest.raises(VerificationError):
        c._verify_sample(data, [bad])


def test_verify_sample_rejects_wrong_content():
    data = _data("gif7", BS, seed=2)
    other = _data("gif7", BS, seed=3)
    c = _codec(verify=True)
    with pytest.raises(VerificationError) as ei:
        c._verify_sample(data, [oracle.encode_bytes(other, SPECS["gif7"])])
    assert ei.value.block_index == 0


def _inject(monkeypatch):
    """Flip a bit of the sampled (largest) payload just before the verify
    hook sees the batch."""
    orig_verify = BlockParallelCodec._verify_sample

    def inject_then_verify(self, d, payloads):
        payloads = list(payloads)
        i = max(range(len(payloads)), key=lambda k: len(payloads[k]))
        payloads[i] = _flipped(payloads[i], 0x11)
        return orig_verify(self, d, payloads)

    monkeypatch.setattr(BlockParallelCodec, "_verify_sample",
                        inject_then_verify)


def test_verify_catches_injected_corruption_end_to_end(monkeypatch):
    data = _data("gif7", 3 * BS, seed=4)
    _inject(monkeypatch)
    with pytest.raises(VerificationError):
        _codec(verify=True).encode(data)


def test_verify_default_off_on_the_cpu():
    # The kernels are in the path on CUDA only: verify defaults on there.
    assert _codec().verify is False
    assert _codec(verify=True).verify is True


@pytest.mark.parametrize("name", list(SPECS))
def test_verify_without_runtime_uses_the_plain_decode(name, no_runtime):
    data = _data(name, BS + 700, seed=5)
    c = _codec(name, verify=True)
    container = c.encode(data)
    assert container == _codec(name).encode(data)
    with pytest.raises(VerificationError):
        c._verify_sample(data, [_flipped(
            oracle.encode_bytes(data[:BS], SPECS[name]), 0x40)])
    with pytest.raises(VerificationError) as ei:
        c._verify_sample(data[:BS], [oracle.encode_bytes(
            _data(name, BS, seed=6), SPECS[name])])
    assert ei.value.block_index == 0


def test_verify_without_runtime_catches_injected_corruption(monkeypatch,
                                                            no_runtime):
    data = _data("gif7", 2 * BS, seed=7)
    _inject(monkeypatch)
    with pytest.raises(VerificationError):
        _codec(verify=True).encode(data)


def test_verify_without_runtime_past_max_block_raises_the_build_error(
        no_runtime):
    # The sample check of blocks past MAX_BLOCK needs no runtime (see the
    # next test); the decode of such blocks on the host route does, and
    # raises the build error.
    c = _codec(block_size=MAX_BLOCK + 1, verify=True, pass2="host")
    data = _data("gif7", MAX_BLOCK + 1, seed=8)
    container = framing.pack_frame(c.spec, MAX_BLOCK + 1, len(data), [
        oracle.encode_bytes(data, SPECS["gif7"])])
    with pytest.raises(OSError, match="g\\+\\+"):
        c.decode(container)


def test_verify_without_runtime_past_max_block_checks_the_sample(
        no_runtime):
    # Blocks past MAX_BLOCK have a plain decode (the single-stream
    # decoder), so the sample is checked without the runtime: a good one
    # passes and a wrong one raises VerificationError.
    c = _codec(block_size=MAX_BLOCK + 1, verify=True)
    data = _data("gif7", MAX_BLOCK + 1, seed=8)
    c._verify_sample(data, [oracle.encode_bytes(data, SPECS["gif7"])])
    with pytest.raises(VerificationError):
        c._verify_sample(data, [oracle.encode_bytes(data[:-1] + b"\x00",
                                                    SPECS["gif7"])])
