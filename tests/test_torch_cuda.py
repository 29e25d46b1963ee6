"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no interpret mode), so
they skip elsewhere.  The card's machine has no JAX, so run them without
``tests/conftest.py`` (which imports it)::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Codes and descriptors are integers: every comparison is exact.
"""

import pathlib

import numpy as np
import pytest
import torch

from lzw_tpu_torch import BlockParallelCodec, Endianness, LzwSpec
from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.utils.corpus import load_corpus

pytestmark = pytest.mark.cuda

SPECS = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
         "tiff": LzwSpec.tiff(), "fixed": LzwSpec.fixed(Endianness.LITTLE)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocks(spec, n, size, seed):
    rng = np.random.default_rng(seed)
    hi = spec.alphabet_size if spec.variable else 256
    mat = rng.integers(0, hi, size=(n, size)).astype(np.uint8)
    mat[n // 2 :] = np.resize(
        rng.integers(0, hi, size=48).astype(np.uint8), (n - n // 2, size))
    lens = rng.integers(0, size + 1, size=n).astype(np.int32)
    lens[0] = size
    return mat, lens


@pytest.mark.parametrize("name", list(SPECS))
def test_kernels_match_plain(name, cuda):
    spec = SPECS[name]
    mat, lens = _blocks(spec, 16, 6000, seed=len(name))
    blocks = torch.from_numpy(mat).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    before = dict(build.LAUNCHES)
    enc = tenc.encode_blocks_codes(blocks, lens_t, spec)
    ref = tenc.encode_blocks_codes_reference(blocks, lens_t, spec)
    for got, want in zip(enc, ref):
        assert torch.equal(got, want)
    assert build.LAUNCHES["encode_parse"] == before["encode_parse"] + 1

    dense, counts = enc[0], enc[1]
    if spec.variable:
        width = max(int(counts.max()), 1)
        pay, nb = tsched.pack_variable(dense[:, :width], counts, spec)
        cnt, strict, sched, S = tdec.prepare_variable_decode(
            pay.cpu().numpy(), nb.cpu().numpy(), spec)
        assert strict.all()
        cnt_t = torch.from_numpy(cnt.astype(np.int32)).to(cuda)
        codes, _ = tsched.unpack_variable_device(pay, cnt_t, spec, S)
        sched_t = torch.from_numpy(sched).to(cuda)
    else:
        pay, nb = tenc.pack12(dense, counts, True)
        codes, cnt_t = tdec.unpack12(pay, nb, True)
        sched_t = None
    got = tdec.decode_pass1(codes, cnt_t, spec, 6000, sched_t)
    want = tdec.decode_pass1_reference(codes, cnt_t, spec, 6000, sched_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["decode_pass1"] == before["decode_pass1"] + 1


def test_container_round_trip_on_card(cuda):
    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    for spec, data in ((LzwSpec.gif(7), corpus["tokyo"]),
                       (LzwSpec.fixed(Endianness.BIG),
                        corpus["lorem_ipsum"] * 8)):
        codec = BlockParallelCodec(spec, device=cuda)
        container = codec.encode(data)
        cpu = BlockParallelCodec(spec, device="cpu")
        assert container == cpu.encode(data)
        assert codec.decode(container) == data
