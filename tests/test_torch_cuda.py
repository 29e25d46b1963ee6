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
from lzw_tpu_torch.kernels import ablate, build, probe
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.utils import testdata
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


def _decode_inputs(spec, dense, counts, cuda):
    """Pack the encoder's dense codes and unpack them again: pass 1's codes,
    counts and schedule rows as the container's decode gives them."""
    if not spec.variable:
        pay, nb = tenc.pack12(dense, counts, True)
        codes, cnt_t = tdec.unpack12(pay, nb, True)
        return codes.contiguous(), cnt_t, None
    width = max(int(counts.max()), 1)
    pay, nb = tsched.pack_variable(dense[:, :width], counts, spec)
    cnt, strict, sched, S = tdec.prepare_variable_decode(
        pay.cpu().numpy(), nb.cpu().numpy(), spec)
    assert strict.all()
    cnt_t = torch.from_numpy(cnt.astype(np.int32)).to(cuda)
    codes, _ = tsched.unpack_variable_device(pay, cnt_t, spec, S)
    return codes, cnt_t, torch.from_numpy(sched).to(cuda)


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

    codes, cnt_t, sched_t = _decode_inputs(spec, enc[0], enc[1], cuda)
    got = tdec.decode_pass1(codes, cnt_t, spec, 6000, sched_t,
                            rows="stride2")
    want = tdec.decode_pass1_reference(codes, cnt_t, spec, 6000, sched_t,
                                       rows="stride2")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["decode_pass1"] == before["decode_pass1"] + 1

    words, totals, _, _, pair = got
    out = tdec.decode_pass2_stride2(codes, words, pair, cnt_t, 6000,
                                    spec, sched_t)
    ref = tdec.decode_pass2_stride2_reference(codes, words, pair, cnt_t,
                                              6000, spec, sched_t)
    assert torch.equal(out, ref)
    assert build.LAUNCHES["decode_pass2"] == before["decode_pass2"] + 1
    out = out.cpu().numpy()
    for i in range(len(lens)):
        assert int(totals[i]) == lens[i]
        assert (out[i, : lens[i]] == mat[i, : lens[i]]).all()


@pytest.mark.parametrize("name", list(SPECS))
def test_stride1_kernels_match_plain(name, cuda):
    # Pass 1's stride-1 pair rows and the stride-1 pass 2 against their
    # plain versions, and the bytes against the blocks.
    spec = SPECS[name]
    mat, lens = _blocks(spec, 16, 6000, seed=len(name) + 10)
    lens_t = torch.from_numpy(lens).to(cuda)
    dense, counts, _, _ = tenc.encode_blocks_codes(
        torch.from_numpy(mat).to(cuda), lens_t, spec)
    codes, cnt_t, sched_t = _decode_inputs(spec, dense, counts, cuda)
    before = dict(build.LAUNCHES)
    got = tdec.decode_pass1(codes, cnt_t, spec, 6000, sched_t,
                            rows="stride1")
    want = tdec.decode_pass1_reference(codes, cnt_t, spec, 6000, sched_t,
                                       rows="stride1")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    words, totals, _, _, pair = got
    out = tdec.decode_pass2_device(codes, words, pair, cnt_t, 6000, spec,
                                   sched_t)
    ref = tdec.decode_pass2_device_reference(codes, words, pair, cnt_t,
                                             6000, spec, sched_t)
    assert torch.equal(out, ref)
    assert build.LAUNCHES["decode_pass2_stride1"] == (
        before["decode_pass2_stride1"] + 1)
    assert build.LAUNCHES["decode_pass2"] == before["decode_pass2"]
    out = out.cpu().numpy()
    for i in range(len(lens)):
        assert int(totals[i]) == lens[i]
        assert (out[i, : lens[i]] == mat[i, : lens[i]]).all()


@pytest.mark.parametrize("block_size", [1 << 17, 5000])
def test_word_ends_kernel_matches_plain(block_size, cuda):
    # Rows spanning three of the kernel's 4096-slot tiles, rows cut at a
    # tile's edge, empty rows, counts past S and below 0, holes, and (at
    # 5000) ends clipped to the block size; the kernel writes live slots
    # only.
    rng = np.random.default_rng(5)
    N, S = 40, 9000
    kind = rng.integers(0, 4, (N, S))
    lens = rng.integers(0, 4096 if block_size == 5000 else 8, (N, S))
    w = ((kind << 29) | (lens << 17) | rng.integers(0, 1 << 17, (N, S)))
    words = torch.from_numpy(w.astype(np.int32)).to(cuda)
    n = rng.integers(0, S + 1, N)
    n[:7] = [0, 1, 4095, 4096, 4097, S, S + 9]
    n[7] = -2
    n_codes = torch.from_numpy(n.astype(np.int32)).to(cuda)
    before = build.LAUNCHES["word_ends"]
    got = tdec.word_ends(words, n_codes, block_size)
    assert build.LAUNCHES["word_ends"] == before + 1
    want = tdec._word_ends(words, n_codes, block_size)
    live = (torch.arange(S, device=cuda)[None, :]
            < n_codes.long()[:, None])
    assert torch.equal(got[live], want[live])
    assert bool((want[live] == block_size).any()) == (block_size == 5000)


@pytest.mark.parametrize("stride2", [True, False], ids=["stride2", "stride1"])
@pytest.mark.parametrize("name", list(SPECS))
def test_flat_walks_match_plain(name, stride2, cuda):
    # The flat walk against its plain version, the padded walk's masked
    # rows and the blocks; a corrupt middle block (long words, noise pair
    # rows) leaves the blocks around it as they were.
    spec = SPECS[name]
    mat, lens = _blocks(spec, 16, 6000, seed=len(name) + 20)
    lens[3] = 0
    lens_t = torch.from_numpy(lens).to(cuda)
    dense, counts, _, _ = tenc.encode_blocks_codes(
        torch.from_numpy(mat).to(cuda), lens_t, spec)
    codes, cnt_t, sched_t = _decode_inputs(spec, dense, counts, cuda)
    words, totals, err, _, pair = tdec.decode_pass1(
        codes, cnt_t, spec, 6000, sched_t,
        rows="stride2" if stride2 else "stride1")
    assert not err.any()
    if stride2:
        flat, padded = tdec.decode_pass2_stride2_flat, tdec.decode_pass2_stride2
        plain, walk = tdec.decode_pass2_stride2_reference, "decode_pass2"
    else:
        flat, padded = tdec.decode_pass2_device_flat, tdec.decode_pass2_device
        plain, walk = tdec.decode_pass2_device_reference, "decode_pass2_stride1"
    vspec = spec if spec.variable else None
    before = dict(build.LAUNCHES)
    got = flat(codes, words, pair, cnt_t, totals, 6000, vspec, sched_t)
    assert build.LAUNCHES[walk] == before[walk] + 1
    assert build.LAUNCHES["word_ends"] == before["word_ends"] + 1
    assert torch.equal(got, plain(codes, words, pair, cnt_t, 6000, vspec,
                                  sched_t, totals))
    rows = padded(codes, words, pair, cnt_t, 6000, vspec, sched_t).cpu()
    want = b"".join(mat[i, : lens[i]].tobytes() for i in range(len(lens)))
    assert got.cpu().numpy().tobytes() == want == b"".join(
        rows[i, : lens[i]].numpy().tobytes() for i in range(len(lens)))

    words, pair, codes = words.clone(), pair.clone(), codes.clone()
    words[1] = (words[1] & ~(0xFFF << 17)) | (4000 << 17)
    pair[1] = torch.from_numpy(np.random.default_rng(6).integers(
        -2**31, 2**31, pair.shape[1]).astype(np.int32)).to(cuda)
    codes[1] = codes[1] + 3
    got = flat(codes, words, pair, cnt_t, totals, 6000, vspec,
               sched_t).cpu().numpy()
    assert got.size == int(lens.sum())
    b0, b2 = int(lens[0]), int(lens[:2].sum())
    assert got[:b0].tobytes() == want[:b0]
    assert got[b2:].tobytes() == want[b2:]


def test_chain_edge_cases_match_plain(cuda):
    # The one-chain-per-warp kernels on the edges their design adds: warps
    # of one CTA that finish at different times, partly filled CTAs, more
    # blocks than one round of chains, full tables, resets, KwKwK runs,
    # errors, and the words past each block's stop that the warp writes
    # together; pass 1 with every row kind.
    n_enc, n_pass1 = testdata.check_edge_cases(cuda)
    assert (n_enc, n_pass1) == (len(testdata.encode_edge_cases()),
                                len(testdata.pass1_edge_cases()))


def test_container_round_trip_on_card(cuda):
    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    for spec, data in ((LzwSpec.gif(7), corpus["tokyo"]),
                       (LzwSpec.fixed(Endianness.BIG),
                        corpus["lorem_ipsum"] * 8)):
        codec = BlockParallelCodec(spec, device=cuda)
        assert codec.devices == (cuda,)
        container = codec.encode(data)
        cpu = BlockParallelCodec(spec, device="cpu")
        assert container == cpu.encode(data)
        assert codec.decode(container) == data


@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_container_device_pass2_on_card(name, cuda, monkeypatch):
    from lzw_tpu_torch.native.runtime import NativeRuntime

    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    spec = SPECS[name]
    data = corpus["tokyo"]
    container = BlockParallelCodec(spec, device=cuda).encode(data)

    def host_called(*args, **kwargs):
        raise AssertionError("the device route called the native runtime")

    monkeypatch.setattr(NativeRuntime, "apply_words", host_called)
    monkeypatch.setattr(NativeRuntime, "decode_blocks", host_called)
    codec = BlockParallelCodec(spec, device=cuda, pass2="device")
    before = dict(build.LAUNCHES)
    assert codec.decode(container) == data
    assert build.LAUNCHES["decode_pass2"] == before["decode_pass2"] + 1
    assert build.LAUNCHES["word_ends"] == before["word_ends"] + 1


def _split_devices():
    """Every visible GPU, or cuda:0 twice on a one-GPU machine (two ranges
    at once on one card)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2


@pytest.mark.parametrize("name", ["gif7", "fixed"])
def test_row_split_on_card(name, cuda, monkeypatch):
    from lzw_tpu_torch.native.runtime import NativeRuntime

    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    spec = SPECS[name]
    data = corpus["tokyo"] * 3
    devices = _split_devices()
    one = BlockParallelCodec(spec, device="cuda:0")
    split = BlockParallelCodec(spec, device=devices)
    counts = []
    for codec in (one, split):
        build.reset_counts()
        container = codec.encode(data)
        counts.append(build.LAUNCHES["encode_parse"])
    assert container == one.encode(data)
    assert counts == [1, len(devices)]

    def host_called(*args, **kwargs):
        raise AssertionError("the device route called the native runtime")

    for pass2 in ("host", "auto", "device"):
        codec = BlockParallelCodec(spec, device=devices, pass2=pass2)
        if pass2 == "device":
            monkeypatch.setattr(NativeRuntime, "apply_words", host_called)
        build.reset_counts()
        assert codec.decode(container) == data
        assert build.LAUNCHES["decode_pass1"] == len(devices)
        walks = 0 if pass2 == "host" else len(devices)
        assert build.LAUNCHES["decode_pass2"] == walks
        assert build.LAUNCHES["word_ends"] == walks
    stages = {}
    BlockParallelCodec(spec, device=devices, stage_times=stages).decode(
        container)
    assert {f"dec_pass1@{d}" for d in devices} <= set(stages)


def test_entry_on_card(cuda):
    from lzw_tpu_torch.entry import dryrun_multichip, entry
    from lzw_tpu_torch.native.runtime import get_runtime

    fn, (blocks, lens) = entry()
    assert blocks.device.type == "cuda"
    before = build.LAUNCHES["encode_parse"]
    buf, n_bytes, err = fn(blocks, lens)
    assert build.LAUNCHES["encode_parse"] == before + 1
    assert not err.any()
    buf, n_bytes = buf.cpu().numpy(), n_bytes.cpu().numpy()
    native = get_runtime().encode_blocks(
        blocks.cpu().numpy().tobytes(), LzwSpec.fixed(Endianness.LITTLE),
        4096)
    assert [buf[i, : n_bytes[i]].tobytes() for i in range(4)] == native
    dryrun_multichip(torch.cuda.device_count())


def _parse_input(rng, G, B, L):
    # Half the lanes binary, half random bytes: the lockstep minimum of nxt
    # stays low, so the window variants drop inserts of the random lanes.
    x = rng.integers(0, 256, (G, B, L)).astype(np.int32)
    x[:, :, : L // 2] &= 1
    return x


@pytest.mark.parametrize("variant", list(ablate.PARSE_VARIANTS))
def test_ablate_parse_matches_plain(variant, cuda):
    rng = np.random.default_rng(1)
    for x in (_parse_input(rng, 2, 2048, 96),
              rng.integers(0, 256, (1, 3000, 64)).astype(np.int32) + 4):
        x_t = torch.from_numpy(x).to(cuda)
        before = build.LAUNCHES["ablate_parse"]
        got = ablate.ablate_parse(x_t, variant)
        assert build.LAUNCHES["ablate_parse"] == before + 1
        assert torch.equal(got, ablate.ablate_parse_reference(x_t, variant))


@pytest.mark.parametrize("cell", [256, 512])
@pytest.mark.parametrize("variant", list(ablate.RING_VARIANTS))
def test_ablate_ring_matches_plain(variant, cell, cuda):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (1024, 8, 32)).astype(np.int32)
    x[:, :4] &= 3  # repeated keys in the ring
    x_t = torch.from_numpy(x).to(cuda)
    before = build.LAUNCHES["ablate_ring"]
    got = ablate.ablate_ring(x_t, variant, cell=cell)
    assert build.LAUNCHES["ablate_ring"] == before + 1
    assert torch.equal(got, ablate.ablate_ring_reference(x_t, variant,
                                                         cell=cell))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_probe_scan_matches_plain(dtype, cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-1000, 1000, (1, 40, 16, 32))).to(
        dtype).to(cuda)
    x[0, 0, :4] = 965  # equal to the fill: not below it
    # The script's zero fill gives 0 whatever the sweep computes; at 965 a
    # column is 965 where a step's value exceeds it (about half of them)
    # and 0 elsewhere, so the compare, select and max show.
    for fill in (0, 965):
        before = build.LAUNCHES["probe_scan"]
        got = probe.probe_scan(x, rows=300, fill=fill)
        assert build.LAUNCHES["probe_scan"] == before + 1
        assert got.dtype == dtype
        want = probe.probe_scan_reference(x, rows=300, fill=fill)
        assert torch.equal(got, want)
    assert 0 < int((want == 965).sum()) < want.numel()


def test_probe_gather_matches_plain(cuda):
    rng = np.random.default_rng(4)
    before = build.LAUNCHES["probe_gather"]
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (8, 128))).to(
        torch.int32).to(cuda)
    assert torch.equal(probe.affine(x), probe.affine_reference(x))
    for H in (8, 512, 8192):
        tab = torch.from_numpy(
            rng.integers(-2**31, 2**31, (H, 128))).to(torch.int32).to(cuda)
        idx = torch.from_numpy(rng.integers(0, H, (3, 128))).to(
            torch.int32).to(cuda)
        assert torch.equal(probe.gather_lanes(tab, idx),
                           probe.gather_lanes_reference(tab, idx))
        assert torch.equal(probe.gather_loop(tab, idx, 100),
                           probe.gather_loop_reference(tab, idx, 100))
    assert build.LAUNCHES["probe_gather"] == before + 7
