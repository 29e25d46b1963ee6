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

from lzw_tpu_torch import (
    BlockParallelCodec, CodeSizeStrategy, Endianness, LzwSpec,
)
from lzw_tpu_torch.kernels import ablate, build, probe
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.ops import bitpack as tbitpack
from lzw_tpu_torch.ops import encode as tencode
from lzw_tpu_torch.scripts import ablate2
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
    # together; the encode parse with and without positions, pass 1 with
    # every row kind.
    n_enc, n_pass1 = testdata.check_edge_cases(cuda)
    assert (n_enc, n_pass1) == (len(testdata.encode_edge_cases()),
                                len(testdata.pass1_edge_cases()))


def test_pass1_epoch_edges_on_card(cuda):
    # Pass 1's edges of a block's epochs (counts on an epoch start, a code
    # past the next index in epoch 3, stale first codes after a CLEAR,
    # overflows that only the offsets of earlier epochs show, fixed-12's
    # frozen tail) with every row kind, against the plain version.
    cases = testdata.pass1_epoch_cases()
    assert testdata.check_pass1_cases(cuda, cases) == len(cases)


# One image plane a call, as the container cells cut it: 11 x 64 KiB gif7
# blocks of up to 8 epochs, 86 TIFF strips and 171 fixed-12 blocks.
ONE_IMAGE = {"gif7": (LzwSpec.gif(7), 1 << 16, 11),
             "tiff": (LzwSpec.tiff(), 8192, 86),
             "fixed": (LzwSpec.fixed(Endianness.LITTLE), 4096, 171)}


def _plane():
    return load_corpus(
        pathlib.Path(__file__).parent.parent / "test-assets")["tokyo"]


@pytest.mark.parametrize("name", list(ONE_IMAGE))
def test_pass1_on_one_image(name, cuda):
    """The plane's blocks as the container's decode meets them, through
    pass 1 with every row kind against the plain version."""
    spec, block, n = ONE_IMAGE[name]
    plane = np.frombuffer(_plane(), np.uint8)
    mat = np.zeros((n, block), np.uint8)
    mat.reshape(-1)[: len(plane)] = plane
    lens = np.full(n, block, np.int32)
    lens[-1] = len(plane) - (n - 1) * block
    assert 0 < lens[-1] <= block
    dense, counts, errs, _ = tenc.encode_blocks_codes(
        torch.from_numpy(mat).to(cuda), torch.from_numpy(lens).to(cuda), spec)
    assert not errs.any()
    codes, cnt_t, sched_t = _decode_inputs(spec, dense, counts, cuda)
    if name == "gif7":
        assert codes.shape[1] > 4 * tsched.epoch_steps(spec)
    case = testdata.Pass1Case(
        f"{name} one image", spec, codes.cpu().numpy(), cnt_t.cpu().numpy(),
        block, None if sched_t is None else sched_t.cpu().numpy())
    assert testdata.check_pass1_cases(cuda, [case]) == 1


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("name", list(ONE_IMAGE))
def test_one_image_round_trip_on_card(name, route, cuda):
    """The plane through ``BlockParallelCodec`` on both decode routes, and
    a block that decodes past its size still raises the plain route's
    code."""
    from lzw_tpu_torch import UnexpectedCodeError
    from lzw_tpu_torch.parallel import framing

    spec, block, n = ONE_IMAGE[name]
    data = _plane()
    container = BlockParallelCodec(spec, block, device=cuda).encode(data)
    codec = BlockParallelCodec(spec, block, device=cuda, pass2=route)
    assert codec.decode(container) == data
    # Block 3 holds block 4's payload too: it decodes past its size.
    _, payloads = framing.parse_frame(container)
    payloads = [bytes(p) for p in payloads]
    longer = BlockParallelCodec(spec, 2 * block, device=cuda).encode(
        data[3 * block: 5 * block])
    payloads[3] = bytes(framing.parse_frame(longer)[1][0])
    frame = framing.pack_frame(spec, block, len(data), payloads)
    with pytest.raises(UnexpectedCodeError) as plain:
        BlockParallelCodec(spec, block, device="cpu", pass2="device").decode(
            frame)
    with pytest.raises(UnexpectedCodeError) as got:
        codec.decode(frame)
    assert got.value.code == plain.value.code


@pytest.mark.parametrize("name", list(SPECS))
def test_encode_block_on_card(name, cuda):
    """The encode-parse kernel's positions instance against its plain
    version on 64 x 8 KiB rows (its edge cases are
    test_chain_edge_cases_match_plain's), and encode_block and
    pack_codes_torch on the card against the CPU, fix_eoi both ways."""
    spec = SPECS[name]
    mat, lens = _blocks(spec, 64, 8192, seed=3)
    blocks, lens_t = torch.from_numpy(mat), torch.from_numpy(lens)
    got = tenc.encode_blocks_codes(blocks.to(cuda), lens_t.to(cuda), spec,
                                   positions=True)
    want = tenc.encode_blocks_codes_reference(blocks, lens_t, spec,
                                              positions=True)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    out_bytes = tencode.packed_bound(8192, spec)
    for fix in (False, True):
        on_card = tencode.encode_block(blocks.to(cuda), lens_t.to(cuda), spec,
                                       fix_eoi_width=fix)
        on_cpu = tencode.encode_block(blocks, lens_t, spec,
                                      fix_eoi_width=fix)
        testdata.same_slots(f"{name} fix={fix}", on_card, on_cpu)
        b_card, n_card = tbitpack.pack_codes_torch(
            on_card["codes"], on_card["widths"], spec.endianness, out_bytes)
        b_cpu, n_cpu = tbitpack.pack_codes_torch(
            on_cpu["codes"], on_cpu["widths"], spec.endianness, out_bytes)
        assert torch.equal(b_card.cpu(), b_cpu)
        assert torch.equal(n_card.cpu(), n_cpu)


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


def test_first_byte_past_the_alphabet_on_card(cuda):
    """Every block's first byte past the alphabet: the card's payloads are
    the native single-stream encode of each block (the first code masked
    to its slot) and the CPU plain route's; ``verify=True`` raises."""
    from lzw_tpu_torch import VerificationError
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing

    spec, block = LzwSpec.gif(2), 4096
    rng = np.random.default_rng(13)
    mat = rng.integers(0, 4, size=(16, block)).astype(np.uint8)
    mat[:, 0] = rng.integers(4, 256, size=16)
    data = mat.tobytes()
    container = BlockParallelCodec(spec, block, device=cuda,
                                   verify=False).encode(data)
    rt = get_runtime()
    assert [bytes(p) for p in framing.parse_frame(container)[1]] == [
        rt.encode(row.tobytes(), spec, fix_eoi=True) for row in mat]
    assert container == BlockParallelCodec(spec, block, device="cpu",
                                           verify=False).encode(data)
    with pytest.raises(VerificationError):
        BlockParallelCodec(spec, block, device=cuda, verify=True).encode(data)


@pytest.mark.parametrize("kind", ["strict", "foreign", "big", "uninit"])
def test_block_past_block_size_on_card(kind, cuda):
    """A block holding a stream longer than the block raises the plain
    route's UnexpectedCodeError code on every ``pass2`` route: a strict
    stream (pass 1 names the code), a foreign early-CLEAR one (the native
    ``decode_blocks`` on "auto" and "host", then the non-strict device
    route) and one past ``MAX_BLOCK`` (``decode_blocks``, then the
    single-stream decoder), also when the word that passes it is a first
    code after a CLEAR naming an entry never inserted (the wire code)."""
    from lzw_tpu_torch import UnexpectedCodeError
    from lzw_tpu_torch.kernels.decode import MAX_BLOCK
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing
    from lzw_tpu_torch.utils.testdata import (
        spliced_nonstrict_stream, uninit_literal_stream,
    )

    spec = LzwSpec.gif(7)
    block = 2 * MAX_BLOCK if kind in ("big", "uninit") else 8192
    n = 3 if kind in ("big", "uninit") else 8
    mat, _ = _blocks(spec, n + 1, block, seed=17)
    data = mat[:n].tobytes()
    payloads = [bytes(p) for p in framing.parse_frame(BlockParallelCodec(
        spec, block, device=cuda).encode(data))[1]]
    longer = mat[n].tobytes() + mat[0, :700].tobytes()
    wire = None
    if kind == "foreign":
        payloads[1] = spliced_nonstrict_stream(longer, spec, 1000,
                                               device=cuda)
    elif kind == "uninit":
        payloads[1], wire = uninit_literal_stream(spec, block)
    else:
        payloads[1] = get_runtime().encode(longer, spec, fix_eoi=True)
    frame = framing.pack_frame(spec, block, len(data), payloads)
    with pytest.raises(UnexpectedCodeError) as plain:
        BlockParallelCodec(spec, block, device="cpu", pass2="device").decode(
            frame)
    assert wire is None or plain.value.code == wire
    for route in ("auto", "host", "device"):
        with pytest.raises(UnexpectedCodeError) as info:
            BlockParallelCodec(spec, block, device=cuda, pass2=route).decode(
                frame)
        assert info.value.code == plain.value.code, route


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


@pytest.mark.parametrize("case", list(ablate2.ring_cases(1024, 8, 3)))
@pytest.mark.parametrize("variant", list(ablate.RING_VARIANTS))
def test_ablate_ring_matches_plain(variant, case, cuda):
    # chip_smoke.py phase 8's inputs at 256 lanes (100 for "odd lanes"):
    # repeated keys in the ring, cells of 256, 512 and 1024, rings of 4,
    # 512 and the largest, keys that wrap negative.
    x, cell, ring = ablate2.ring_cases(4096, 256, 100, seed=2)[case]
    x_t = torch.from_numpy(x).to(cuda)
    before = build.LAUNCHES["ablate_ring"]
    got = ablate.ablate_ring(x_t, variant, cell=cell, ring=ring)
    assert build.LAUNCHES["ablate_ring"] == before + 1
    assert torch.equal(got, ablate.ablate_ring_reference(
        x_t, variant, cell=cell, ring=ring))


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


# ---- the single-stream decoder and the "torch" facades --------------------

STREAM_SPECS = {**SPECS, "fixed_be": LzwSpec.fixed(Endianness.BIG),
                "var4_be_tiff": LzwSpec.variable(4, Endianness.BIG,
                                                 CodeSizeStrategy.TIFF)}
CORRUPT_TIFF = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60,
                      0x54])


def _stream_rows(spec, seed):
    """Rows of streams: empty, short, random, compressible, a truncated and
    a corrupt one, with garbage past each row's valid bytes."""
    from lzw_tpu_torch.ops import reference as oracle

    rng = np.random.default_rng(seed)
    hi = spec.alphabet_size if spec.variable else 256
    datas = [b"", bytes([1]),
             rng.integers(0, hi, 300).astype(np.uint8).tobytes(),
             rng.integers(0, hi, 30000).astype(np.uint8).tobytes(),
             np.resize(rng.integers(0, hi, 40).astype(np.uint8),
                       20000).tobytes()]
    streams = [oracle.encode_bytes(d, spec) for d in datas]
    streams.append(streams[3][: len(streams[3]) // 2])
    streams.append(CORRUPT_TIFF)
    M = max(len(s) for s in streams) + 7
    mat = rng.integers(0, 256, (len(streams), M)).astype(np.uint8)
    for i, s in enumerate(streams):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    return (torch.from_numpy(mat),
            torch.tensor([len(s) for s in streams], dtype=torch.int32))


@pytest.mark.parametrize("name", list(STREAM_SPECS))
def test_stream_kernels_match_plain(name, cuda):
    from lzw_tpu_torch.ops import decode as sdec

    spec = STREAM_SPECS[name]
    data, n_valid = _stream_rows(spec, len(name))
    before = dict(build.LAUNCHES)
    got = sdec.decode_pass1(data.to(cuda), n_valid.to(cuda), spec)
    torch.cuda.synchronize()
    assert build.LAUNCHES["stream_pass1"] == before["stream_pass1"] + 1
    want = sdec.decode_pass1(data, n_valid, spec)
    for key, w in want.items():
        assert torch.equal(got[key].cpu(), w), key
    keys = ("gprefix", "gsuffix", "glocal", "out_g", "out_len", "out_off",
            "out_lit")
    for out_bound in (max(int(want["total_len"].max()), 1), 100):
        g2 = sdec.decode_pass2(*(got[k] for k in keys), out_bound,
                               spec.alphabet_size)
        w2 = sdec.decode_pass2(*(want[k] for k in keys), out_bound,
                               spec.alphabet_size)
        for g, w in zip(g2, w2):
            assert torch.equal(g.cpu(), w)
    assert build.LAUNCHES["stream_pass2"] == before["stream_pass2"] + 2


def test_stream_edge_cases_match_plain(cuda):
    # testdata.stream_edge_cases of every flavor, one launch each: the
    # redesigned kernels against the plain versions, every array exact.
    n = testdata.check_stream_edge_cases(cuda, STREAM_SPECS.values())
    assert n == sum(len(testdata.stream_edge_cases(spec))
                    for spec in STREAM_SPECS.values())


def test_stream_encode_edge_cases_match_plain(cuda):
    # testdata.stream_encode_edge_cases of the five facade flavors, one
    # launch each: stream_encode.cu against the plain version, exact.
    specs = [STREAM_SPECS[k] for k in ("gif2", "gif7", "tiff", "fixed",
                                       "fixed_be")]
    n = testdata.check_stream_encode_edge_cases(cuda, specs)
    assert n == sum(len(testdata.stream_encode_edge_cases(spec))
                    for spec in specs)


@pytest.mark.parametrize("name", list(STREAM_SPECS))
def test_stream_encode_matches_plain(name, cuda):
    # Random and compressible rows of one launch, one of them at an odd
    # width (the wrapper pads it), against the plain version and against
    # the container's kernel on the same rows.
    spec = STREAM_SPECS[name]
    blocks, lens = map(torch.from_numpy, _blocks(spec, 6, 20001, len(name)))
    before = build.LAUNCHES["stream_encode"]
    got = tenc.encode_stream_codes(blocks.to(cuda), lens.to(cuda), spec)
    torch.cuda.synchronize()
    assert build.LAUNCHES["stream_encode"] == before + 1
    want = tenc.encode_blocks_codes_reference(blocks, lens, spec)
    same = tenc.encode_blocks_codes(blocks.to(cuda), lens.to(cuda), spec)
    for g, w, s in zip(got, want, same):
        assert torch.equal(g.cpu(), w) and torch.equal(s.cpu(), w)


def test_torch_facades_equal_native_on_card(cuda):
    from lzw_tpu_torch import (
        FixedCodec, GifCodec, LzwCodec, TiffCodec, TruncatedStreamError,
        UnexpectedCodeError,
    )

    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    for spec in STREAM_SPECS.values():
        data = corpus["tokyo"][:200_000]
        if spec.variable:
            data = bytes(b % spec.alphabet_size for b in data)
        on_card = LzwCodec(spec, backend="torch", device=cuda)
        native = LzwCodec(spec, backend="native")
        enc = on_card.encode(data)
        assert enc == native.encode(data)
        assert on_card.decode(enc) == data
        if spec.variable:
            with pytest.raises(TruncatedStreamError):
                on_card.decode(enc[: len(enc) // 2])
    for make in (lambda: GifCodec(7, backend="torch"),
                 lambda: FixedCodec(Endianness.BIG, backend="torch")):
        assert make().device == torch.device("cuda")
    with pytest.raises(UnexpectedCodeError) as ei:
        TiffCodec(backend="torch").decode(CORRUPT_TIFF)
    assert ei.value.code == 258


def test_big_block_container_on_card(cuda, monkeypatch):
    from lzw_tpu_torch.native.runtime import NativeRuntime, get_runtime
    from lzw_tpu_torch.parallel import framing

    spec = LzwSpec.gif(7)
    corpus = load_corpus(pathlib.Path(__file__).parent.parent / "test-assets")
    data = (corpus["tokyo"] * 4)[: 2 * (1 << 20) + 777]
    data = bytes(b % 128 for b in data)
    container = BlockParallelCodec(spec, block_size=1 << 20,
                                   device=cuda).encode(data)
    native = get_runtime().decode_blocks(
        framing.parse_frame(container)[1], spec, 1 << 20)

    def host_called(*args, **kwargs):
        raise AssertionError("the big-block route called the native runtime")

    monkeypatch.setattr(NativeRuntime, "decode_blocks", host_called)
    before = dict(build.LAUNCHES)
    codec = BlockParallelCodec(spec, block_size=1 << 20, device=cuda,
                               pass2="device")
    assert codec.decode(container) == native == data
    assert build.LAUNCHES["stream_pass1"] == before["stream_pass1"] + 1
    assert build.LAUNCHES["stream_pass2"] == before["stream_pass2"] + 1
