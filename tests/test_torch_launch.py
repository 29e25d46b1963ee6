"""The launch geometry of the one-chain-per-warp encode kernel and the
checks of the kernels' wrappers, on the CPU.

``encode_parse.cu`` runs one block's chain per warp with the block's
dictionary in shared memory; the grid comes from
``lzw_tpu_torch.kernels.chains`` in plain Python, which these tests hold
for every block count of the card-only edge cases.  They also hold those
edge cases, the encoder's and pass 1's, to what they claim, through the
plain versions.
"""

import numpy as np
import pytest
import torch

from lzw_tpu_torch.kernels import build, chains
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.utils import testdata

H100_SMS = 132
COUNTS = (0, *testdata.CHAIN_COUNTS, 2048, 8192)


def _chains_of(g: chains.Geometry, n_blocks: int) -> list[list[int]]:
    """The blocks each warp takes at the encoder's static stride,
    ``for n = blockIdx.x * warps + warp; n < N; n += gridDim.x * warps``."""
    return [list(range(b * g.warps + w, n_blocks, g.grid * g.warps))
            for b in range(g.grid) for w in range(g.warps)]


@pytest.mark.parametrize("n_blocks", COUNTS)
@pytest.mark.parametrize("name", list(chains.LAYOUTS))
def test_geometry_covers_every_block_once(name, n_blocks):
    layout = chains.LAYOUTS[name]
    g = chains.geometry(layout, n_blocks, H100_SMS, 1)
    assert g.warps == layout.warps
    assert g.shared_bytes == layout.warps * layout.chain_bytes
    assert g.shared_bytes <= chains.MAX_SHARED_BYTES == 232448
    assert g.grid <= H100_SMS
    taken = _chains_of(g, n_blocks)
    flat = sorted(n for blocks in taken for n in blocks)
    assert flat == list(range(n_blocks))
    assert g.chains == g.grid * g.warps >= min(n_blocks, H100_SMS * g.warps)
    assert max(map(len, taken), default=0) == g.rounds
    # No CTA without a block.
    assert g.grid == 0 or (g.grid - 1) * g.warps < n_blocks


@pytest.mark.parametrize("name, warps, chains_, rounds_main, rounds_fixed", [
    ("encode_parse", 8, 1056, 2, 8),
])
def test_geometry_on_an_h100(name, warps, chains_, rounds_main, rounds_fixed):
    # The main path's 2048 x 64 KiB blocks and the fixed-12 8192 x 4 KiB.
    layout = chains.LAYOUTS[name]
    assert layout.warps == warps
    main = chains.geometry(layout, 2048, H100_SMS, 1)
    assert (main.chains, main.rounds) == (chains_, rounds_main)
    assert chains.geometry(layout, 8192, H100_SMS, 1).rounds == rounds_fixed


def test_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError):  # 8 x 32 KiB > 227 KB
        chains.geometry(chains.Layout(8, 32768), 10, H100_SMS, 1)
    with pytest.raises(ValueError):
        chains.geometry(chains.Layout(0, 1024), 10, H100_SMS, 1)
    with pytest.raises(ValueError):  # no CTA fits an SM
        chains.geometry(chains.LAYOUTS["encode_parse"], 10, H100_SMS, 0)


def test_refused_launch_raises_and_is_not_counted():
    before = build.LAUNCHES["encode_parse"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        build.check_launch("encode_parse", 1)  # cudaErrorInvalidValue
    assert build.LAUNCHES["encode_parse"] == before


def test_encode_wrapper_refuses_dtype_rank_device():
    blocks = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tenc.encode_blocks_codes(blocks.to(torch.int32), lens, None)
    with pytest.raises(ValueError):
        tenc.encode_blocks_codes(blocks[None], lens, None)
    with pytest.raises(ValueError):
        tenc.encode_blocks_codes(blocks, lens[None], None)
    with pytest.raises(ValueError):  # lens on another device
        tenc.encode_blocks_codes(blocks, lens.to("meta"), None)
    with pytest.raises(ValueError, match="unsupported device"):
        tenc.encode_blocks_codes(blocks.to("meta"), lens.to("meta"), None)


def test_pass1_wrapper_refuses_dtype_rank_device():
    codes = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tdec.decode_pass1(codes.to(torch.int16), n, None, 64)
    with pytest.raises(ValueError):
        tdec.decode_pass1(codes[None], n, None, 64)
    with pytest.raises(ValueError):
        tdec.decode_pass1(codes, n.to("meta"), None, 64)
    with pytest.raises(ValueError):
        tdec.decode_pass1(codes, n, None, 64, rows="stride3")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_pass1(codes.to("meta"), n.to("meta"), None, 64)


def _encode(case):
    return [t.numpy() for t in tenc.encode_blocks_codes(
        torch.from_numpy(case.blocks), torch.from_numpy(case.lens),
        case.spec)]


ENCODE_CLAIMS = {
    "lengths 0/1/2/B": lambda c, out: out[1][[0, 5, 1, 7]].tolist()
    == [0, 0, 1, 1] and (c.lens[[3, 4, 8]] == 4096).all(),
    # Fixed-12 past the freeze: more codes than the table holds.
    "random fixed-12": lambda c, out: out[1][0] > 4096 - 256,
    # gif2 resets every ~4090 codes: more codes than one epoch.
    "random gif2": lambda c, out: out[1][0] > 4096,
    "out-of-range bytes": lambda c, out: out[2].tolist() == [1, 0, 1, 0, 1]
    and out[3].tolist() == [8, 0, 250, 0, 9],
}


@pytest.mark.parametrize("claim", list(ENCODE_CLAIMS))
def test_encode_edge_cases_show_their_edge(claim):
    (c,) = [c for c in testdata.encode_edge_cases()
            if c.label.startswith(claim)]
    if claim.startswith("random"):
        # The first 20,000 bytes of one row show the edge; the plain
        # version on a CPU takes seconds for them.
        c = c._replace(blocks=c.blocks[:1, :20000],
                       lens=np.array([20000], np.int32))
    assert ENCODE_CLAIMS[claim](c, _encode(c))


def test_encode_edge_cases_cover_every_count():
    full = testdata.encode_edge_cases(full=True)
    counts = {c.blocks.shape[0] for c in full if c.label.startswith("N=")}
    assert counts == set(testdata.CHAIN_COUNTS)
    for c in full:
        assert c.blocks.dtype == np.uint8 and c.lens.dtype == np.int32
        assert (c.lens <= c.blocks.shape[1]).all()
    big = [c for c in full if c.label.startswith("random")]
    assert all(c.blocks.shape[1] == 1 << 16 for c in big)


def _pass1(case, rows="stride2"):
    return [t.numpy() for t in tdec.decode_pass1(
        torch.from_numpy(case.codes), torch.from_numpy(case.n_codes),
        case.spec, case.block_size,
        None if case.sched is None else torch.from_numpy(case.sched),
        rows=rows)]


def _next_index(c):
    """The decoder's next index at each step of case ``c``."""
    if c.sched is not None:
        return c.sched[0]
    t = np.arange(c.codes.shape[1])
    return np.minimum(256 + np.maximum(t - 1, 0), 4096)


def test_pass1_edge_cases_show_their_edge():
    cases = {c.label: c for c in testdata.pass1_edge_cases(full=False)}
    counts = {c.codes.shape[0] for c in testdata.pass1_edge_cases()
              if c.label.startswith("N=")}
    assert counts == set(testdata.CHAIN_COUNTS)
    for label, c in cases.items():
        words, totals, err, err_code, pair = _pass1(c)
        if label.startswith("corrupt"):
            # err 1 at the corrupt code, err 2 mid-stream, a clean stop.
            assert err.tolist() == [1, 2, 0], label
            assert totals[1] <= c.block_size, label
        elif label.startswith("error inputs"):
            want = {"fixed-12": [1, 2], "gif2": [1], "gif7": [2]}
            assert err.tolist() == want[label.split()[-1]], label
        else:
            assert not err.any(), label
        # Past the stop every word is a hole, and the holes differ: KwKwK
        # and root codes there carry lengths.
        stop = np.arange(c.codes.shape[1])[None, :] >= c.n_codes[:, None]
        assert ((words >> 29) == tdec.KIND_HOLE)[stop].all(), label
        if label.startswith(("counts", "corrupt")):
            assert len(set(words[stop].tolist())) > 1, label
        if label.startswith("KwKwK"):
            kwkwk = (c.codes == _next_index(c)[None, :]).mean(axis=1)
            assert (kwkwk > 0.8).all(), label


@pytest.mark.parametrize("rows", tdec.ROW_KINDS)
def test_pass1_edge_cases_agree_across_row_kinds(rows):
    # The words and stats do not depend on the rows asked for.
    c = next(c for c in testdata.pass1_edge_cases(full=False)
             if c.label.startswith("corrupt") and c.spec is not None)
    want = _pass1(c, "stride2")[:4]
    got = _pass1(c, rows)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g, w)
    assert len(got) == (4 if rows == "none" else 5)


def test_pass1_fixed_edge_case_freezes():
    (c,) = [c for c in testdata.pass1_edge_cases()
            if c.label.startswith("full tables fixed-12")]
    c = c._replace(codes=c.codes[:1], n_codes=c.n_codes[:1])
    _, _, err, _, pair = _pass1(c, "stride1")
    assert not err.any()
    # Row t names the entry created at step t; none past code 4095.
    created = (pair[0].astype(np.int64) & 0xFFFFFFFF) >> 20
    assert created.max() == 4095
    assert (pair[0, 3841:] == 0).all() and (pair[0, 1:3841] != 0).all()
