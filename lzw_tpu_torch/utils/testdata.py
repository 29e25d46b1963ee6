"""Synthesised test vectors: foreign streams built from the port's own
encoder, the edge cases of the one-chain-per-warp kernels, and those of
the single-stream encode and decode kernels.

Port of ``lzw_tpu/utils/testdata.py``, whose scalar oracle lives in the JAX
package: here the codes come from the encode-parse kernel (its plain
version for CPU tensors) and the widths from the static emission schedule,
so the same stream can be made on a machine without JAX.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lzw_tpu_torch.kernels import build, chains
from lzw_tpu_torch.kernels import decode as _dec
from lzw_tpu_torch.kernels import encode as _enc
from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.decode import MAX_BLOCK
from lzw_tpu_torch.kernels.encode import encode_blocks_codes
from lzw_tpu_torch.kernels.schedule import schedule_rows
from lzw_tpu_torch.ops.bitpack import scatter_symbols
from lzw_tpu_torch.spec import LzwSpec, MAX_TABLE_SIZE, UnexpectedCodeError

__all__ = ["spliced_nonstrict_stream", "EncodeCase", "Pass1Case",
           "encode_edge_cases", "pass1_edge_cases", "pass1_epoch_cases",
           "CHAIN_COUNTS",
           "check_edge_cases", "check_pass1_cases", "same_slots",
           "StreamCase", "stream_edge_cases",
           "stream_edge_rows", "check_stream_edge_cases",
           "uninit_literal_stream",
           "StreamEncodeCase", "epoch_misses", "hash_collision",
           "stream_encode_edge_cases", "stream_encode_rows",
           "check_stream_encode_edge_cases"]


def _pack_codes(codes: np.ndarray, widths: np.ndarray, little: bool) -> bytes:
    """Pack (code, width) symbols back to back, zero-filling the last byte
    (``lzw_tpu.ops.reference.pack_codes``)."""
    offs = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
    n_bytes = (int(widths.sum()) + 7) // 8
    out = torch.zeros((1, n_bytes + 3), dtype=torch.int64)
    scatter_symbols(
        out, torch.from_numpy(codes.astype(np.int64))[None],
        torch.from_numpy(widths.astype(np.int64))[None],
        torch.from_numpy(offs)[None], little,
    )
    return out[0, :n_bytes].to(torch.uint8).numpy().tobytes()


def spliced_nonstrict_stream(data: bytes, spec: LzwSpec, piece: int = 2000,
                             device="cpu") -> bytes:
    """A valid variable-flavor stream with EARLY CLEARs every ``piece``
    bytes: the foreign-stream shape the reference decoder takes
    (`decoder.rs:222-227`) and the strict-schedule decode does not.

    Each piece is encoded as its own stream (one batch of blocks on
    ``device``); a CLEAR at the decoder's current read width joins it to the
    previous one, and one EOI at that width ends the whole.  Byte-identical
    to ``lzw_tpu.utils.testdata.spliced_nonstrict_stream``.  A fixture
    maker whose users are the CPU tests: unlike the entry points, its
    ``device`` defaults to the CPU.
    """
    if not spec.variable:
        raise ValueError("spliced_nonstrict_stream takes a variable-width spec")
    if not data:
        raise ValueError("spliced_nonstrict_stream needs at least one byte")
    if not 0 < piece < 3000:
        # Keeps each piece free of its own table-full CLEAR.
        raise ValueError(f"piece {piece} outside 1..2999")
    arr = np.frombuffer(bytes(data), np.uint8)
    n = -(-len(arr) // piece)
    blocks = np.zeros((n, piece), np.uint8)
    blocks.reshape(-1)[: len(arr)] = arr
    lens = np.full(n, piece, np.int32)
    lens[-1] = len(arr) - (n - 1) * piece
    dense, counts, errs, err_codes = encode_blocks_codes(
        torch.from_numpy(blocks).to(device), torch.from_numpy(lens).to(device),
        spec,
    )
    errs = errs.cpu().numpy()
    if errs.any():
        i = int(np.argmax(errs != 0))
        raise UnexpectedCodeError(int(err_codes[i]), spec.code_size)
    dense, counts = dense.cpu().numpy(), counts.cpu().numpy()
    sched = _sched.emission_schedule(spec, int(counts.max()) + 1)
    codes, widths = [], []
    clear_w = spec.initial_width
    for i in range(n):
        k = int(counts[i])
        codes += [spec.clear_code, *dense[i, :k].tolist()]
        widths += [clear_w, *sched.widths[:k].tolist()]
        clear_w = sched.eoi_width(k, True)  # the decoder's width here
    codes.append(spec.end_code)
    widths.append(clear_w)
    return _pack_codes(np.asarray(codes), np.asarray(widths),
                       spec.endianness.value == "little")


# Block counts that fill a CTA partly, exactly and past it, and that need
# more than one round of chains (8 x 132 = 1056 encode chains, 7 x 132 = 924
# pass-1 chains on an H100).
CHAIN_COUNTS = (1, 6, 7, 8, 9, 925, 1057)


class EncodeCase(NamedTuple):
    """Inputs of ``encode_blocks_codes``: u8[N, B] blocks, i32[N] lengths;
    ``spec`` None is fixed-12."""

    label: str
    spec: LzwSpec | None
    blocks: np.ndarray
    lens: np.ndarray


class Pass1Case(NamedTuple):
    """Inputs of ``decode_pass1``: i32[N, S] codes, i32[N] code counts,
    the block size and, for a variable spec, the i32[2, S] schedule rows."""

    label: str
    spec: LzwSpec | None
    codes: np.ndarray
    n_codes: np.ndarray
    block_size: int
    sched: np.ndarray | None


def _mixed_blocks(rng, hi: int, n: int, size: int) -> np.ndarray:
    """Even rows random in [0, hi), odd rows repeats of a short phrase."""
    mat = rng.integers(0, hi, size=(n, size)).astype(np.uint8)
    phrase = rng.integers(0, hi, size=37).astype(np.uint8)
    mat[1::2] = np.resize(phrase, (len(mat[1::2]), size))
    return mat


def encode_edge_cases(seed: int = 0, full: bool = True) -> list[EncodeCase]:
    """The encode-parse kernel's edge cases: blocks of length 0, 1, 2 and B
    in one launch (the warps of a CTA finish at different times); every
    block count of :data:`CHAIN_COUNTS`; random 64 KiB blocks (full tables
    and long probe runs, gif7 resets, the fixed-12 freeze at 4096); gif2 at
    64 KiB (many resets); runs of one byte; out-of-range bytes, one of them
    deep in a block.  ``full=False`` shrinks 64 KiB to 2 KiB and keeps the
    counts below 10, for the plain version on a CPU."""
    rng = np.random.default_rng(seed)
    gif7, gif2 = LzwSpec.gif(7), LzwSpec.gif(2)
    big = 1 << 16 if full else 1 << 11
    cases = []
    B = 4096
    lens = np.array([0, 1, 2, B, B, 0, 2, 1, B], np.int32)
    cases.append(EncodeCase("lengths 0/1/2/B", gif7,
                            _mixed_blocks(rng, 128, len(lens), B), lens))
    for n in CHAIN_COUNTS if full else [c for c in CHAIN_COUNTS if c < 10]:
        for spec, hi in ((gif7, 128), (None, 256)):
            mat = _mixed_blocks(rng, hi, n, 512)
            cases.append(EncodeCase(
                f"N={n} {'fixed' if spec is None else 'gif7'}", spec, mat,
                rng.integers(400, 513, size=n).astype(np.int32)))
    # The plain version's time follows the block width, not the rows, so
    # the long rows of one flavor share a case.
    runs = np.array([[5], [0], [127]], np.uint8) * np.ones(big, np.uint8)
    for label, spec, hi, run_rows in (("gif7", gif7, 128, runs),
                                      ("fixed-12", None, 256, runs[:1] + 195),
                                      ("gif2", gif2, 4, runs[:0])):
        rand = rng.integers(0, hi, size=(2, big)).astype(np.uint8)
        lens = np.full(2 + len(run_rows), big, np.int32)
        lens[1] = big - 5
        cases.append(EncodeCase(
            f"random {label} {big} B" + (", runs of one byte"
                                         if len(run_rows) else ""),
            spec, np.concatenate([rand, run_rows]), lens))
    bad = np.zeros((5, B), np.uint8)
    lens = np.zeros(5, np.int32)
    for i, row in enumerate(([0, 1, 8, 3], [200], [200, 1, 2, 250, 1],
                             list(rng.integers(0, 4, size=B)))):
        bad[i, : len(row)] = row
        lens[i] = len(row)
    bad[4] = rng.integers(0, 4, size=B)
    bad[4, 3000] = 9  # deep in the block, after a reset
    lens[4] = B
    cases.append(EncodeCase("out-of-range bytes gif2", gif2, bad, lens))
    return cases


def _valid_codes(rng, spec: LzwSpec | None, S: int, kwkwk: float):
    """A strict stream of S codes, each valid for the decoder: an epoch's
    first code a root, later ones a root, a defined entry or (with
    probability ``kwkwk``) the next index.  Returns (codes, sched)."""
    if spec is None:
        alphabet = first_free = 256
        sched = None
    else:
        alphabet, first_free = spec.alphabet_size, spec.first_free_code
        sched = schedule_rows(spec, S)
    codes = np.zeros(S, np.int32)
    nxt = first_free
    for t in range(S):
        if sched is not None:
            nxt = int(sched[0, t])
        first = t == (0 if sched is None else int(sched[1, t]))
        if first:
            c = int(rng.integers(0, alphabet))
        elif rng.random() < kwkwk:
            c = nxt
        else:
            # A root or a code in [first_free, nxt): never a control code.
            c = int(rng.integers(0, alphabet + nxt - first_free))
            c = c if c < alphabet else c - alphabet + first_free
        codes[t] = c
        if sched is None and not first and nxt < MAX_TABLE_SIZE:
            nxt += 1
    return codes, sched


def _stream_block(rng, spec, n: int, S: int, kwkwk: float = 0.1):
    rows, sched = [], None
    for _ in range(n):
        codes, sched = _valid_codes(rng, spec, S, kwkwk)
        rows.append(codes)
    # The schedule rows depend on S alone, so every row shares them.
    return np.stack(rows), sched


def pass1_edge_cases(seed: int = 0, full: bool = True) -> list[Pass1Case]:
    """Pass 1's edge cases, on random strict streams: code counts 0, 1, 2
    and S in one launch; every block count of :data:`CHAIN_COUNTS`; long
    blocks that fill the table (gif7 and gif2 resets, the fixed-12 freeze at
    4096); KwKwK-heavy streams; a code beyond the next index mid-block and
    an output overflow mid-block, each followed by more codes; counts below
    S with codes after them; the error inputs of the decode tests.  Words
    past the stop are not constant (KwKwK codes still carry the frozen
    length and offset), so every case holds codes there.  ``full=False``
    shrinks the long blocks and keeps the counts below 10, for the plain
    version on a CPU."""
    rng = np.random.default_rng(seed)
    gif7, gif2, fixed = LzwSpec.gif(7), LzwSpec.gif(2), None
    long = 12000 if full else 1500
    cases = []
    codes, sched = _stream_block(rng, gif7, 9, 3000)
    n = np.array([0, 1, 2, 3000, 3000, 0, 2, 1, 1500], np.int32)
    cases.append(Pass1Case("counts 0/1/2/S gif7", gif7, codes, n, MAX_BLOCK,
                           sched))
    for count in CHAIN_COUNTS if full else [c for c in CHAIN_COUNTS if c < 10]:
        for spec in (gif7, fixed):
            codes, sched = _stream_block(rng, spec, count, 300)
            n = rng.integers(250, 301, size=count).astype(np.int32)
            cases.append(Pass1Case(
                f"N={count} {'fixed' if spec is None else 'gif7'}", spec,
                codes, n, MAX_BLOCK, sched))
    for label, spec, S in (("gif7", gif7, long), ("gif2", gif2, long),
                           ("fixed-12", fixed, long // 2)):
        codes, sched = _stream_block(rng, spec, 2, S)
        cases.append(Pass1Case(f"full tables {label} S={S}", spec, codes,
                               np.array([S, S - 7], np.int32), MAX_BLOCK,
                               sched))
        # Each KwKwK word is one byte longer than the last: 400 codes stay
        # inside MAX_BLOCK.
        codes, sched = _stream_block(rng, spec, 2, 400, kwkwk=0.9)
        cases.append(Pass1Case(f"KwKwK-heavy {label} S=400", spec, codes,
                               np.full(2, 400, np.int32), MAX_BLOCK, sched))
    for label, spec in (("gif7", gif7), ("fixed-12", fixed)):
        S = 2000
        codes, sched = _stream_block(rng, spec, 3, S, kwkwk=0.3)
        nxt = (sched[0] if sched is not None
               else np.minimum(256 + np.maximum(np.arange(S) - 1, 0), 4096))
        codes[0, 300] = min(int(nxt[300]) + 1 + int(rng.integers(0, 50)),
                            MAX_TABLE_SIZE - 1)
        # Row 0 stops at the corrupt code, row 1 overflows the block
        # mid-stream, row 2 stops at a count below S.
        cases.append(Pass1Case(
            f"corrupt code, overflow, count < S {label}", spec, codes,
            np.array([S, S, S // 2 + 3], np.int32), 5000, sched))
    # The port's decode tests' error inputs: a code far beyond the next
    # index (fixed-12 65, 3000; gif2 1, 7, 2) and 128 bytes into a 64-byte
    # block, whose codes the encoder gives.
    overflow = np.frombuffer(bytes(range(100)) + bytes([3] * 28), np.uint8)
    for label, spec, corrupt, block in (("fixed-12", fixed, [65, 3000], 64),
                                        ("gif2", gif2, [1, 7, 2], 128),
                                        ("gif7", gif7, None, 64)):
        rows = [] if corrupt is None else [np.array(corrupt, np.int32)]
        if spec is not gif2:
            dense, count, _, _ = _enc.encode_blocks_codes(
                torch.from_numpy(overflow[None].copy()),
                torch.tensor([len(overflow)], dtype=torch.int32), spec)
            rows.append(dense[0, : int(count[0])].numpy())
        S = max(map(len, rows))
        codes = np.zeros((len(rows), S), np.int32)
        for i, r in enumerate(rows):
            codes[i, : len(r)] = r
        cases.append(Pass1Case(
            f"error inputs {label}", spec, codes,
            np.array([len(r) for r in rows], np.int32), block,
            None if spec is None else schedule_rows(spec, S)))
    return cases


def _word_lengths(codes: np.ndarray, spec: LzwSpec | None) -> np.ndarray:
    """Each step's word length in a row of valid codes (no code past the
    next index): 1 for an epoch's first code and a root, 0 for a CLEAR or
    EOI code (an entry never inserted), else one more than the word the
    code extends (the previous one for KwKwK, the frozen fixed-12 4096
    included)."""
    alphabet, ff = _dec._table_params(spec)
    S = len(codes)
    start = (np.zeros(S, np.int64) if spec is None
             else schedule_rows(spec, S)[1].astype(np.int64))
    lens = np.zeros(S, np.int64)
    for t in range(S):
        c = int(codes[t])
        if t == start[t] or c < alphabet:
            lens[t] = 1
        elif c >= ff:
            p = t - 1 if c == MAX_TABLE_SIZE else start[t] + c - ff
            lens[t] = lens[p] + 1
    return lens


def _rootsy(rng, codes: np.ndarray, alphabet: int, share: float):
    """``codes`` with about ``share`` of them replaced by roots (still
    valid: a root is valid anywhere), so that words stay short."""
    codes = codes.copy()
    pick = rng.random(codes.shape) < share
    codes[pick] = rng.integers(0, alphabet, size=int(pick.sum()))
    return codes


def _first_over(lens: np.ndarray, block_size: int) -> int:
    """The first step whose word ends past ``block_size`` (len if none)."""
    return int(np.searchsorted(np.cumsum(lens), block_size, side="right"))


def pass1_epoch_cases(seed: int = 0) -> list[Pass1Case]:
    """Pass 1's edge cases at the edges of a block's dictionary epochs,
    which the kernel decodes one after another, each with the whole CTA:
    counts that end on an epoch start; a code past the next index in epoch
    3, mid-epoch and at its step 1; stale non-root first codes after a
    CLEAR, CLEAR and EOI codes mid-epoch and KwKwK after each; outputs that
    pass ``block_size`` at an epoch's first step, mid-epoch only through
    the offsets of the epochs before, and inside an earlier epoch than a
    later one's own sum shows; fixed-12 past the table's freeze, over two
    chunks of the frozen tail, with KwKwK on the frozen next index 4096
    across the chunk edge, a code past it, an overflow in the tail, and
    counts at the freeze."""
    rng = np.random.default_rng(seed)
    gif7 = LzwSpec.gif(7)
    alphabet, ff = gif7.alphabet_size, gif7.first_free_code
    P = _sched.epoch_steps(gif7)
    cases = []

    # 1. Counts, corrupt codes and stale first codes at the epoch edges.
    S = 4 * P + 60
    codes, sched = _stream_block(rng, gif7, 7, S)
    codes = _rootsy(rng, codes, alphabet, 0.7)
    n = np.array([S + 7, P, 2 * P, 3 * P, S, S, S], np.int32)
    codes[4, 3 * P + 100] = ff + 99 + 1 + int(rng.integers(0, 50))
    codes[5, 3 * P + 1] = ff + 1
    for e, c in enumerate((200, gif7.clear_code, gif7.end_code, 4000)):
        codes[6, e * P] = c
        codes[6, e * P + 1] = ff  # KwKwK on the stale first word
    for t in (P + 10, 2 * P + 20, 3 * P + 30):
        codes[6, t] = gif7.clear_code if t < 2 * P else gif7.end_code
        codes[6, t + 1] = ff + t - (t // P) * P  # KwKwK on a 0-byte word
    for row in codes:
        assert _word_lengths(row, gif7).sum() <= MAX_BLOCK
    cases.append(Pass1Case("epoch edges gif7: counts, corrupt, stale",
                           gif7, codes, n, MAX_BLOCK, sched))

    # 2. Overflows that the bases show: B passes block_size at epoch 2's
    # first step, A mid-epoch 2 (its epoch 1 shortened), D inside epoch 1
    # (lengthened by KwKwK), E never.
    S = 2 * P + 300
    b, sched = _stream_block(rng, gif7, 1, S)
    b = b[0]
    block_size = int(_word_lengths(b, gif7)[: 2 * P].sum())
    a, d = b.copy(), b.copy()
    a[2 * P - 100: 2 * P] = rng.integers(0, alphabet, size=100)
    d[2 * P - 100: 2 * P] = ff + np.arange(P - 100, P) - 1
    e, _ = _stream_block(rng, gif7, 1, S)
    e = _rootsy(rng, e[0], alphabet, 0.95)
    codes = np.stack([b, a, d, e])
    over = [_first_over(_word_lengths(r, gif7), block_size) for r in codes]
    assert block_size <= MAX_BLOCK and over[0] == 2 * P
    assert 2 * P < over[1] < S and P < over[2] < 2 * P and over[3] == S
    cases.append(Pass1Case("epoch overflows gif7", gif7, codes,
                           np.full(4, S, np.int32), block_size, sched))

    # 3. Fixed-12 past the freeze: one epoch of 3841 steps, then the tail.
    fixed_steps = MAX_TABLE_SIZE + 1 - 256
    S = fixed_steps + 4096 + 300
    codes, _ = _stream_block(rng, None, 8, S)
    codes = _rootsy(rng, codes, 256, 0.7)
    tail2 = fixed_steps + 4096
    codes[1, tail2 - 6: tail2 + 6] = MAX_TABLE_SIZE  # across the chunk edge
    codes[2, fixed_steps] = MAX_TABLE_SIZE
    codes[3, fixed_steps + 200] = MAX_TABLE_SIZE + 4  # past the next index
    codes[5, tail2 + 10: tail2 + 290] = MAX_TABLE_SIZE
    codes[7, 2000] = 256 + 1999 + 5  # past the next index before the freeze
    # Rows 6 and 7 stop before the freeze: holes over the tail's steps.
    n = np.array([S, S, fixed_steps, S, tail2, S, 3000, S], np.int32)
    lens = [_word_lengths(r, None) for r in codes]
    block_size = 40000
    assert tail2 < _first_over(lens[5], block_size) < S
    assert all(x[:m].sum() <= block_size for x, m in zip(lens[:5], n[:5]))
    cases.append(Pass1Case("epoch edges fixed-12: the frozen tail", None,
                           codes, n, block_size, None))
    return cases


def _same(name: str, label: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name} {label}: {len(got)} outputs, "
                             f"expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} {label}: output {i} differs from "
                                 "the plain version")


def _counted(name: str, fn):
    before = build.LAUNCHES[name]
    out = fn()
    if build.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not count one launch")
    return out


def check_pass1_cases(device, cases: list[Pass1Case]) -> int:
    """Every case through the pass-1 wrapper on ``device`` with every row
    kind, against the plain version, exact; each call must count one
    launch.  Raises AssertionError naming the case and the row kind;
    returns the number of cases."""
    for c in cases:
        args = (torch.from_numpy(c.codes).to(device),
                torch.from_numpy(c.n_codes).to(device), c.spec, c.block_size,
                None if c.sched is None else torch.from_numpy(c.sched).to(
                    device))
        # The words and stats do not depend on the rows asked for.
        want = {rows: _dec.decode_pass1_reference(*args, rows=rows)
                for rows in ("stride1", "stride2")}
        want["none"] = want["stride2"][:4]
        for rows in _dec.ROW_KINDS:
            got = _counted("decode_pass1",
                           lambda: _dec.decode_pass1(*args, rows=rows))
            _same("decode_pass1", f"{c.label} rows={rows}", got, want[rows])
    return len(cases)


def check_edge_cases(device) -> tuple[int, int]:
    """Every case of :func:`encode_edge_cases` and :func:`pass1_edge_cases`
    through the wrappers on ``device`` against the plain versions, exact,
    the encode parse in both instances (without and with positions, against
    one plain run with positions) and pass 1 with every row kind
    (:func:`check_pass1_cases`); each wrapper call must count one launch.
    Raises AssertionError naming the case; returns the numbers of encode
    and pass-1 cases."""
    enc = encode_edge_cases()
    for c in enc:
        blocks = torch.from_numpy(c.blocks).to(device)
        lens = torch.from_numpy(c.lens).to(device)
        want = _enc.encode_blocks_codes_reference(blocks, lens, c.spec,
                                                  positions=True)
        got = _counted("encode_parse", lambda: _enc.encode_blocks_codes(
            blocks, lens, c.spec))
        _same("encode_parse", c.label, got, want[:4])
        got = _counted("encode_parse", lambda: _enc.encode_blocks_codes(
            blocks, lens, c.spec, positions=True))
        _same("encode_parse positions", c.label, got, want)
    return len(enc), check_pass1_cases(device, pass1_edge_cases())


def same_slots(label: str, got: dict, want: dict) -> None:
    """Two results of ``ops.encode.encode_block`` on the same rows (the
    card's and the CPU's): every array equal, which holds the contract's
    tolerance (widths and the errors exactly, codes where a width is not
    0) and more.  Raises AssertionError naming the first that differs."""
    for key in ("codes", "widths", "error", "error_code", "error_pos"):
        if not torch.equal(got[key].cpu(), want[key].cpu()):
            raise AssertionError(f"encode_block {label}: {key} differs")


# ---- the single-stream decoder (lzw_tpu_torch.ops.decode) ----------------


class StreamCase(NamedTuple):
    """One row of the single-stream decoder: the stream's bytes, of which
    the first ``n_valid`` are valid (the rest are the stream's own later
    bytes)."""

    label: str
    stream: bytes
    n_valid: int


def _decoder_widths(codes, spec: LzwSpec) -> list[int]:
    """The width pass 1 reads each code of ``codes`` at: its state machine
    (CLEAR resets, one insert a step after an epoch's first, the width
    bump after an insert), up to the code that ends the stream."""
    ff = spec.first_free_code
    width, nxt, first = spec.initial_width, ff, True
    out = []
    for c in codes:
        out.append(width if spec.variable else 12)
        if spec.variable and c == spec.clear_code:
            width, nxt, first = spec.initial_width, ff, True
            continue
        if spec.variable and c == spec.end_code:
            break
        if first:
            first = False
            continue
        if c > nxt or (spec.variable and nxt >= MAX_TABLE_SIZE):
            break  # a bad code or a full table: the stream ends here
        if nxt < MAX_TABLE_SIZE:
            nxt += 1
            if (spec.variable and nxt == (1 << width) - spec.strategy.increment
                    and width < 12):
                width += 1
    return out


def _stream_of(symbols, spec: LzwSpec) -> tuple[bytes, np.ndarray]:
    """Pack ``symbols`` (a code, or (code, width) to force a width) at the
    decoder's widths; returns (bytes, i64 bit offset of each symbol and of
    the end)."""
    codes = [s[0] if isinstance(s, tuple) else int(s) for s in symbols]
    widths = _decoder_widths(codes, spec)
    widths += [12] * (len(codes) - len(widths))
    for i, s in enumerate(symbols):
        if isinstance(s, tuple):
            widths[i] = s[1]
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    return _pack_codes(np.asarray(codes), np.asarray(widths),
                       spec.endianness.value == "little"), offs


def _epoch_codes(rng, spec: LzwSpec, n: int, start: int = 0,
                 kwkwk: float = 0.1) -> list[int]:
    """Steps ``start`` .. ``start + n - 1`` of an epoch, each valid: step 0
    a root, later ones a root, an entry of the epoch or (with probability
    ``kwkwk``) the next index; never a control code."""
    alphabet, ff = spec.alphabet_size, spec.first_free_code
    out = []
    for k in range(start, start + n):
        nxt = min(ff + k - 1, MAX_TABLE_SIZE)
        if k == 0:
            c = int(rng.integers(0, alphabet))
        elif rng.random() < kwkwk and nxt < MAX_TABLE_SIZE:
            c = nxt
        else:
            c = int(rng.integers(0, alphabet + max(nxt - ff, 0)))
            c = c if c < alphabet else c - alphabet + ff
        out.append(c)
    return out


def _variable_cases(rng, spec: LzwSpec) -> list[StreamCase]:
    C, EOI, ff = spec.clear_code, spec.end_code, spec.first_free_code
    w0, inc = spec.initial_width, spec.strategy.increment
    top = (1 << w0) - 1  # the largest code an epoch's first step can hold
    full = MAX_TABLE_SIZE + 1 - ff  # the steps of a full epoch
    bump = (1 << w0) - inc - ff  # the step whose insert bumps the width
    cases = []

    def add(label, symbols, n_valid=None):
        stream, _ = _stream_of(symbols, spec)
        cases.append(StreamCase(label, stream,
                                len(stream) if n_valid is None else n_valid))

    add("CLEAR, CLEAR", [C, C, *_epoch_codes(rng, spec, 30), EOI])
    add("no leading CLEAR", [*_epoch_codes(rng, spec, 25), EOI])
    # The first code of the stream names a local code never inserted.
    add("first code reads UNINIT", [C, top, ff, *_epoch_codes(
        rng, spec, 20, start=2), EOI])
    # A first code after a CLEAR names an entry of the previous epoch.
    add("first code reads a stale entry", [
        C, *_epoch_codes(rng, spec, 40), C, min(ff + 5, top), ff,
        *_epoch_codes(rng, spec, 20, start=2), EOI])
    add("KwKwK at step 1", [C, 1, ff, ff + 1, *_epoch_codes(
        rng, spec, 10, start=3), EOI])
    add("bad code at step 1", [C, 1, ff + 1, 0, 1, EOI])
    # The first code read at the bumped width is past the next index.
    add("bad code at a width bump", [
        C, *_epoch_codes(rng, spec, bump + 1), (1 << (w0 + 1)) - 1, 2, EOI])
    stream, offs = _stream_of([C, *_epoch_codes(rng, spec, 200), EOI], spec)
    inside = next(j for j in range(5, len(offs) - 2)
                  if offs[j] % 8 and offs[j] // 8 * 8 + 8 < offs[j + 1])
    boundary = next(j for j in range(5, len(offs) - 2) if offs[j] % 8 == 0)
    cases.append(StreamCase("truncated inside a code", stream,
                            int(offs[inside] // 8 + 1)))
    cases.append(StreamCase("truncated on a code boundary", stream,
                            int(offs[boundary] // 8)))
    add("missing CLEAR at a full table", [C, *[1] * (full + 1), 2, EOI])
    # The last data code's insert bumps the width: the EOI at the bumped
    # width, and at the old one (the reference encoder's EOI width quirk).
    data = _epoch_codes(rng, spec, bump + 1)
    add("EOI at a width bump", [C, *data, EOI])
    add("EOI at a width bump, old width", [C, *data, (EOI, w0)])
    add("full epochs", [C, *_epoch_codes(rng, spec, full), C,
                        *_epoch_codes(rng, spec, full, kwkwk=0.3), C,
                        *_epoch_codes(rng, spec, 700), EOI])
    add("empty", [C, 1, 2, EOI], n_valid=0)
    return cases


def _fixed_cases(rng, spec: LzwSpec) -> list[StreamCase]:
    full = MAX_TABLE_SIZE + 1 - spec.first_free_code  # steps to the freeze
    cases = []

    def add(label, symbols, n_valid=None):
        stream, _ = _stream_of(symbols, spec)
        cases.append(StreamCase(label, stream,
                                len(stream) if n_valid is None else n_valid))

    frozen = [int(c) for c in rng.integers(0, MAX_TABLE_SIZE, 3000)]
    add("long past the freeze", [*_epoch_codes(rng, spec, full), *frozen])
    add("first code reads UNINIT", [300, 256, *_epoch_codes(
        rng, spec, 20, start=2)])
    add("KwKwK at step 1", [1, 256, 257, *_epoch_codes(rng, spec, 10,
                                                       start=3)])
    add("bad code at step 1", [1, 257, 0, 1])
    add("bad code at the last insert", [*_epoch_codes(rng, spec, full - 2),
                                        MAX_TABLE_SIZE - 1, 5])
    stream, offs = _stream_of(_epoch_codes(rng, spec, 201), spec)
    cases.append(StreamCase("truncated inside a code", stream,
                            int(offs[100] // 8 + 1)))
    cases.append(StreamCase("truncated on a code boundary", stream,
                            int(offs[100] // 8)))
    add("empty", [1, 2, 3], n_valid=0)
    return cases


def stream_edge_cases(spec: LzwSpec, seed: int = 0) -> list[StreamCase]:
    """The single-stream decoder's edge cases for one flavor: CLEAR, CLEAR;
    no leading CLEAR; a first code that reads UNINIT and one that reads a
    stale entry of the previous epoch; KwKwK at step 1; a code past the
    next index at step 1 and at a width bump; truncation inside a code and
    on a code boundary; a full table without a CLEAR; EOI at a width bump,
    at the bumped and at the old width; full epochs; an empty row.
    Fixed-12 (no control codes) has a stream long past the freeze at 4096,
    a first code that reads UNINIT, KwKwK at step 1, a code past the next
    index at step 1 and at the last insert, both truncations and an empty
    row.  Each stream is a few codes, or a few epochs at most."""
    rng = np.random.default_rng(seed)
    return (_variable_cases if spec.variable else _fixed_cases)(rng, spec)


def stream_edge_rows(spec: LzwSpec, seed: int = 0):
    """:func:`stream_edge_cases` as one launch: u8[N, M] rows of very
    different lengths and i32[N] valid lengths, random bytes past each
    stream.  Returns (labels, rows, n_valid)."""
    cases = stream_edge_cases(spec, seed)
    rng = np.random.default_rng(seed + 1)
    M = max(len(c.stream) for c in cases) + 16
    mat = rng.integers(0, 256, (len(cases), M)).astype(np.uint8)
    for i, c in enumerate(cases):
        mat[i, : len(c.stream)] = np.frombuffer(c.stream, np.uint8)
    return ([c.label for c in cases], mat,
            np.array([c.n_valid for c in cases], np.int32))


def uninit_literal_stream(spec: LzwSpec, n_out: int,
                          root: int = 1) -> tuple[bytes, int]:
    """A variable-flavor stream whose words decode to ``n_out`` bytes, then
    a CLEAR and a first code naming an entry that no epoch inserted, then
    EOI: (the stream, that code).

    Each epoch is ``root`` and words of it that grow by one byte a step
    (step k reads entry first_free + k - 2 + its length, KwKwK at full
    length), at most ``run`` inserts, so no entry from first_free + run on
    is ever inserted; the last code is the largest the initial width
    holds, and every code is read at that width.  The reference decodes it
    to ``n_out`` bytes of ``root`` and one stale byte; bounded at ``n_out``
    bytes, that one-byte literal passes the bound and the reference raises
    UnexpectedCodeError with the code.  The single-stream pass 1 maps the
    code to its UNINIT entry, whose ``glocal`` is 0."""
    if not spec.variable:
        raise ValueError("a fixed-12 stream has no CLEAR")
    ff, width = spec.first_free_code, spec.initial_width
    top = (1 << width) - 1
    run = min(100, top - spec.strategy.increment - ff)
    if run < 1 or not 0 <= root < spec.alphabet_size:
        raise ValueError(f"{spec}: no room for an uninserted code")
    symbols = []
    left = n_out
    while left:
        symbols += [spec.clear_code, root]
        left -= 1
        k = 1
        while left and k <= run:
            length = min(k + 1, left)
            symbols.append(root if length == 1 else ff + length - 2)
            left -= length
            k += 1
    symbols += [spec.clear_code, top, spec.end_code]
    return _stream_of(symbols, spec)[0], top


def check_stream_edge_cases(device, specs) -> int:
    """:func:`stream_edge_rows` of each spec through ``decode_pass1`` and
    ``decode_pass2`` on ``device`` against their plain versions, every
    output array exact, pass 2 at the longest decoded row and at 100 bytes
    (dropped writes); each wrapper call must count one launch.  Raises
    AssertionError naming the flavor and array; returns the rows
    compared."""
    from lzw_tpu_torch.ops import decode as sdec

    n = 0
    for spec in specs:
        _, mat, lens = stream_edge_rows(spec)
        rows = torch.from_numpy(mat)
        lens_t = torch.from_numpy(lens)
        got = _counted("stream_pass1", lambda: sdec.decode_pass1(
            rows.to(device), lens_t.to(device), spec))
        want = sdec.decode_pass1_reference(rows, lens_t, spec)
        for key, w in want.items():
            if not torch.equal(got[key].cpu(), w):
                raise AssertionError(f"stream_pass1 {spec}: {key} differs "
                                     "from the plain version")
        for bound in (max(int(want["total_len"].max()), 1), 100):
            args = [bound, spec.alphabet_size]
            g2 = _counted("stream_pass2", lambda: sdec.decode_pass2(
                *(got[k] for k in sdec.PASS2_KEYS), *args))
            w2 = sdec.decode_pass2_reference(
                *(want[k] for k in sdec.PASS2_KEYS), *args)
            _same("stream_pass2", f"{spec} out_bound {bound}",
                  [g.cpu() for g in g2], w2)
        n += len(lens)
    return n


# ---- the single-stream encoder (kernels.encode.encode_stream_codes) ------


class StreamEncodeCase(NamedTuple):
    """One stream of the single-stream encoder."""

    label: str
    data: bytes


def _every_pair(r: int) -> bytes:
    """Each ordered pair of the symbols 0..r-1 exactly once, r*r + 1 bytes
    (the de Bruijn sequence B(r, 2), made linear)."""
    seq, a = [], [0, 0, 0]

    def db(t, p):
        if t > 2:
            if 2 % p == 0:
                seq.extend(a[1: p + 1])
            return
        a[t] = a[t - p]
        db(t + 1, p)
        for j in range(a[t - p] + 1, r):
            a[t] = j
            db(t + 1, t)

    db(1, 1)
    return bytes(seq + seq[:1])


def _code_bytes(data: bytes, spec: LzwSpec) -> np.ndarray:
    """The byte of each code the encoder emits for ``data``: each miss's,
    then the row's length for the final prefix."""
    row = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
    out = _enc.encode_blocks_codes_reference(
        row, torch.tensor([len(data)], dtype=torch.int32), spec,
        positions=True)
    return out[4][0, : int(out[1][0])].numpy()


def epoch_misses(spec: LzwSpec) -> int:
    """The misses of a variable flavor's full epoch: codes first_free up
    to the reset threshold, whose miss trips the reset."""
    first_free, _, reset = _enc._spec_params(spec)
    return reset - first_free + 1


def _triangle(n: int) -> int:
    return n * (n + 1) // 2


@functools.lru_cache(maxsize=None)
def hash_collision() -> tuple[bytes, bytes]:
    """Two different strings over the bytes 0..3, of one length, with the
    same content hash in the stream encode kernel's phrase walk
    (``kernels.encode.content_hash``), found by meeting in the middle over
    the per-byte differences of the two strings' hash terms."""
    M = 1 << 32
    pairs = {}
    for x in range(4):
        for y in range(4):
            pairs.setdefault((_enc.MIXED[x] - _enc.MIXED[y]) % M, (x, y))
    diffs = np.array(sorted(pairs), np.uint64)  # 0 first
    n = len(diffs)

    def sums(weights):
        acc = np.zeros(1, np.uint64)
        for w in weights:
            acc = ((acc[:, None] + diffs[None, :] * np.uint64(w))
                   % np.uint64(M)).ravel()
        return acc

    for length in range(9, 16):
        w = [pow(_enc.HASH_BASE, length - 1 - i, M) for i in range(length)]
        half = length // 2
        left, right = sums(w[:half]), sums(w[half:])
        order = np.argsort(left, kind="stable")
        ordered = left[order]
        need = (np.uint64(M) - right) % np.uint64(M)
        lo = np.searchsorted(ordered, need, "left")
        hi = np.searchsorted(ordered, need, "right")
        for r in np.nonzero(hi > lo)[0]:
            for j in order[lo[r]:hi[r]]:
                if j == 0 and r == 0:
                    continue  # every difference 0: one string twice
                digits = (np.unravel_index(int(j), (n,) * half)
                          + np.unravel_index(int(r), (n,) * (length - half)))
                a, b = zip(*(pairs[int(diffs[d])] for d in digits))
                a, b = bytes(a), bytes(b)
                assert a != b and _enc.content_hash(a) == _enc.content_hash(b)
                return a, b
    raise AssertionError("no collision of the content hash found")


def _collision_row(spec: LzwSpec) -> bytes:
    """The two strings of :func:`hash_collision`, each after one prefix and
    before one byte (their content hashes stay equal, and so do their last
    bytes), the first repeated, then the second, then the first again,
    until a lookup of a string of more than ``LANES + 1`` bytes has met an
    entry of the other (the kernel's table mirrored): that lookup is a
    round of all lanes, a slot a load, whose exact test probes past a
    candidate of another string.  Both strings then share a bucket, so a
    lane whose string is one byte longer finds two candidates for its
    parent."""
    a, b = hash_collision()
    lead, tail = bytes([3, 1, 2, 0, 3, 3, 0, 1]) * 3, bytes([2])
    for n in (64, 128, 256, 512):
        data = (lead + a + tail) * n + (lead + b + tail) * n \
            + (lead + a + tail) * n
        row = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
        walk = _enc.stream_table_reference(
            row, torch.tensor([len(data)], dtype=torch.int32), spec)[4]
        if int(walk[0, 2]) > _enc.LANES + 1:
            return data
    raise AssertionError("no long lookup met a candidate")


def _alias_row(spec: LzwSpec, rng) -> bytes:
    """A first byte v past the alphabet, and later the string that code v
    names + byte 1: the key (v, byte 1) that the first step inserted is hit
    as that code's child (it emits first_free, which nothing else reaches).
    """
    first_free, max_code, reset = _enc._spec_params(spec)
    v = first_free + 2
    for _ in range(200):
        head = [v] + rng.integers(0, max_code + 1, 12).tolist()
        strings, nxt, prefix = {}, first_free, head[0]
        child = {}
        for k in head[1:]:
            if (prefix, k) in child:
                prefix = child[prefix, k]
                continue
            child[prefix, k] = nxt
            strings[nxt] = strings.get(prefix, [prefix]) + [k]
            nxt += 1
            prefix = k
        if v not in strings:
            continue
        data = bytes(head + (strings[v] + [head[1]]) * 4 + [head[2]])
        codes = _code_list(data, spec)
        if first_free in codes[1:]:
            return data
    raise AssertionError("no stream hits the first byte's key")


def _code_list(data: bytes, spec: LzwSpec) -> list[int]:
    row = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
    out = _enc.encode_blocks_codes_reference(
        row, torch.tensor([len(data)], dtype=torch.int32), spec)
    return out[0][0, : int(out[1][0])].tolist()


def stream_encode_edge_cases(spec: LzwSpec,
                             seed: int = 0) -> list[StreamEncodeCase]:
    """The single-stream encoder's edge rows for one flavor: an empty and
    a 1-byte stream; one byte repeated (phrases of 1, 2, 3, ... bytes, each
    ``KwK`` insert read back at once); ``a a a`` (a root pair inserted and
    hit on the very next step); every pair of roots once (every step
    misses, and each miss's next key is a root pair).  The kernel's phrase
    walk tests 32 extensions of a phrase at once, so there are phrases of
    exactly 32, 33, 34, 64 and 65 bytes (one byte repeated, then another),
    a phrase of a hundred bytes across a chunk of its ring, and two strings
    of one length with the same content hash, one learnt before the other
    (a probe must pass the first and never match it).  Variable flavors
    also have a stream whose last byte is the miss that trips the reset,
    one a byte past it, several full epochs, and the same strings in two
    epochs in a row (a stale entry would be found after the reset);
    fixed-12 a stream long past the freeze at 4096.  Code sizes below 8
    also have a byte past the alphabet at index 1, at index 0 (never
    checked) and inside a long run of hits, as the 33rd and the 34th byte
    of a phrase, and a first byte past the alphabet whose code a later
    string takes and whose key is then hit."""
    rng = np.random.default_rng(seed)
    R = spec.alphabet_size if spec.variable else 256
    a = int(rng.integers(0, R))
    other = (a + 1 + int(rng.integers(0, R - 1))) % R
    chunk = chains.STREAM_ENCODE_CHUNK
    cases = [StreamEncodeCase("empty", b""),
             StreamEncodeCase("one byte", bytes([a])),
             StreamEncodeCase("one byte repeated", bytes([a]) * 3000),
             StreamEncodeCase("a a a", bytes([a]) * 3),
             StreamEncodeCase("every pair once", _every_pair(R))]
    cases += [StreamEncodeCase(f"a phrase of {n} bytes",
                               bytes([a]) * _triangle(n) + bytes([other, a]))
              for n in (32, 33, 34, 64, 65)]
    cases += [StreamEncodeCase("a long phrase across a chunk",
                               bytes([a]) * (2 * chunk + 500)),
              StreamEncodeCase("two strings with one content hash",
                               _collision_row(spec))]
    if spec.variable:
        P = epoch_misses(spec)
        data = rng.integers(0, R, 12 * P * spec.initial_width).astype(
            np.uint8).tobytes()
        at = _code_bytes(data, spec)
        trip = int(at[P - 1])  # the byte whose miss trips the first reset
        epoch = data[: trip + 1]
        cases += [
            StreamEncodeCase("reset on the last byte", epoch),
            StreamEncodeCase("one byte past a reset", data[: trip + 2]),
            StreamEncodeCase("several full epochs",
                             data[: int(at[3 * P - 1]) + 101]),
            StreamEncodeCase("the same strings in two epochs", epoch * 2),
        ]
    else:
        cases.append(StreamEncodeCase(
            "long past the freeze",
            rng.integers(0, 256, 24000).astype(np.uint8).tobytes()))
    if spec.max_code_value < 255:
        bad = int(rng.integers(R, 256))
        valid = rng.integers(0, R, 300).astype(np.uint8).tobytes()
        cases += [
            StreamEncodeCase("bad byte at index 1", bytes([a, bad]) + valid),
            StreamEncodeCase("bad byte at index 0", bytes([bad]) + valid),
            StreamEncodeCase("bad byte in a run of hits",
                             bytes([a]) * 600 + bytes([bad]) + valid),
            StreamEncodeCase("bad byte as a phrase's 33rd",
                             bytes([a]) * (_triangle(31) + 32) + bytes([bad])
                             + valid),
            StreamEncodeCase("bad byte as a phrase's 34th",
                             bytes([a]) * (_triangle(32) + 33) + bytes([bad])
                             + valid),
            StreamEncodeCase("the first byte's key hit", _alias_row(spec, rng)),
        ]
    return cases


def stream_encode_rows(spec: LzwSpec, seed: int = 0):
    """:func:`stream_encode_edge_cases` as one launch: u8[N, M] rows of
    very different lengths, random bytes past each stream (which the
    kernel reads ahead of the chain).  Returns (labels, rows, lens)."""
    cases = stream_encode_edge_cases(spec, seed)
    rng = np.random.default_rng(seed + 1)
    M = max(len(c.data) for c in cases) + 16
    mat = rng.integers(0, 256, (len(cases), M)).astype(np.uint8)
    for i, c in enumerate(cases):
        mat[i, : len(c.data)] = np.frombuffer(c.data, np.uint8)
    return ([c.label for c in cases], mat,
            np.array([len(c.data) for c in cases], np.int32))


def check_stream_encode_edge_cases(device, specs) -> int:
    """:func:`stream_encode_rows` of each spec through
    ``encode_stream_codes`` on ``device`` against the plain version, every
    output array exact; its steps are its phrases (the codes, and one for
    an error), and a round walks ``LANES`` of them at most, so the rounds
    are at least the steps over ``LANES`` (but the last prefix, which the
    row's end cuts off before any lookup); each wrapper call must count one
    launch.  Raises AssertionError naming the flavor; returns the rows
    compared."""
    n = 0
    for spec in specs:
        _, mat, lens = stream_encode_rows(spec)
        rows, lens_t = torch.from_numpy(mat), torch.from_numpy(lens)
        *got, walk = _counted("stream_encode", lambda: _enc.encode_stream_codes(
            rows.to(device), lens_t.to(device), spec, stats=True))
        want = _enc.encode_blocks_codes_reference(rows, lens_t, spec)
        _same("stream_encode", str(spec), [g.cpu() for g in got], want)
        steps, rounds = walk.cpu().T
        _same("stream_encode steps", str(spec), [steps], [want[1] + want[2]])
        if not bool((_enc.LANES * rounds + 1 >= steps).all()):
            raise AssertionError(f"stream_encode rounds ({spec}): {rounds} "
                                 f"for steps {steps}")
        n += len(lens)
    return n
