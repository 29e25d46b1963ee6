"""LZW encode parse: the CUDA kernels and their plain version.

Port of ``lzw_tpu/kernels/encode_pallas.py``.  The TPU package has several
parse kernels (K1 chunked, K2 single-launch, and the legacy K6-K8) that all
produce the same dense codes; on Hopper one kernel,
``csrc/encode_parse.cu``, serves every flavor and block size: one block's
parse per warp, its dictionary in shared memory (:mod:`.chains`).  The
single-stream encode (the counterpart of ``lzw_tpu/ops/encode.py``'s scan
at one row) has a kernel of its own, ``csrc/stream_encode.cu``
(:func:`encode_stream_codes`): one row a CTA, one warp on its chain,
several phrases a step; :func:`stream_table_reference` mirrors its
table.

TPU containments with no counterpart here: the ``SUPER_GROUP_MAX`` batch
slicing and the two-dispatch encode/pack split (XLA miscompile workarounds),
``eq16`` and the VMEM group/cell/segment tiles, the between-launch table
recompaction and ``_compact_grouped_codes`` (the kernel writes dense codes
through a per-block cursor).
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels import build, chains
from lzw_tpu_torch.ops.bitpack import join_lanes, split_lanes
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, LzwSpec

__all__ = ["encode_blocks_codes", "encode_blocks_codes_reference",
           "encode_stream_codes", "stream_table_reference", "content_hash",
           "home_slot", "encode_blocks_fixed", "pack12"]


def _spec_params(spec: LzwSpec | None) -> tuple[int, int, int]:
    """(first_free, max_code, reset_threshold) of a spec; ``None`` or a
    fixed spec gives the fixed-12 parameters with reset_threshold -1
    (encode_pallas.py:1348-1352)."""
    if spec is None or not spec.variable:
        return 256, 255, -1
    spec.validate()
    return (spec.first_free_code, spec.max_code_value,
            MAX_TABLE_SIZE - spec.strategy.increment)


def _check_inputs(blocks: torch.Tensor, lens: torch.Tensor):
    build.require_tensor(blocks, "blocks", torch.uint8, 2, blocks.device)
    build.require_tensor(lens, "lens", torch.int32, 1, blocks.device)
    if lens.shape[0] != blocks.shape[0]:
        raise ValueError(
            f"lens has {lens.shape[0]} rows, blocks {blocks.shape[0]}"
        )


def encode_blocks_codes(blocks: torch.Tensor, lens: torch.Tensor,
                        spec: LzwSpec | None, positions: bool = False):
    """LZW-parse each row of ``blocks`` into its dense code sequence.

    Args:
      blocks: u8[N, B] block bytes (contents past ``lens`` ignored).
      lens:   i32[N] valid byte counts (<= B).
      spec:   the wire spec (``None`` or a fixed spec: fixed-12 parse).
      positions: also return each code's byte.
    Returns:
      (dense i32[N, B+1] zero past counts, counts i32[N], err i32[N],
      err_code i32[N]); err 1 flags a byte > max_code after the first.
      With ``positions`` a fifth array, pos i32[N, B+1] zero past counts:
      the byte index whose lookup missed and emitted each code, and the
      row's length for the final prefix.

    CPU tensors run :func:`encode_blocks_codes_reference`; CUDA tensors run
    the kernel, and anything else raises.
    """
    _check_inputs(blocks, lens)
    if blocks.device.type == "cpu":
        return encode_blocks_codes_reference(blocks, lens, spec, positions)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    first_free, max_code, reset = _spec_params(spec)
    N, B = blocks.shape
    dev = blocks.device
    fn = build.bound("encode_parse", "encode_parse_launch")
    with build.on_device(dev):
        g = chains.launch_geometry("encode_parse", N, dev)
        dense = torch.zeros((N, B + 1), dtype=torch.int32, device=dev)
        counts = torch.empty(N, dtype=torch.int32, device=dev)
        err = torch.empty(N, dtype=torch.int32, device=dev)
        err_code = torch.empty(N, dtype=torch.int32, device=dev)
        # A null pointer launches the instance that writes no positions.
        pos = (torch.zeros((N, B + 1), dtype=torch.int32, device=dev)
               if positions else None)
        rc = fn(blocks.data_ptr(), lens.data_ptr(), N, B, first_free,
                max_code, reset, dense.data_ptr(), counts.data_ptr(),
                err.data_ptr(), err_code.data_ptr(),
                None if pos is None else pos.data_ptr(), g.grid, g.warps,
                g.shared_bytes, build.stream(dev))
    build.check_launch("encode_parse", rc)
    if positions:
        return dense, counts, err, err_code, pos
    return dense, counts, err, err_code


def encode_stream_codes(blocks: torch.Tensor, lens: torch.Tensor,
                        spec: LzwSpec | None, stats: bool = False):
    """:func:`encode_blocks_codes` (without positions) through the
    single-stream kernel ``csrc/stream_encode.cu``: one CTA a row, one
    warp on its chain, several phrases a step, for a few long rows (the
    facades' one stream) where the container's kernel would run one warp
    of a card that holds 1056.  With ``stats`` a fifth array, i32[N, 2]:
    each row's steps (its phrases: the codes, and one for an error) and
    rounds (the chain warp's table loads).

    CPU tensors run :func:`encode_blocks_codes_reference`, whose ``stats``
    are its phrases and no rounds (it has no chain warp); CUDA tensors run
    the kernel, and anything else raises.  A failed build or launch raises
    (:func:`lzw_tpu_torch.kernels.build.check_launch`); nothing falls back
    to ``encode_parse.cu`` or to the plain version.  The kernel reads each
    row from a 16-byte boundary in 16-byte pieces, so rows whose start or
    width is not a multiple of 16 are copied into a padded matrix first.
    """
    _check_inputs(blocks, lens)
    if blocks.device.type == "cpu":
        out = encode_blocks_codes_reference(blocks, lens, spec)
        if stats:
            walk = torch.stack([out[1] + out[2], torch.zeros_like(out[1])],
                               1)
            return (*out, walk)
        return out
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    first_free, _, reset = _spec_params(spec)
    # The roots: 2^code_size (max_code + 1) at a variable flavor, 256 at
    # fixed-12.
    root_bits = spec.code_size if reset >= 0 else 8
    N, B = blocks.shape
    dev = blocks.device
    fn = build.bound("stream_encode", "stream_encode_launch")
    with build.on_device(dev):
        stride = -(-B // 16) * 16
        if stride != B or blocks.data_ptr() % 16:
            padded = torch.empty((N, stride), dtype=torch.uint8, device=dev)
            padded[:, :B] = blocks
            blocks = padded
        dense = torch.zeros((N, B + 1), dtype=torch.int32, device=dev)
        counts = torch.empty(N, dtype=torch.int32, device=dev)
        err = torch.empty(N, dtype=torch.int32, device=dev)
        err_code = torch.empty(N, dtype=torch.int32, device=dev)
        walk = (torch.empty((N, 2), dtype=torch.int32, device=dev)
                if stats else None)
        threads, shared = chains.STREAM_ENCODE
        rc = fn(blocks.data_ptr(), stride, lens.data_ptr(), N, B, root_bits,
                first_free, reset, dense.data_ptr(),
                counts.data_ptr(), err.data_ptr(), err_code.data_ptr(),
                None if walk is None else walk.data_ptr(), N,
                threads, shared, build.stream(dev))
    build.check_launch("stream_encode", rc)
    if stats:
        return dense, counts, err, err_code, walk
    return dense, counts, err, err_code


def _parse_row(data: bytes, first_free: int, max_code: int, reset: int):
    """One row's parse, step by step as ``_stage_step_fn``: (codes, the
    byte of each code, err, err_code)."""
    variable = reset >= 0
    codes, at = [], []
    child = {}
    nxt = first_free
    prefix = data[0]
    for i in range(1, len(data)):
        k = data[i]
        key = (prefix << 8) | k
        code = child.get(key)
        if code is not None:
            prefix = code
            continue
        # A byte past the alphabet is never in the table.
        if variable and k > max_code:
            return codes, at, 1, k
        codes.append(prefix)
        at.append(i)
        if variable and nxt == reset:
            # The entry that trips the reset is wiped with the rest.
            child.clear()
            nxt = first_free
        elif variable or nxt < MAX_TABLE_SIZE:
            child[key] = nxt
            nxt += 1
        prefix = k
    codes.append(prefix)
    at.append(len(data))
    return codes, at, 0, 0


# The table of csrc/stream_encode.cu, whose constants these are
# (kHashBase, kSlotBits, kBucketBits, kTags, kLanes; the byte mix is its
# `mixed`):
# a string's content hash is the polynomial sum of mixed(byte) *
# HASH_BASE^(distance from its end) mod 2^32, with mixed(b) murmur3's
# 32-bit finaliser of b + 1; its home bucket (two slots) is its top
# BUCKET_BITS bits, and its entry keeps its low 20 bits as check bits.
HASH_BASE = 0x5BD1E995
SLOT_BITS = 14
BUCKET_BITS = SLOT_BITS - 1
TAGS = 16
# The chain warp's lanes (kLanes): a step tests LANES extensions of a
# phrase, or takes up to LANES phrases of 1 byte; a phrase of more than
# LANES + 1 bytes goes on in rounds of all lanes, a slot a load.
LANES = 32
_M32 = 0xFFFFFFFF


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ h >> 16


MIXED = tuple(_fmix32(b + 1) for b in range(256))


def content_hash(data: bytes, h: int = 0) -> int:
    """The stream encode kernel's content hash of ``data``, continued from
    the hash ``h`` of the bytes before it."""
    for b in data:
        h = (h * HASH_BASE + MIXED[b]) & _M32
    return h


def home_slot(h: int) -> int:
    """The slot where the probe for content hash ``h`` starts: the first
    of its home bucket."""
    return h >> (32 - BUCKET_BITS) << 1


def _table_row(data: bytes, first_free: int, max_code: int, reset: int):
    """One row's parse with the kernel's table beside it: (codes, err,
    err_code, collisions, candidates, longest).

    Each lookup of a string probes from its home slot, a slot at a time,
    to the string or an empty slot; each miss inserts the string at that
    empty slot, as the kernel does whatever its step; a reset empties the
    table (the kernel's tag).  ``collisions`` counts the entries of
    another string with the very same content hash that a probe met,
    ``candidates`` those of them with the same last byte too (the check
    bits and the byte pass: only the parent tells them apart), and
    ``longest`` is the longest string, in bytes, at whose lookup a
    candidate was met (0: none)."""
    variable = reset >= 0
    size = 1 << SLOT_BITS
    keys, full = [None] * size, [0] * size
    # The content hash of each code's string; the first byte's alias is a
    # raw byte until its code is inserted.
    hashes, lengths = {}, {}
    child = {}
    collisions = candidates = longest = 0

    def probe(key, h, n):
        nonlocal collisions, candidates, longest
        s = home_slot(h)
        while keys[s] is not None and keys[s] != key:
            if full[s] == h:
                collisions += 1
                if keys[s][1] == key[1]:
                    candidates += 1
                    longest = max(longest, n)
            s = (s + 1) & (size - 1)
        return s

    def insert(key, h, n):
        s = probe(key, h, n)
        keys[s], full[s] = key, h

    def string(code):
        if code in hashes:
            return hashes[code], lengths[code]
        return MIXED[code & 0xFF], 1

    codes = []
    nxt = first_free
    prefix = data[0]
    alias = prefix if prefix >= first_free and len(data) > 1 else -1
    for i in range(1, len(data)):
        k = data[i]
        hp, n = string(prefix)
        h = (hp * HASH_BASE + MIXED[k]) & _M32
        code = child.get((prefix, k))
        probe((prefix, k), h, n + 1)
        if code is not None:
            prefix = code
            continue
        if variable and k > max_code:
            return codes, 1, k, collisions, candidates, longest
        codes.append(prefix)
        if variable and nxt == reset:
            child.clear()
            hashes.clear()
            lengths.clear()
            keys, full = [None] * size, [0] * size
            nxt, alias = first_free, -1
        elif variable or nxt < MAX_TABLE_SIZE:
            child[prefix, k] = nxt
            insert((prefix, k), h, n + 1)
            hashes[nxt], lengths[nxt] = h, n + 1
            if nxt == alias:
                # The first step's key (the first byte, byte 1) under the
                # content of the string that now takes its code.
                insert((nxt, data[1]), (h * HASH_BASE + MIXED[data[1]])
                       & _M32, n + 2)
                alias = -1
            nxt += 1
        prefix = k
    codes.append(prefix)
    return codes, 0, 0, collisions, candidates, longest


def stream_table_reference(blocks: torch.Tensor, lens: torch.Tensor,
                           spec: LzwSpec | None):
    """The stream encode kernel's table, mirrored on the host row by row
    (:func:`_table_row`): (dense, counts, err, err_code) as
    :func:`encode_blocks_codes_reference` gives them, and i32[N, 3] the
    collisions, candidates and longest candidate string of each row.  Its
    time follows the bytes, so it takes rows of kilobytes, not
    megabytes."""
    first_free, max_code, reset = _spec_params(spec)
    N, B = blocks.shape
    rows, n_valid = blocks.cpu().numpy(), lens.cpu().numpy()
    dense = np.zeros((N, B + 1), np.int32)
    counts, err, err_code = (np.zeros(N, np.int32) for _ in range(3))
    stats = np.zeros((N, 3), np.int32)
    for n in range(N):
        if n_valid[n] <= 0:
            continue
        codes, err[n], err_code[n], *stats[n] = _table_row(
            rows[n, : n_valid[n]].tobytes(), first_free, max_code, reset)
        counts[n] = len(codes)
        dense[n, : len(codes)] = codes
    return tuple(torch.from_numpy(a).to(blocks.device)
                 for a in (dense, counts, err, err_code, stats))


def encode_blocks_codes_reference(blocks: torch.Tensor, lens: torch.Tensor,
                                  spec: LzwSpec | None,
                                  positions: bool = False):
    """Plain version of :func:`encode_blocks_codes` and of
    :func:`encode_stream_codes`.

    Each row's parse is a loop over its bytes on the host with a dict for
    its dictionary, mirroring ``_stage_step_fn``
    (encode_pallas.py:329-487) step by step; the outputs come back on the
    rows' device.  Its time follows the bytes, not the longest row, so it
    also holds one 16 MiB stream.
    """
    first_free, max_code, reset = _spec_params(spec)
    N, B = blocks.shape
    dev = blocks.device
    rows = blocks.cpu().numpy()
    n_valid = lens.cpu().numpy()
    dense = np.zeros((N, B + 1), np.int32)
    pos = np.zeros((N, B + 1), np.int32)
    counts = np.zeros(N, np.int32)
    err = np.zeros(N, np.int32)
    err_code = np.zeros(N, np.int32)
    for n in range(N):
        if n_valid[n] <= 0:
            continue
        codes, at, err[n], err_code[n] = _parse_row(
            rows[n, : n_valid[n]].tobytes(), first_free, max_code, reset)
        counts[n] = len(codes)
        dense[n, : len(codes)] = codes
        pos[n, : len(at)] = at
    out = tuple(torch.from_numpy(a).to(dev)
                for a in (dense, counts, err, err_code))
    return out + (torch.from_numpy(pos).to(dev),) if positions else out


def pack12(dense: torch.Tensor, counts: torch.Tensor, little: bool):
    """Static 12-bit pair packing: codes i32[N, S] -> bytes u8[N, 3*ceil(S/2)]
    and byte lengths (encode_pallas.py:923-939)."""
    N, S = dense.shape
    if S % 2:
        dense = torch.cat(
            [dense, torch.zeros((N, 1), dtype=dense.dtype,
                                device=dense.device)], dim=1)
    c = dense.to(torch.int32).reshape(N, -1, 2)
    lanes = split_lanes(join_lanes((c[..., 0], c[..., 1]), little, bits=12),
                        little)
    by = torch.stack(lanes, dim=-1).reshape(N, -1)
    lengths = (12 * counts.to(torch.int32) + 7) >> 3
    return by.to(torch.uint8), lengths


def encode_blocks_fixed(blocks: torch.Tensor, lens: torch.Tensor,
                        little: bool = True):
    """Fixed-12 block encode: (payloads u8[N, PB] zero-padded, lengths
    i32[N]), the contract of ``encode_pallas.encode_blocks_fixed_tpu``."""
    dense, counts, _, _ = encode_blocks_codes(blocks, lens, None)
    return pack12(dense, counts, little)
