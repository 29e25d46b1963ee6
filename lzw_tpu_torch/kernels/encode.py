"""Block-parallel LZW encode parse: the CUDA kernel and its plain version.

Port of ``lzw_tpu/kernels/encode_pallas.py``.  The TPU package has several
parse kernels (K1 chunked, K2 single-launch, and the legacy K6-K8) that all
produce the same dense codes; on Hopper one kernel,
``csrc/encode_parse.cu``, serves every flavor and block size.

TPU containments with no counterpart here: the ``SUPER_GROUP_MAX`` batch
slicing and the two-dispatch encode/pack split (XLA miscompile workarounds),
``eq16`` and the VMEM group/cell/segment tiles, the between-launch table
recompaction and ``_compact_grouped_codes`` (the kernel writes dense codes
through a per-block cursor).
"""

from __future__ import annotations

import ctypes

import torch

from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, LzwSpec

__all__ = ["encode_blocks_codes", "encode_blocks_codes_reference",
           "encode_blocks_fixed", "pack12"]

THREADS_PER_CTA = 8  # lanes per warp: the probe loop diverges per lane
_HASH_SLOTS = 8192  # per-block hash table (matches csrc/encode_parse.cu)


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
                        spec: LzwSpec | None):
    """LZW-parse each row of ``blocks`` into its dense code sequence.

    Args:
      blocks: u8[N, B] block bytes (contents past ``lens`` ignored).
      lens:   i32[N] valid byte counts (<= B).
      spec:   the wire spec (``None`` or a fixed spec: fixed-12 parse).
    Returns:
      (dense i32[N, B+1] zero past counts, counts i32[N], err i32[N],
      err_code i32[N]); err 1 flags a byte > max_code after the first.

    CPU tensors run :func:`encode_blocks_codes_reference`; CUDA tensors run
    the kernel, and anything else raises.
    """
    _check_inputs(blocks, lens)
    if blocks.device.type == "cpu":
        return encode_blocks_codes_reference(blocks, lens, spec)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    first_free, max_code, reset = _spec_params(spec)
    N, B = blocks.shape
    dev = blocks.device
    lib = build.load("encode_parse")
    fn = lib.encode_parse_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        tables = torch.empty((N, _HASH_SLOTS), dtype=torch.int32, device=dev)
        dense = torch.zeros((N, B + 1), dtype=torch.int32, device=dev)
        counts = torch.empty(N, dtype=torch.int32, device=dev)
        err = torch.empty(N, dtype=torch.int32, device=dev)
        err_code = torch.empty(N, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(blocks.data_ptr(), lens.data_ptr(), N, B, first_free,
                max_code, reset, tables.data_ptr(), dense.data_ptr(),
                counts.data_ptr(), err.data_ptr(), err_code.data_ptr(),
                THREADS_PER_CTA, stream)
    build.check_launch("encode_parse", rc)
    return dense, counts, err, err_code


def encode_blocks_codes_reference(blocks: torch.Tensor, lens: torch.Tensor,
                                  spec: LzwSpec | None):
    """Plain PyTorch version of :func:`encode_blocks_codes`.

    A lockstep loop over byte positions, vectorised over blocks, mirroring
    ``_stage_step_fn`` (encode_pallas.py:329-487).  The dictionary is a
    dense child map per block indexed by the (prefix<<8 | byte) key, holding
    the code (-1 = absent): 4 MiB per block, so this version is for small
    batches.  Keys are computed in int64; codes fit int32.
    """
    first_free, max_code, reset = _spec_params(spec)
    variable = reset >= 0
    N, B = blocks.shape
    dev = blocks.device
    x = torch.zeros((N, B + 1), dtype=torch.int64, device=dev)
    x[:, :B] = blocks.to(torch.int64)
    lens = lens.to(torch.int64)
    rows = torch.arange(N, device=dev)
    # The last column takes the writes of blocks that insert nothing, so
    # every step writes all rows without a data-dependent index.
    dump = MAX_TABLE_SIZE << 8
    child = torch.full((N, dump + 1), -1, dtype=torch.int32, device=dev)
    prefix = torch.zeros(N, dtype=torch.int64, device=dev)
    nxt = torch.full((N,), first_free, dtype=torch.int64, device=dev)
    err = torch.zeros(N, dtype=torch.int64, device=dev)
    err_code = torch.zeros(N, dtype=torch.int64, device=dev)
    slots = torch.full((N, B + 1), -1, dtype=torch.int64, device=dev)

    for i in range(B + 1):
        k = x[:, i]
        active = (i < lens) & (err == 0)
        final = (i == lens) & (lens > 0) & (err == 0)
        if i == 0:
            prefix = torch.where(active, k, prefix)
            continue
        if variable:
            bad = active & (k > max_code)
            err = torch.where(bad, 1, err)
            err_code = torch.where(bad, k, err_code)
            active = active & ~bad
        key = prefix * 256 + k
        matched = child[rows, key].to(torch.int64)
        miss = active & (matched < 0)
        hit = active & (matched >= 0)
        slots[:, i] = torch.where(miss | final, prefix, -1)
        ins = miss if variable else miss & (nxt < MAX_TABLE_SIZE)
        child[rows, torch.where(ins, key, dump)] = nxt.to(torch.int32)
        if variable:
            # The entry that trips the reset is wiped with the rest.
            reset_now = ins & (nxt == reset)
            if bool(reset_now.any()):
                child[reset_now] = -1
            nxt = torch.where(reset_now, first_free, nxt + ins.to(torch.int64))
        else:
            nxt = nxt + ins.to(torch.int64)
        prefix = torch.where(miss, k, torch.where(hit, matched, prefix))

    # Hole compaction: emitted codes to the front of each row, zeros after.
    keep = slots >= 0
    counts = keep.sum(dim=1)
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, B + 1)
    dense = torch.zeros((N, B + 2), dtype=torch.int64, device=dev)
    dense.scatter_(1, pos, torch.where(keep, slots, 0))
    return (dense[:, : B + 1].to(torch.int32), counts.to(torch.int32),
            err.to(torch.int32), err_code.to(torch.int32))


def pack12(dense: torch.Tensor, counts: torch.Tensor, little: bool):
    """Static 12-bit pair packing: codes i32[N, S] -> bytes u8[N, 3*ceil(S/2)]
    and byte lengths (encode_pallas.py:923-939)."""
    N, S = dense.shape
    if S % 2:
        dense = torch.cat(
            [dense, torch.zeros((N, 1), dtype=dense.dtype,
                                device=dense.device)], dim=1)
    c = dense.to(torch.int32).reshape(N, -1, 2)
    c0, c1 = c[..., 0], c[..., 1]
    if little:
        b0 = c0 & 0xFF
        b1 = (c0 >> 8) | ((c1 & 0xF) << 4)
        b2 = (c1 >> 4) & 0xFF
    else:
        b0 = (c0 >> 4) & 0xFF
        b1 = ((c0 & 0xF) << 4) | (c1 >> 8)
        b2 = c1 & 0xFF
    by = torch.stack([b0, b1, b2], dim=-1).reshape(N, -1)
    lengths = (12 * counts.to(torch.int32) + 7) >> 3
    return by.to(torch.uint8), lengths


def encode_blocks_fixed(blocks: torch.Tensor, lens: torch.Tensor,
                        little: bool = True):
    """Fixed-12 block encode: (payloads u8[N, PB] zero-padded, lengths
    i32[N]), the contract of ``encode_pallas.encode_blocks_fixed_tpu``."""
    dense, counts, _, _ = encode_blocks_codes(blocks, lens, None)
    return pack12(dense, counts, little)
