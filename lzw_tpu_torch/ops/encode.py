"""Per-block and single-stream LZW encode, and the static size bound.

Port of ``lzw_tpu/ops/encode.py``.  The JAX package encodes a block with
its own XLA scan (``encode_block``: a hash-table dictionary, two (code,
width) slots per input byte) and packs the slots with
``bitpack.pack_codes_jax``.  The port keeps the parse in the kernels of
:mod:`lzw_tpu_torch.kernels.encode`, which give the same dense codes: the
block container's ``csrc/encode_parse.cu`` for many rows, and
``csrc/stream_encode.cu`` (one warp on one stream's chain, several
phrases a step) for the facades' one stream.

* :func:`encode_block` keeps the JAX function's slot contract: the parse
  kernel's positions instance reports the byte that emitted each code, a
  code's width and the CLEARs after it come from the static schedule
  (:func:`lzw_tpu_torch.kernels.schedule.emission_schedule`), and the codes
  are scattered into their slots; :func:`lzw_tpu_torch.ops.bitpack.
  pack_codes_torch` packs them.
* :func:`encode_stream_bytes` launches ``stream_encode.cu`` on one row and
  packs the dense codes with :func:`pack_dense`, with no slots.
* :func:`pack_dense` packs either kernel's dense codes to wire bytes, for
  the facades and the block container alike: against the static schedule
  (:func:`lzw_tpu_torch.kernels.schedule.pack_variable`) or in 12-bit pairs
  (:func:`lzw_tpu_torch.kernels.encode.pack12`).
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.encode import (
    encode_blocks_codes, encode_stream_codes, pack12,
)
from lzw_tpu_torch.spec import (
    MAX_TABLE_SIZE, MAX_WIDTH, Endianness, LzwSpec, UnexpectedCodeError,
)
from lzw_tpu_torch.utils import spans

__all__ = ["ERR_NONE", "ERR_UNEXPECTED_CODE", "MAX_ROW", "MAX_STREAM",
           "encode_block", "encode_stream_bytes", "encoder_output_slots",
           "pack_dense", "packed_bound"]

# Error kinds reported in encode_block's result (the host raises the typed
# exceptions).
ERR_NONE = 0
ERR_UNEXPECTED_CODE = 1

# The longest stream encode_stream_bytes takes: the single-stream kernel's
# row width (the stream rounded up to 16 bytes) and its dense code count
# are i32.
MAX_STREAM = 2**31 - 16
# The longest row encode_block takes: its 2 * B + 3 slots are indexed by
# i32.
MAX_ROW = 2**30 - 2


def encoder_output_slots(block_size: int) -> int:
    """Number of (code, width) slots for a block of ``block_size`` bytes.

    Slot layout: [CLEAR] + 2 per byte (miss code, possible reset CLEAR) +
    [final prefix, EOI].  Unused slots have width 0 and are skipped by the
    packer.
    """
    return 2 * block_size + 3


def packed_bound(block_size: int, spec: LzwSpec) -> int:
    """Static worst-case compressed size in bytes for one block."""
    if spec.variable:
        # Worst case: every byte misses at up to 12 bits, plus a CLEAR per
        # table fill (at least 4096 - 2**cs - 2 misses apart), plus leading
        # CLEAR and trailing prefix+EOI.
        resets = block_size // (MAX_TABLE_SIZE - spec.first_free_code) + 1
        bits = MAX_WIDTH * (block_size + resets + 3)
    else:
        bits = MAX_WIDTH * (block_size + 1)
    return (bits + 7) // 8 + 1


def encode_block(blocks: torch.Tensor, n_valid: torch.Tensor, spec: LzwSpec,
                 hash_bits: int = 13, fix_eoi_width: bool = False) -> dict:
    """Encode rows of bytes into (code, width) slots, the contract of the
    JAX package's ``encode_block`` under ``jax.vmap``.

    Args:
      blocks:  u8[N, B] input bytes, padded past ``n_valid``.
      n_valid: i32[N] valid leading bytes per row (<= B).
      spec:    the wire format.
      hash_bits: accepted for the JAX signature and ignored: it sizes the
        JAX scan's hash table, and no output depends on it.
      fix_eoi_width: when True, widen the trailing EOI by one bit where the
        decoder-side width bump lands exactly on the final data code (see
        ``lzw_tpu_torch.ops.reference.eoi_width_quirk``), as the block
        container does; False is bit-exact with the reference.

    Returns a dict of ``codes`` and ``widths`` i32[N, S] with ``S =
    encoder_output_slots(B)``, and ``error``, ``error_code`` and
    ``error_pos`` i32[N].  Slot layout, variable specs: slot 0 the head
    CLEAR; the miss at byte i in slot 1 + 2i and a reset CLEAR after it in
    2 + 2i; the final prefix in 2B + 1 and EOI in 2B + 2.  Fixed-12: the
    miss at byte i in 2i (2i + 1 always empty), the final prefix in 2B,
    then two empty pads.  Width 0 marks an empty slot, which the packer
    skips.  On an error (a byte past the alphabet at index >= 1, variable
    specs only) the head, the final prefix and EOI are empty and the slots
    emitted before the bad byte keep their widths.

    One deviation from the JAX function: an empty miss slot's code is 0
    here, where the JAX scan writes its running prefix; neither is part of
    the contract.  Every width, every code of a non-empty slot, every
    reset-CLEAR slot's code (``clear_code``; 0 for fixed) and the errors
    are the JAX function's.

    CUDA rows run the encode-parse kernel's positions instance, CPU rows
    its plain version; any other device raises.  Raises ValueError for
    rows longer than :data:`MAX_ROW`.
    """
    spec.validate()
    B = blocks.shape[-1]
    if B > MAX_ROW:
        raise ValueError(f"rows of {B} bytes are past the {MAX_ROW} whose "
                         "slots an i32 indexes")
    dense, counts, err, err_code, pos = encode_blocks_codes(
        blocks, n_valid, spec, positions=True)
    N, dev = blocks.shape[0], blocks.device
    S = encoder_output_slots(B)
    variable = spec.variable
    live = torch.arange(B + 1, device=dev)[None, :] < counts[:, None]
    body = pos < n_valid[:, None]
    # Each code's slot: its byte's miss slot, or the tail for the final
    # prefix (at byte n_valid).  Codes past the count are 0 and land on the
    # last slot: EOI, written below, or fixed-12's empty pad.
    slot = pos.to(torch.int64)
    del pos
    slot.mul_(2)
    if variable:
        slot.add_(1)
    slot.masked_fill_(~body, 2 * B + 1 if variable else 2 * B)
    slot.masked_fill_(~live, S - 1)
    codes = torch.zeros((N, S), dtype=torch.int32, device=dev)
    widths = torch.zeros((N, S), dtype=torch.int32, device=dev)
    codes.scatter_(1, slot, dense)
    del dense
    ok = err == ERR_NONE
    if variable:
        # Code m's width, the codes followed by a reset CLEAR, and the EOI
        # width after m codes, from the static schedule.
        tabs = _sched._device_tables(spec, B + 1, fix_eoi_width, dev)
        widths.scatter_(1, slot, torch.where(
            live, tabs["widths"].to(torch.int32)[None, :], 0))
        # A reset CLEAR follows its miss; every such slot holds clear_code.
        codes[:, 2 : 2 * B + 1 : 2] = spec.clear_code
        cm = tabs["clear_m"]
        rows, k = torch.nonzero(live[:, cm] & body[:, cm], as_tuple=True)
        widths[rows, slot[rows, cm[k]] + 1] = MAX_WIDTH
        codes[:, 0] = spec.clear_code
        widths[:, 0] = torch.where(ok, spec.initial_width, 0)
        codes[:, S - 1] = spec.end_code
        widths[:, S - 1] = torch.where(ok, tabs["eoi_w"][counts.long()], 0)
        # The first byte past the alphabet after the first (the kernel
        # stops there).
        at = torch.arange(B, device=dev)[None, :]
        bad = ((blocks > spec.max_code_value) & (at >= 1)
               & (at < n_valid[:, None]))
        error_pos = torch.where(bad.any(dim=1),
                                bad.to(torch.uint8).argmax(dim=1), 0)
    else:
        widths.scatter_(1, slot, live.to(torch.int32).mul_(MAX_WIDTH))
        error_pos = torch.zeros(N, dtype=torch.int64, device=dev)
    return {"codes": codes, "widths": widths, "error": err,
            "error_code": err_code, "error_pos": error_pos.to(torch.int32)}


def encode_stream_bytes(data: bytes, spec: LzwSpec,
                        fix_eoi_width: bool = False,
                        device: str | torch.device = "cuda",
                        stage=None) -> bytes:
    """Compress one stream on ``device`` to salzweg's raw wire format.

    With ``fix_eoi_width=False`` (the default) the bytes are salzweg's, as
    the JAX facade calls ``encode_block``; ``True`` widens the EOI of a
    stream whose last data code lands on a width bump, as the container
    does (see ``lzw_tpu_torch.ops.reference.eoi_width_quirk``).  A CUDA
    device runs the single-stream kernel ``stream_encode.cu``, the CPU its
    plain version.
    Raises :class:`UnexpectedCodeError` for a byte past the alphabet after
    the first, and ValueError for a stream longer than :data:`MAX_STREAM`.
    ``stage(name)``, when given, is a context manager timing each step
    (``enc_h2d``, ``enc_kernel``, ``enc_pack``, ``enc_d2h``), as the
    container's stages are named; without it each step is a span
    (:mod:`lzw_tpu_torch.utils.spans`).  The row's build
    (``enc_host_prep``) and the error read (``enc_errors``) are spans
    only.  While a profiler records, the counters
    ``stream_encode.steps`` and ``stream_encode.rounds`` take the
    kernel's steps and rounds (copied in ``enc_errors``), and
    ``stream_encode.bytes`` the stream's bytes.
    """
    spec.validate()
    stage = stage or spans.span
    if len(data) > MAX_STREAM:
        raise ValueError(f"a stream of {len(data)} bytes is past the "
                         f"{MAX_STREAM} that the parse kernel's i32 "
                         "rows take")
    device = torch.device(device)
    # A row of whole 16-byte pieces, as the kernel reads it (an empty
    # stream is a row of length 0).
    with spans.span("enc_host_prep"):
        row = np.zeros((1, max(-(-len(data) // 16) * 16, 16)), np.uint8)
        row[0, : len(data)] = np.frombuffer(bytes(data), np.uint8)
    with stage("enc_h2d"):
        blocks = torch.from_numpy(row).to(device)
        lens = torch.tensor([len(data)], dtype=torch.int32, device=device)
    counted = spans.recording()
    with stage("enc_kernel"):
        dense, counts, err, err_code, *walk = encode_stream_codes(
            blocks, lens, spec, stats=counted)
    with spans.span("enc_errors"):
        if int(err[0]):
            raise UnexpectedCodeError(int(err_code[0]), spec.code_size)
        if walk:
            steps, rounds = walk[0][0].tolist()
            spans.count("stream_encode.steps", steps)
            spans.count("stream_encode.rounds", rounds)
            spans.count("stream_encode.bytes", len(data))
    with stage("enc_pack"):
        bufs, n_bytes = pack_dense(dense[:, : max(int(counts[0]), 1)],
                                   counts, spec, fix_eoi=fix_eoi_width)
    with stage("enc_d2h"):
        return bufs[0, : int(n_bytes[0])].cpu().numpy().tobytes()


def pack_dense(dense: torch.Tensor, counts: torch.Tensor, spec: LzwSpec,
               fix_eoi: bool):
    """Pack the parse kernels' dense codes to wire bytes on their device:
    variable specs against the static schedule (``fix_eoi`` as in
    :func:`lzw_tpu_torch.kernels.schedule.pack_variable`), fixed-12 in
    12-bit pairs.  ``dense`` i32[N, S] and ``counts`` i32[N] as
    :func:`lzw_tpu_torch.kernels.encode.encode_blocks_codes` gives them;
    returns (u8[N, PB], i32[N] byte counts).

    The first byte of a stream is never range-checked, so at a code size
    below 8 a variable stream's first code can be wider than its slot.  It
    is masked to ``initial_width`` here, in place in ``dense``'s column 0,
    as the oracle and the JAX package's ``pack_codes_jax`` keep its low
    bits; the parse kernels' dense codes (their contract with
    ``encode_pallas``) keep the whole byte.
    """
    if not spec.variable:
        return pack12(dense, counts, spec.endianness is Endianness.LITTLE)
    if dense.shape[1]:
        # In place on the column's view: ``dense[:, 0] &= m`` would also
        # copy the column back through __setitem__.
        dense[:, 0].bitwise_and_((1 << spec.initial_width) - 1)
    return _sched.pack_variable(dense, counts, spec, fix_eoi=fix_eoi)
