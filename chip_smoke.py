#!/usr/bin/env python3
"""Smoke run of the lzw_tpu_torch main path on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

1. device: the CUDA card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the thirteen CUDA kernels from
   ``lzw_tpu_torch/kernels/csrc`` (nvcc, sm_90a) and the native runtime
   from ``lzw_tpu_torch/native``, all at once;
3. kernel vs plain: the encode-parse kernel, pass 1 with its stride-2 and
   with its stride-1 pair rows, the word-offset scan ``word_ends`` and both
   pass-2 walks (stride-2 and stride-1), padded and flat, against their
   plain PyTorch versions on the card, exact equality, the flat bytes
   against the padded rows' masked bytes and both walks' bytes against the
   blocks, for gif7, gif2, tiff
   and fixed-12 on 64 blocks x 8 KiB of random and compressible data; then
   the encode-parse and pass-1 kernels on their edge cases
   (``lzw_tpu_torch.utils.testdata``: blocks of length 0, 1, 2 and B in
   one launch, partly filled CTAs and more blocks than one round of
   chains, full tables, resets, KwKwK runs, errors and the words past each
   block's stop), the encode parse with and without positions against one
   plain run, pass 1 with every row kind, exact, on those cases and on the
   edges of a block's dictionary epochs; then ``[pass1]`` lines: pass 1
   at one image plane a call (11 x 64 KiB gif7, 86 x 8 KiB TIFF, 171 x 4
   KiB fixed-12) against the plain version and timed, as again at phases 4
   and 5's shapes (here and in phases 4 and 5 the encode parse's two
   instances, the container's and the positions one, against one plain
   run);
4. the slice: ``BlockParallelCodec(LzwSpec.gif(7), device="cuda:0")`` on
   128 MiB (2048 x 64 KiB blocks) of the tiled image corpus and of the tiled
   text corpus: every payload equal to the native runtime's encoder, and a
   byte-exact round trip through each decode route, the hybrid
   (``pass2="host"``: the native ``apply_words``), the all-device one
   (``pass2="device"``, which must not call the native runtime) and the
   default ``"auto"`` (which must take the device route here); the launch
   counts of each route, stage and end to end MiB/s; then the encode,
   pass-1, scan and walk kernels against their plain versions at the main
   path's shapes;
5. a 32 MiB fixed-12 round trip at 4 KiB blocks with the same checks, and
   the same kernels against their plain versions at its shape;
6. a non-strict gif7 container (128 x 64 KiB blocks, an early CLEAR every
   2000 bytes) through ``pass2="device"`` and ``"auto"`` (which must call
   the native ``decode_blocks``): equal to the input and to the native
   runtime's ``decode_blocks``; then the decode kernels against their plain
   versions at the sub-streams' shape;
7. the stride-1 route at the main path's width: the all-device decode with
   ``stride2=False`` (pass 1 with stride-1 rows, then the scan and the
   stride-1 flat walk) beside the default stride-2 one, in turns, on the
   payloads of the
   128 MiB gif7 image container (2048 x 64 KiB) and of the 32 MiB fixed-12
   one: bytes equal to the input, each run counted to launch its own walk
   and no native call, end to end MiB/s of both; then the stride-1 walk
   against its plain version at both shapes (on the kernel's own stride-1
   rows at 64 KiB) and the stride-1 rows against theirs at the fixed-12
   shape, and pass 1's, the scan's and the flat walks' times side by side;
8. the probe entry points: ``python -m lzw_tpu_torch.scripts.ablate_kernel
   all``, ``ablate2``, ``probe_i16`` (and its sweep at T = 256) and
   ``probe_gpu all`` at the JAX scripts' shapes, counted to launch each
   of the four probe kernels, every gather OK and the sweep's time
   following T; then each probe kernel against its plain version on the
   same inputs in every variant, exact (P2 also on inputs that hit its
   ring, in cells of 256 and 1024, with rings of 4 and 4095, near 2**23
   and on 1000 lanes: ``scripts.ablate2.ring_cases``); P1's and P2's
   times beside their chain floor;
   P4-a and P4-b beside the yardstick library calls, in turns, and each
   launch alone (20 in one CUDA graph);
9. the row split: ``BlockParallelCodec`` over every visible GPU (and, on a
   one-GPU machine, over ``["cuda:0", "cuda:0"]``: two ranges at once on
   one card) beside one device, on the 128 MiB gif7 image and the 32 MiB
   fixed-12 one: payloads equal to one device's container, a round trip
   on every ``pass2`` route, each run's launch and native-call counts
   exactly its ranges times one device's, MiB/s of both in turns; a
   corrupt block in the second range raises its own code, and with one in
   the first range too, the first one's;
10. block ranges over two processes: ``MultiHostBlockCodec`` on ``gloo``
   (and on ``nccl`` with two GPUs or more), each rank on cuda:(rank %
   device count), the 128 MiB gif7 image through ``encode``,
   ``encode_shards`` and ``decode``: every rank's containers equal to the
   one-process container, round trips exact, wall times;
11. the single-stream facades on the native runtime (host MiB/s, no kernel
   launched): the golden file, bytes and stream round trips of 16 MiB of
   the image plane in gif7, TIFF and fixed-12 of both endiannesses, the
   corrupt TIFF stream's code 258;
12. ``lzw_tpu_torch.entry``: ``entry()``'s encode step on the card equal to
   the native encoder, and ``dryrun_multichip`` over every visible GPU;
13. the examples and observability: ``lzw_tpu_torch.examples.usage``
   against the golden file and ``compress_image_data`` on cuda:0 (round
   trip, container equal to the native encoder's blocks); then on the
   128 MiB gif7 image data of phase 4 and a 32 MiB fixed-12 one, encode
   and each decode route once, the peak memory statistics reset before
   each: its ``RunMetrics`` JSON and its peak from
   ``device_memory_report()`` (which must lie in (0, bytes_limit]) beside
   the peak that ``predicted_peaks`` works out from the allocations; the
   gif7 encode and device-route decode under ``trace``, each trace read
   back and required to hold the device events of the operation's
   kernels, and their device-kernel time beside the wall time;
14. the single-stream codec on the card (``lzw_tpu_torch.ops``): the
   ``"torch"`` facades on cuda:0 (gif7, TIFF, fixed-12 of both
   endiannesses) on 16 MiB of the image plane, encode bytes equal to the
   ``"native"`` backend's, decode and stream round trips exact, the
   golden file both ways, the error streams raising native's class and
   code; a gif7 container of 1 MiB blocks and a TIFF one of 256 KiB
   blocks, each on 32 MiB of the image plane, encoded on the card and
   decoded with ``pass2="device"`` (the kernels ``stream_pass1`` and
   ``stream_pass2``, no native call): equal to the input and to native
   ``decode_blocks``,
   MiB/s of each and the decode's peak memory beside ``stream_peak``;
   then both kernels against their plain versions at the shapes these
   runs gave them (each container's payload rows, each facade's 16 MiB
   stream; the plain pass 1 on a pool of processes), every output array
   exact, each kernel timed through its wrapper and alone, with ns a code
   and its share of its bound; then both kernels against their plain
   versions on the edge-case rows of ``testdata.stream_edge_cases`` in
   six flavors; then the single-stream encode kernel ``stream_encode``
   (each ``"torch"`` facade encode counted to launch it once and
   ``encode_parse`` never): on each facade's 16 MiB stream and on the
   text tiled to 16 MiB, the facade encode stage by stage (H2D, kernel,
   pack, D2H) == native, the kernel against its plain version exactly,
   with ns a byte, a phrase and a round, its phrases a round, its bound
   and its chain floor, and ``encode_parse`` on the same one row; the
   same on random 16 MiB gif7 and fixed-12 streams (short phrases); both
   kernels on 32 x 1 MiB gif7 rows; the kernel on the edge rows of
   ``testdata.stream_encode_edge_cases`` in five flavors, its steps
   against the plain version's phrases;
15. the JAX package's per-block encode (``lzw_tpu_torch.ops.encode.
   encode_block``): on phase 3's rows ``encode_block`` on the card against
   the CPU; then ``pack_codes_torch(encode_block(...))`` on 2048 x
   64 KiB gif7 and 8192 x 4 KiB fixed-12 rows of the image plane equal,
   block for block, to the payloads ``BlockParallelCodec`` frames, with
   the positions and the container's instances, the wrapper and the pack
   timed by CUDA events and the peak memory beside ``encode_block_peak``;
16. the container's contract on input past the alphabet and on blocks that
   decode past their size: 2048 x 64 KiB gif2 blocks of the image plane
   (reduced to 2 bits), each block's first byte past the alphabet, through
   ``BlockParallelCodec``: every payload equal to the native runtime's
   single-stream encode of its block (the first code masked to its slot),
   a sample to the CPU plain route's, ``verify=True`` raising
   VerificationError, the pack with the mask beside the pack without it;
   then a gif7 container of 128 x 64 KiB blocks, two of them holding 68 KiB
   streams: the same UnexpectedCodeError code on ``pass2`` "host",
   "device" and "auto", equal to the plain pass 1's and the oracle's; the
   same for a foreign early-CLEAR 68 KiB stream in that container (the
   non-strict route) and for a 260 KiB stream in a container of 8 x
   256 KiB blocks (past ``MAX_BLOCK``: the single-stream decoder), where
   "host" and "auto" first call the native ``decode_blocks``; and in that
   container a stream that fills its block, then a CLEAR and a first code
   naming an entry never inserted: every route raises the wire code read.

``python3 chip_smoke.py --stream-only`` runs phases 1, 2 and 14 alone
(about two minutes), ``python3 chip_smoke.py --contract-only`` phases 1, 2
and 16, ``python3 chip_smoke.py --probes-only`` phases 1, 2 and 8,
``python3 chip_smoke.py --pass1-only`` phases 1, 2 and the ``[pass1]``
lines (pass 1 at one image plane a call and at phases 4 and 5's shapes);
each ends with ``[done]`` lines, not the JSON lines.

Phases 1-8 run on cuda:0.  Each timing of the encode-parse kernel also
prints its chains in flight (CTAs per SM from the occupancy query x warps
per CTA x SMs), the rounds of chains the launch takes and the ns per chain
step: the kernel's time over rounds x steps of the longest block.  Each
timing of pass 1 prints its CTAs (one a block), the epochs each walks in
turn and the us per epoch: the kernel's time over the rounds of CTAs the
card's SMs take x the epochs of a block.  Each timing
of a walk (``[walk]`` lines) prints the walk's launch alone, the scan, the
torch call the scan replaced, the flat and padded wrappers, the longest
word and the walk's time over the dependent loads along it.

It prints a ``{"kernels": [...]}`` line, each kernel with its bound (the
least time for the bytes it must move at 3.35 TB/s, or for its 32-bit
integer operations at 16.7 T/s, whichever is larger; ``encode_parse``'s
numbers are the container's instance at phase 4's shape, its launches
those of both instances, the positions one in phase 15), and ends with
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.  It imports nothing of
JAX or of the JAX package ``lzw_tpu``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent
MiB = 1 << 20
# H100 SXM at 700 W.  Device memory rate: NVIDIA's data sheet.  32-bit
# integer add, compare, min/max, select and logical operations: 64 results
# per SM and clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) on 132 SMs at 1.98 GHz, the clock
# behind the data sheet's 67 TFLOP/s float32 (128 lanes x 2 per SM-clock).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
# Each CUDA kernel's source and the TPU kernel it replaces (file:line of the
# kernel function; see PERF.md for the whole table).
KERNEL_SOURCES = {
    # One kernel for K1, K2 and the legacy K6-K8, which differ only in the
    # TPU's dictionary layout, and, in its positions instance, for the XLA
    # scan of the JAX package's per-block encode (phase 15).
    "encode_parse": ("lzw_tpu_torch/kernels/csrc/encode_parse.cu",
                     "lzw_tpu/kernels/encode_pallas.py:501 (K1), :595 (K2), "
                     ":92 (K6), :105 (K7), :679 (K8); lzw_tpu/ops/encode.py:"
                     "186 (no pallas_call: encode_block's lax.scan, "
                     "positions instance)"),
    "decode_pass1": ("lzw_tpu_torch/kernels/csrc/decode_pass1.cu",
                     "lzw_tpu/kernels/decode_pallas.py:128"),
    # No TPU kernel: the torch glue over the word lengths that the JAX
    # package sums in `_epoch_totals`.
    "word_ends": ("lzw_tpu_torch/kernels/csrc/word_ends.cu",
                  "lzw_tpu/kernels/decode_pallas.py:698 (no pallas_call: "
                  "the glue over _epoch_totals' lengths)"),
    "decode_pass2": ("lzw_tpu_torch/kernels/csrc/decode_pass2.cu",
                     "lzw_tpu/kernels/decode_pallas.py:1289"),
    "decode_pass2_stride1": (
        "lzw_tpu_torch/kernels/csrc/decode_pass2_stride1.cu",
        "lzw_tpu/kernels/decode_pallas.py:1085"),
    # No TPU kernel: the XLA scan of the JAX package's encode_block at the
    # facades' one row (phase 14).
    "stream_encode": ("lzw_tpu_torch/kernels/csrc/stream_encode.cu",
                      "lzw_tpu/ops/encode.py:186 (no pallas_call: "
                      "encode_block's lax.scan at the facades' one row, "
                      "lzw_tpu/api.py:150; its probe loop :119)"),
    # No TPU kernel: the two lax.while_loops of the JAX package's XLA
    # single-stream decoder (phase 14).
    "stream_pass1": ("lzw_tpu_torch/kernels/csrc/stream_pass1.cu",
                     "lzw_tpu/ops/decode.py:68 (no pallas_call: the XLA "
                     "codec's lax.while_loop over codes, :266)"),
    "stream_pass2": ("lzw_tpu_torch/kernels/csrc/stream_pass2.cu",
                     "lzw_tpu/ops/decode.py:284 (no pallas_call: the XLA "
                     "codec's lax.while_loop over word rounds, :327)"),
    # The probes of the JAX package's scripts (phase 8).
    "ablate_parse": ("lzw_tpu_torch/kernels/csrc/ablate_parse.cu",
                     "scripts/ablate_kernel.py:25 (P1a), :120 (P1b)"),
    "ablate_ring": ("lzw_tpu_torch/kernels/csrc/ablate_ring.cu",
                    "scripts/ablate2.py:24 (P2)"),
    "probe_scan": ("lzw_tpu_torch/kernels/csrc/probe_scan.cu",
                   "scripts/probe_i16.py:29 (P3)"),
    "probe_gather": ("lzw_tpu_torch/kernels/csrc/probe_gather.cu",
                     "scripts/probe_tpu.py:31 (P4-a), :51 (P4-b), "
                     ":82 (P4-b2), :115 (P4-b3)"),
}
PROBE_KERNELS = ("ablate_parse", "ablate_ring", "probe_scan", "probe_gather")
# Calls of the native runtime's decode entry points, by name; the
# all-device route must make none.
HOST_CALLS = {"apply_words": 0, "decode_blocks": 0}
# The container calls them from one thread per device range.
HOST_LOCK = threading.Lock()


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class Result(NamedTuple):
    """A kernel against its plain version on the same inputs."""

    err: int  # max_abs_err
    ms: float  # the kernel's time, CUDA events
    plain_ms: float  # the plain version's, one call
    bound_ms: float  # the least time the card could take for the work
    bound_by: str  # "bytes" or "operations"
    library_ms: float | None = None  # one PyTorch call of the function


def result(err: int, ms: float, plain_ms: float, n_bytes: float,
           n_ops: float, library_ms: float | None = None) -> Result:
    """A Result whose bound is the larger of ``n_bytes`` (each input read
    once, each output written once) at the memory rate and ``n_ops``
    32-bit integer operations at their rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return Result(err, ms, plain_ms, t_bytes, "bytes", library_ms)
    return Result(err, ms, plain_ms, t_ops, "operations", library_ms)


def once_ms(fn) -> tuple[float, object]:
    """Milliseconds of one call of ``fn`` (host clock around synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def graph_ms(fn, n: int = 20) -> float:
    """Milliseconds a call of ``fn`` on the card alone: ``n`` calls captured
    in one CUDA graph, replayed by CUDA events, over ``n`` (the host's
    launch path left out)."""
    import torch

    from lzw_tpu_torch.utils.card import cuda_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 10) / n


def max_abs_err(got, want) -> int:
    """Largest absolute difference over tuples of integer tensors; raises
    on a shape mismatch."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            d = (g.to(w.device).long() - w.long()).abs().max().item()
            worst = max(worst, int(d))
    return worst


def tile(data: bytes, n: int) -> bytes:
    return (data * (n // len(data) + 1))[:n]


def sample_blocks(spec, n_blocks: int, block: int, seed: int):
    """Half random, half compressible rows in the spec's alphabet."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hi = spec.alphabet_size if spec.variable else 256
    mat = rng.integers(0, hi, size=(n_blocks, block)).astype(np.uint8)
    words = rng.integers(0, hi, size=(64, 6)).astype(np.uint8)
    for r in range(n_blocks // 2, n_blocks):
        pick = rng.integers(0, len(words), size=block // 6 + 1)
        mat[r] = words[pick].reshape(-1)[:block]
    lens = np.full(n_blocks, block, np.int32)
    lens[-1] = block - 123  # one short block
    return mat, lens


def pass1_inputs(spec, dense, counts, device):
    """Pack the encoder's dense codes and unpack them again: the pass-1
    kernel's inputs as the container's decode gives them."""
    import numpy as np
    import torch

    from lzw_tpu_torch.kernels import decode as tdec
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.kernels import schedule as sched
    from lzw_tpu_torch.spec import Endianness

    if not spec.variable:
        little = spec.endianness is Endianness.LITTLE
        pay, nb = tenc.pack12(dense, counts, little)
        codes, n_codes = tdec.unpack12(pay, nb, little)
        return codes.contiguous(), n_codes.contiguous(), None
    width = max(int(counts.max()), 1)
    pay, nb = sched.pack_variable(dense[:, :width], counts, spec)
    pay_h, nb_h = pay.cpu().numpy(), nb.cpu().numpy()
    cnt, strict, sched_arr, S = tdec.prepare_variable_decode(pay_h, nb_h, spec)
    if not strict.all():
        raise AssertionError("own streams recovered as non-strict")
    cnt_t = torch.from_numpy(cnt.astype(np.int32)).to(device)
    codes, ok = sched.unpack_variable_device(pay, cnt_t, spec, S)
    if not bool(ok.all()):
        raise AssertionError("own streams unpacked as non-strict")
    return codes, cnt_t, torch.from_numpy(sched_arr).to(device)


def compare_decode(spec, codes, n_codes, block, sched_t, label,
                   stride2: bool = True, pass1=None):
    """Pass 1 with its stride-2 pair rows (``stride2``) or its stride-1
    ones, unless ``pass1`` gives the kernel's own outputs with them, then
    the scan kernel ``word_ends`` and the walk of those rows, padded and
    flat, against their plain versions on the same CUDA inputs; the flat
    bytes also against the padded rows' masked bytes.

    Returns ({kernel: Result}, pass-1 outputs, the padded walk's bytes);
    pass 1 with stride-1 rows is named ``decode_pass1 stride-1``.  Bounds:
    pass 1 reads the codes and counts and writes a word and a pair row per
    code and three stats per block; the scan reads each live word and
    count once and writes an end per live word (8 B a code, 4 a block);
    the walk reads the codes, ends and rows and writes the decoded bytes;
    about 16 integer operations per code, and 4 per byte written.  The
    walk's time is its launch alone, on the scan's ends; the line also
    gives the scan, the flat and padded wrappers, the longest word and the
    walk's ns per dependent load along it."""
    import torch

    from lzw_tpu_torch.kernels import decode as tdec
    from lzw_tpu_torch.utils.card import cuda_ms

    n_blocks, width = codes.shape
    n = int(n_codes.sum())
    stats_bytes = 4 * n_blocks + (0 if sched_t is None else 8 * width)
    if stride2:
        rows, p1_name, name = "stride2", "decode_pass1", "decode_pass2"
        walk, flat_walk, plain = (tdec.decode_pass2_stride2,
                                  tdec.decode_pass2_stride2_flat,
                                  tdec.decode_pass2_stride2_reference)
    else:
        rows, p1_name = "stride1", "decode_pass1 stride-1"
        name = "decode_pass2_stride1"
        walk, flat_walk, plain = (tdec.decode_pass2_device,
                                  tdec.decode_pass2_device_flat,
                                  tdec.decode_pass2_device_reference)
    vspec = spec if spec.variable else None
    res = {}
    dec = pass1
    if dec is None:
        args = (codes, n_codes, spec, block, sched_t)
        dec = tdec.decode_pass1(*args, rows=rows)
        plain_ms, ref = once_ms(
            lambda: tdec.decode_pass1_reference(*args, rows=rows))
        ms = cuda_ms(lambda: tdec.decode_pass1(*args, rows=rows))
        res[p1_name] = result(max_abs_err(dec, ref), ms, plain_ms,
                              4 * n + stats_bytes + 8 * n + 12 * n_blocks,
                              16 * n)
        say("chains", f"{label}: {p1_name} " + pass1_line(
            spec, n_blocks, width, ms, codes.device))
    words, totals = dec[0], dec[1]

    # The scan, on live slots (the kernel writes no other), beside the torch
    # call that it replaced.
    ends = tdec.word_ends(words, n_codes, block)
    plain_ms, ref = once_ms(lambda: tdec._word_ends(words, n_codes, block))
    t = torch.arange(width, device=codes.device)[None, :]
    live = t < n_codes.long()[:, None]
    lens = torch.where(live & ((words >> 29) != tdec.KIND_HOLE),
                       (words >> 17) & 0xFFF, 0)
    res["word_ends"] = result(
        max_abs_err((ends[live],), (ref[live],)),
        cuda_ms(lambda: tdec.word_ends(words, n_codes, block)), plain_ms,
        8 * n + 4 * n_blocks, 4 * n,
        cuda_ms(lambda: torch.cumsum(torch.where(live, lens, 0), 1)))
    longest = int(lens.max()) if n else 0

    args = (codes, words, dec[4], n_codes, block, vspec, sched_t)
    out = walk(*args)
    plain_ms, ref = once_ms(lambda: plain(*args))
    flat = flat_walk(*args[:4], totals, *args[4:])
    flat_plain_ms, flat_ref = once_ms(lambda: plain(*args, totals))
    keep = (torch.arange(block, device=codes.device)[None, :]
            < totals[:, None])
    masked = out[keep]
    out_bytes = int(totals.sum())
    plan = tdec._walk_plan(words, n_codes, totals, block)
    dst = torch.empty(plan.size, dtype=torch.uint8, device=codes.device)
    walk_ms = cuda_ms(lambda: tdec._launch_walk(
        name, codes, dec[4], n_codes, sched_t, totals, plan, block, vspec,
        dst))
    res[name] = result(
        max(max_abs_err((out, flat), (ref, flat_ref)),
            max_abs_err((flat,), (masked,))),
        walk_ms, flat_plain_ms, 12 * n + stats_bytes + out_bytes,
        16 * n + 4 * out_bytes)
    loads = longest // 2 if stride2 else longest - 1
    # A warp walks 32 consecutive live slots at a time and waits for the
    # longest of their chains: the walk's dependent loads, summed over the
    # warps' 32-slot groups, spread over the warps an SM holds.
    per_slot = lens // 2 if stride2 else (lens - 1).clamp(min=0)
    steps = int(torch.nn.functional.pad(per_slot, (0, -width % 32))
                .view(n_blocks, -1, 32).amax(2).sum())
    props = torch.cuda.get_device_properties(codes.device)
    warps = props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048) // 32
    flat_ms = cuda_ms(lambda: flat_walk(*args[:4], totals, *args[4:]))
    padded_ms = cuda_ms(lambda: walk(*args))
    say("walk", f"{label}: {name} alone {walk_ms:.4f} ms, scan word_ends "
        f"{res['word_ends'].ms:.4f} ms (torch cumsum call "
        f"{res['word_ends'].library_ms:.4f} ms), flat wrapper {flat_ms:.4f} "
        f"ms, padded wrapper {padded_ms:.4f} ms (plain padded {plain_ms:.1f}, "
        f"flat {flat_plain_ms:.1f} ms); longest word {longest} B, "
        f"{loads} dependent loads, "
        f"{walk_ms * 1e6 / max(loads, 1):.1f} ns per load if it sets the "
        f"time; {steps} warp steps (each 32-slot group's longest chain), "
        f"{walk_ms * 1e6 * warps / max(steps, 1):.1f} ns per step at "
        f"{warps} warps in flight; flat == plain == padded masked")
    bad = {k: v.err for k, v in res.items() if v.err}
    if bad:
        raise AssertionError(f"{label}: kernel != plain, max_abs_err {bad}")
    if int(dec[2].abs().sum()):
        raise AssertionError(f"{label}: unexpected pass-1 error flags")
    return res, dec, out


def compare_kernels(spec, mat, lens, block, device, label,
                    stride1: bool = False):
    """The encode (both instances: the container's, and the positions one
    of ``ops.encode.encode_block``), pass-1 (stride-2 rows) and stride-2
    walk kernels against their plain versions on the same CUDA inputs, and
    the walk's bytes against the blocks; with ``stride1`` also pass 1 with
    stride-1 rows and the stride-1 walk.

    Returns {kernel: Result}.  The encoder's bound: it reads the blocks'
    bytes and lengths and writes each code and three stats per block, about
    8 integer operations per input byte."""
    import torch

    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.utils.card import cuda_ms

    blocks_t = torch.from_numpy(mat).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    enc = tenc.encode_blocks_codes(blocks_t, lens_t, spec)
    # One plain run with positions holds both instances: its first four
    # arrays are the plain version without them.
    plain_ms_e, enc_ref = once_ms(lambda: tenc.encode_blocks_codes_reference(
        blocks_t, lens_t, spec, positions=True))
    err_e = max_abs_err(enc, enc_ref[:4])
    ms_e = cuda_ms(lambda: tenc.encode_blocks_codes(blocks_t, lens_t, spec))
    if err_e:
        raise AssertionError(
            f"{label}: encode_parse != plain, max_abs_err {err_e}")
    err_p = max_abs_err(tenc.encode_blocks_codes(
        blocks_t, lens_t, spec, positions=True), enc_ref)
    if err_p:
        raise AssertionError(f"{label}: encode_parse with positions != "
                             f"plain, max_abs_err {err_p}")
    del enc_ref
    if int(enc[2].abs().sum()):
        raise AssertionError(f"{label}: unexpected encode error flags")
    say("chains", f"{label}: encode_parse " + chain_line(
        "encode_parse", len(lens), int(lens.max()), float(lens.mean()),
        ms_e, device))
    dense, counts = enc[0], enc[1]
    codes, n_codes, sched_t = pass1_inputs(spec, dense, counts, device)
    res, dec, out = compare_decode(spec, codes, n_codes, block, sched_t,
                                   label)
    walks = [(dec, out)]
    if stride1:
        res1, dec1, out1 = compare_decode(spec, codes, n_codes, block,
                                          sched_t, label, stride2=False)
        res.update(res1)
        walks.append((dec1, out1))
    # The decoded bytes are the blocks themselves.
    keep = torch.arange(block, device=device)[None, :] < lens_t[:, None]
    for dec, out in walks:
        if not torch.equal(dec[1].cpu(), lens_t.cpu()):
            raise AssertionError(f"{label}: pass-1 totals != block lengths")
        if not torch.equal(torch.where(keep, out, 0),
                           torch.where(keep, blocks_t, 0)):
            raise AssertionError(
                f"{label}: pass 2 did not give the input back")
    n_in = int(lens.sum())
    res["encode_parse"] = result(
        err_e, ms_e, plain_ms_e,
        n_in + 4 * len(lens) + 4 * int(counts.sum()) + 12 * len(lens),
        8 * n_in)
    say("kernels", f"{label}: N={mat.shape[0]} B={block} "
        f"codes={int(counts.sum())} max code/block={int(counts.max())}; "
        + kernel_times(res) + ", kernel == plain exactly (encode_parse "
        "with and without positions), "
        + ("both walks" if stride1 else "pass 2") + " == input")
    return res


def run_pass1(spec, mat, lens, block, device, label, plain: bool) -> None:
    """Pass 1 on ``mat``'s blocks as the container's decode meets them,
    with every row kind: equal to the plain version where ``plain``, and
    the words decode to the blocks' sizes.  Prints its time (CUDA events:
    the wrapper, and the launch alone from a CUDA graph, fewer calls a
    graph at the bulk shapes)."""
    import torch

    from lzw_tpu_torch.kernels import decode as tdec
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.utils.card import cuda_ms

    enc = tenc.encode_blocks_codes(torch.from_numpy(mat).to(device),
                                   torch.from_numpy(lens).to(device), spec)
    codes, n_codes, sched_t = pass1_inputs(spec, enc[0], enc[1], device)
    del enc
    N, S = codes.shape
    parts = []
    for rows in tdec.ROW_KINDS:
        args = (codes, n_codes, spec, block, sched_t, rows)
        out = tdec.decode_pass1(*args)
        if plain:
            err = max_abs_err(out, tdec.decode_pass1_reference(*args))
            if err:
                raise AssertionError(f"{label}: pass 1 rows={rows}: "
                                     f"max_abs_err {err} against plain")
        totals, errs = out[1:3]
        if int(errs.abs().sum()) or not torch.equal(
                totals.cpu(), torch.from_numpy(lens)):
            raise AssertionError(f"{label}: pass 1 did not decode the blocks")
        del out
        fn = (lambda: tdec.decode_pass1(*args))
        alone = graph_ms(fn, 20 if N < 1024 else 4)
        parts.append(f"rows {rows}: {cuda_ms(fn):.4f} (alone {alone:.4f}) "
                     f"ms, " + pass1_line(spec, N, S, alone, device))
    say("pass1", f"{label}: N={N} S={S}; " + "; ".join(parts)
        + ("; == plain exactly" if plain else ""))


def run_pass1_images(image: bytes, device) -> None:
    """:func:`run_pass1` on one image plane a call, cut as the container
    cells cut it: 11 x 64 KiB gif7 blocks, 86 x 8 KiB TIFF strips, 171 x 4
    KiB fixed-12 blocks; against the plain version too."""
    import numpy as np

    from lzw_tpu_torch import Endianness, LzwSpec

    plane = np.frombuffer(image, np.uint8)
    for label, spec, block in (
            ("gif7 one image", LzwSpec.gif(7), 1 << 16),
            ("TIFF one image", LzwSpec.tiff(), 8192),
            ("fixed-12 one image", LzwSpec.fixed(Endianness.LITTLE), 4096)):
        n = -(-len(plane) // block)
        mat = np.zeros((n, block), np.uint8)
        mat.reshape(-1)[: len(plane)] = plane
        lens = np.full(n, block, np.int32)
        lens[-1] = len(plane) - (n - 1) * block
        run_pass1(spec, mat, lens, block, device, label, plain=True)


def run_pass1_bulk(label, spec, data: bytes, block, device) -> None:
    """:func:`run_pass1` at a bulk shape (phases 4 and 5: 2048 x 64 KiB
    gif7, 8192 x 4 KiB fixed-12); :func:`compare_kernels` holds it against
    plain there."""
    import numpy as np

    mat = np.frombuffer(data, np.uint8).reshape(-1, block).copy()
    run_pass1(spec, mat, np.full(len(mat), block, np.int32), block, device,
              label, plain=False)


def pass1_line(spec, n_blocks: int, S: int, ms: float, device) -> str:
    """Pass 1's launch over ``n_blocks`` blocks of ``S`` codes: a CTA a
    block walking its epochs in turn, and ``ms`` over the rounds of CTAs
    the card's SMs take (one CTA an SM) x the epochs of a block."""
    import torch

    from lzw_tpu_torch.kernels import schedule as tsched

    epochs = -(-S // tsched.epoch_steps(spec)) if spec.variable else 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rounds = -(-n_blocks // sms) * epochs
    return (f"{n_blocks} CTAs x {epochs} epoch(s) in turn, "
            f"{ms * 1e3 / max(rounds, 1):.2f} us per round of an epoch")


def chain_line(name: str, n_blocks: int, steps: int, mean: float,
               ms: float, device) -> str:
    """The geometry of a one-chain-per-warp kernel's launch over
    ``n_blocks`` blocks and its ns per chain step: ``ms`` over rounds x
    ``steps`` of the longest block (``mean`` steps per block)."""
    from lzw_tpu_torch.kernels import chains

    g = chains.launch_geometry(name, n_blocks, device)
    ns = ms * 1e6 / max(g.rounds * steps, 1)
    return (f"{chains.chains_in_flight(name, device)} chains in "
            f"flight ({chains.ctas_per_sm(name, device)} CTA per SM x "
            f"{g.warps} warps, {g.shared_bytes} B shared), {g.rounds} "
            f"rounds of {g.chains} chains over {n_blocks} blocks, {ns:.2f} "
            f"ns per chain step ({steps} steps in the longest block, "
            f"{mean:.1f} in the mean)")


def kernel_times(res: dict[str, Result]) -> str:
    return ", ".join(
        f"{name} {r.ms:.4f} ms (plain {r.plain_ms:.1f} ms, bound "
        f"{r.bound_ms:.5f} ms by {r.bound_by}"
        + ("" if r.library_ms is None else
           f", library call {r.library_ms:.4f} ms") + ")"
        for name, r in sorted(res.items()))


def count_host_calls() -> None:
    """Count calls of the native runtime's decode entry points."""
    from lzw_tpu_torch.native.runtime import NativeRuntime

    for name in HOST_CALLS:
        fn = getattr(NativeRuntime, name)

        def counted(self, *args, _fn=fn, _name=name, **kwargs):
            with HOST_LOCK:
                HOST_CALLS[_name] += 1
            return _fn(self, *args, **kwargs)

        setattr(NativeRuntime, name, counted)


def timed_run(fn, expect: dict[str, int], label: str):
    """Run ``fn`` with every launch and host-call count set to 0 just before
    it; check the counts just after against ``expect`` (kernel or host call
    name -> 1: at least once, 0: never).  Returns (seconds, result,
    launches)."""
    import torch

    from lzw_tpu_torch.kernels import build

    build.reset_counts()
    with HOST_LOCK:
        for name in HOST_CALLS:
            HOST_CALLS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**build.LAUNCHES, **HOST_CALLS}
    for name, want in expect.items():
        if (counts[name] > 0) != bool(want):
            raise AssertionError(
                f"{label}: {name} ran {counts[name]} times, expected "
                f"{'at least once' if want else 'never'}")
    return dt, out, dict(build.LAUNCHES)


def stage_line(label: str, route: str, stages: dict, mib: float) -> None:
    say("slice", f"{label}: {route} stages (MiB/s over {mib:.0f} MiB): "
        + ", ".join(f"{k} {mib / v:.1f} ({v * 1e3:.1f} ms)"
                    for k, v in stages.items()))


def d2h_line(label: str, data: bytes, device) -> None:
    """What ``dec_d2h_out`` spends on the container's bytes, on a copy of
    them on the card: the pinned buffer's allocation, the copy into it and
    the copy into ``bytes``, by the host's clock, twice (the second
    allocation may come from PyTorch's pinned-memory cache)."""
    import numpy as np
    import torch

    from lzw_tpu_torch.kernels.decode import to_host

    flat = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    parts = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        t1 = time.perf_counter()
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        t2 = time.perf_counter()
        got = host.numpy().tobytes()
        t3 = time.perf_counter()
        if got != data:
            raise AssertionError(f"{label}: pinned copy differs")
        del host
        parts.append((t1 - t0, t2 - t1, t3 - t2))
    whole, _ = once_ms(lambda: to_host(flat).tobytes())
    say("d2h", f"{label}: {len(data) / MiB:.0f} MiB to bytes, ms (first, "
        "second): pinned alloc "
        + ", ".join(f"{p[0] * 1e3:.2f}" for p in parts) + "; copy "
        + ", ".join(f"{p[1] * 1e3:.2f} ({len(data) / p[1] / 1e9:.1f} GB/s)"
                    for p in parts) + "; tobytes "
        + ", ".join(f"{p[2] * 1e3:.2f}" for p in parts)
        + f"; to_host + tobytes {whole:.2f}")


def run_container(spec, data: bytes, block: int, label: str,
                  device="cuda:0"):
    """Encode, then decode by both routes, through BlockParallelCodec with
    every check; returns the launch counts of the three runs."""
    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing

    size = len(data)
    mib = size / MiB
    routes = ("host", "device")
    # Stage breakdown (each stage ends in a synchronise); also the warm-up.
    enc_stages: dict[str, float] = {}
    container = BlockParallelCodec(spec, block_size=block, device=device,
                                   stage_times=enc_stages).encode(data)
    dec_stages = {}
    for route in routes:
        dec_stages[route] = {}
        codec = BlockParallelCodec(spec, block_size=block, device=device,
                                   stage_times=dec_stages[route],
                                   pass2=route)
        if codec.decode(container) != data:
            raise AssertionError(f"{label}: staged {route} round trip differs")
    d2h_line(label, data, device)
    # End to end, each run with its own launch counts.
    t_enc, container2, l_enc = timed_run(
        lambda: BlockParallelCodec(spec, block_size=block,
                                   device=device).encode(data),
        {"encode_parse": 1}, f"{label} encode")
    launches = [l_enc]
    t_dec = {}
    device_route = {"decode_pass1": 1, "word_ends": 1, "decode_pass2": 1,
                    "apply_words": 0, "decode_blocks": 0}
    # "auto" on the card takes the device route for these strict blocks.
    for route, expect in (
            ("host", {"decode_pass1": 1, "word_ends": 0, "decode_pass2": 0,
                      "apply_words": 1}),
            ("device", device_route), ("auto", device_route)):
        codec = BlockParallelCodec(spec, block_size=block, device=device,
                                   pass2=route)
        t_dec[route], out, lc = timed_run(
            lambda: codec.decode(container2), expect, f"{label} {route}")
        if route != "auto":
            launches.append(lc)
        if out != data:
            k = next(i for i, (a, b) in enumerate(zip(out, data)) if a != b)
            raise AssertionError(
                f"{label}: {route} round trip differs at byte {k}")
    if container2 != container:
        raise AssertionError(f"{label}: two encodes differ")
    _, payloads = framing.parse_frame(container)
    native = get_runtime().encode_blocks(data, spec, block)
    if len(native) != len(payloads):
        raise AssertionError(f"{label}: block count differs from native")
    bad = [i for i, (a, b) in enumerate(zip(payloads, native))
           if bytes(a) != b]
    if bad:
        raise AssertionError(
            f"{label}: {len(bad)} payloads differ from the native encoder, "
            f"first block {bad[0]}"
        )
    ratio = len(container) / size
    say("slice", f"{label}: {mib:.0f} MiB in {size // block} blocks of "
        f"{block} B, ratio {ratio:.4f}; payloads == native encoder, round "
        f"trip exact on every route; launches encode {l_enc}, host decode "
        f"{launches[1]}, device decode {launches[2]} (no native call); "
        "auto took the device route")
    say("slice", f"{label}: end to end encode {mib / t_enc:.1f} MiB/s "
        f"({t_enc * 1e3:.1f} ms), decode "
        + ", ".join(f"{r} {mib / t:.1f} MiB/s ({t * 1e3:.1f} ms)"
                    for r, t in t_dec.items()))
    stage_line(label, "encode", enc_stages, mib)
    for route in routes:
        stage_line(label, f"decode {route}", dec_stages[route], mib)
    return launches


def run_nonstrict(spec, data: bytes, block: int, label: str,
                  device="cuda:0"):
    """Decode a container of foreign early-CLEAR streams with
    ``pass2="device"`` and ``"auto"``; checks it against the input and the
    native runtime, and the decode kernels against their plain versions at
    the sub-streams' shape.  Returns the device decode's launch counts."""
    import numpy as np
    import torch

    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.kernels.nonstrict import split_substreams
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing
    from lzw_tpu_torch.utils.testdata import spliced_nonstrict_stream

    payloads = [spliced_nonstrict_stream(data[i : i + block], spec, 2000,
                                         device=device)
                for i in range(0, len(data), block)]
    container = framing.pack_frame(spec, block, len(data), payloads)
    stages: dict[str, float] = {}
    codec = BlockParallelCodec(spec, block_size=block, device=device,
                               stage_times=stages, pass2="device")
    if codec.decode(container) != data:
        raise AssertionError(f"{label}: staged decode differs")
    codec = BlockParallelCodec(spec, block_size=block, device=device,
                               pass2="device")
    t_dev, out, launches = timed_run(
        lambda: codec.decode(container),
        {"decode_pass1": 1, "word_ends": 1, "decode_pass2": 1,
         "apply_words": 0, "decode_blocks": 0}, label)
    # "auto" on the card leaves non-strict blocks to the native runtime.
    codec = BlockParallelCodec(spec, block_size=block, device=device)
    t_auto, out_auto, _ = timed_run(
        lambda: codec.decode(container),
        {"decode_blocks": 1, "apply_words": 0}, f"{label} auto")
    t0 = time.perf_counter()
    native = get_runtime().decode_blocks(payloads, spec, block)
    t_nat = time.perf_counter() - t0
    if out != data or native != data or out_auto != data:
        raise AssertionError(
            f"{label}: device decode == input {out == data}, auto == input "
            f"{out_auto == data}, native == input {native == data}")
    mib = len(data) / MiB
    say("slice", f"{label}: {mib:.0f} MiB in {len(payloads)} blocks of "
        f"{block} B, early CLEAR every 2000 B; device and auto decode == "
        f"input == native decode_blocks; device launches {launches} (no "
        "native call); auto called decode_blocks")
    say("slice", f"{label}: end to end decode device {mib / t_dev:.1f} MiB/s "
        f"({t_dev * 1e3:.1f} ms), auto {mib / t_auto:.1f} MiB/s "
        f"({t_auto * 1e3:.1f} ms), native decode_blocks {mib / t_nat:.1f} "
        f"MiB/s ({t_nat * 1e3:.1f} ms)")
    stage_line(label, "decode device", stages, mib)

    # The decode kernels at the sub-streams' shape: the device route's
    # codes, counts and schedule rows (pass 2 writes block-wide rows here,
    # the route only as wide as the longest sub-stream).
    mat = np.zeros((len(payloads), max(map(len, payloads))), np.uint8)
    plens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    dense, cnt, _, sched_arr = split_substreams(mat, plens, spec)
    res, dec, _ = compare_decode(
        spec, torch.from_numpy(dense).to(device),
        torch.from_numpy(cnt.astype(np.int32)).to(device), block,
        torch.from_numpy(sched_arr).to(device), f"{label} sub-streams")
    if int(dec[1].sum()) != len(data):
        raise AssertionError(f"{label} sub-streams: pass-1 totals sum to "
                             f"{int(dec[1].sum())}, not {len(data)}")
    say("kernels", f"{label} sub-streams: U={dense.shape[0]} S="
        f"{dense.shape[1]} B={block} bytes={int(dec[1].sum())}; "
        + kernel_times(res) + ", kernel == plain exactly")
    return launches


def run_stride1(spec, data: bytes, block: int, label: str,
                device="cuda:0"):
    """The all-device decode of a container's payloads with ``stride2=False``
    beside the default ``stride2=True``, in turns (2, 1, 1, 2), each run
    counted to launch its own walk and no native call and its bytes checked
    against the input; then the stride-1 walk against its plain version at
    this shape, on the kernel's own stride-1 rows for a variable spec, and
    for fixed-12 also the stride-1 rows against theirs; last the kernel
    times of pass 1 by row kind and of both walks.

    Returns (the four runs' launch counts, {kernel: Result})."""
    import numpy as np
    import torch

    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.kernels import decode as tdec
    from lzw_tpu_torch.parallel import framing
    from lzw_tpu_torch.spec import Endianness
    from lzw_tpu_torch.utils.card import cuda_ms

    container = BlockParallelCodec(spec, block_size=block,
                                   device=device).encode(data)
    _, payloads = framing.parse_frame(container)
    width = max(map(len, payloads))
    if not spec.variable:
        width = -(-width // 3) * 3
    mat = np.zeros((len(payloads), width), np.uint8)
    plens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    want = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    little = spec.endianness is Endianness.LITTLE
    mat_t = torch.from_numpy(mat).to(device)
    plens_t = torch.from_numpy(plens).to(device)

    def decode(stride2: bool):
        if spec.variable:
            return tdec.decode_variable_all_device(
                mat, plens, spec, block, device, stride2=stride2, flat=True)
        return tdec.decode_fixed_all_device(mat_t, plens_t, block, little,
                                            stride2=stride2, flat=True)

    secs = {True: [], False: []}
    launches = []
    for stride2 in (True, False, False, True):
        walk = "decode_pass2" if stride2 else "decode_pass2_stride1"
        other = "decode_pass2_stride1" if stride2 else "decode_pass2"
        dt, out, lc = timed_run(
            lambda s2=stride2: decode(s2),
            {"decode_pass1": 1, "word_ends": 1, walk: 1, other: 0,
             "apply_words": 0, "decode_blocks": 0},
            f"{label} stride2={stride2}")
        if int(out[2].abs().sum()) or (spec.variable and not out[4].all()):
            raise AssertionError(f"{label} stride2={stride2}: pass-1 error "
                                 "flags or non-strict blocks")
        if not torch.equal(out[0], want):
            raise AssertionError(
                f"{label} stride2={stride2}: bytes differ from the input")
        secs[stride2].append(dt)
        launches.append(lc)
    mib = len(data) / MiB
    say("stride1", f"{label}: {mib:.0f} MiB in {len(payloads)} blocks of "
        f"{block} B; bytes == input on both routes; stride-1 launches "
        f"{launches[1]} (no native call)")
    say("stride1", f"{label}: end to end all-device decode of the payload "
        "matrix (" + ("host count recovery, H2D, unpack, " if spec.variable
                      else "unpack, ")
        + "passes; output left on the device), MiB/s in run order: stride-2 "
        + ", ".join(f"{mib / t:.1f} ({t * 1e3:.1f} ms)" for t in secs[True])
        + "; stride-1 "
        + ", ".join(f"{mib / t:.1f} ({t * 1e3:.1f} ms)"
                    for t in secs[False]))

    # The kernels at this shape (not counted as launches).
    if spec.variable:
        p1 = tdec.variable_pass1(mat, plens, spec, block, device,
                                 rows="stride1")
        codes, n_codes, sched_t = p1.dense, p1.counts_t, p1.sched
        res, dec, _ = compare_decode(
            spec, codes, n_codes, block, sched_t, label, stride2=False,
            pass1=(p1.words, p1.totals, p1.err, p1.err_code, p1.pair))
    else:
        codes, n_codes = tdec.unpack12(mat_t, plens_t, little)
        codes, sched_t = codes.contiguous(), None
        res, dec, _ = compare_decode(spec, codes, n_codes, block, sched_t,
                                     label, stride2=False)
    times = {rows: cuda_ms(lambda r=rows: tdec.decode_pass1(
        codes, n_codes, spec, block, sched_t, rows=r))
        for rows in tdec.ROW_KINDS}
    pair2 = tdec.decode_pass1(codes, n_codes, spec, block, sched_t,
                              rows="stride2")[4]
    words, pair1 = dec[0], dec[4]
    vspec, totals = (spec if spec.variable else None), dec[1]
    times["flat walk stride-2"] = cuda_ms(
        lambda: tdec.decode_pass2_stride2_flat(
            codes, words, pair2, n_codes, totals, block, vspec, sched_t))
    times["flat walk stride-1"] = cuda_ms(
        lambda: tdec.decode_pass2_device_flat(
            codes, words, pair1, n_codes, totals, block, vspec, sched_t))
    times["scan word_ends"] = cuda_ms(
        lambda: tdec.word_ends(words, n_codes, block))
    times["plain scan _word_ends"] = cuda_ms(
        lambda: tdec._word_ends(words, n_codes, block))
    say("kernels", f"{label}: N={codes.shape[0]} S={codes.shape[1]}; "
        + kernel_times(res) + ", kernel == plain exactly; kernel ms by "
        "CUDA events: pass 1 rows "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return launches, res


def launch_path_us(tab, idx, idx64, calls: int = 2000) -> dict[str, float]:
    """Host microseconds a call of P4-b's wrapper (``probe.gather_lanes``)
    and of each piece of its launch path, by the host clock over ``calls``
    calls each (the launches only enqueue), beside ``torch.gather``."""
    import torch

    from lzw_tpu_torch.kernels import build, probe

    dev = tab.device
    out = torch.empty_like(idx)
    fn = build.bound("probe_gather", "gather_lanes_launch")
    handle = build.stream(dev)
    ptrs = (tab.data_ptr(), idx.data_ptr(), out.data_ptr())
    pieces = {
        "wrapper": lambda: probe.gather_lanes(tab, idx),
        "torch.gather": lambda: torch.gather(tab, 0, idx64),
        "checks": lambda: probe._check_gather(tab, idx),
        "output": lambda: torch.empty_like(idx),
        "on_device": lambda: build.on_device(dev).__enter__(),
        "stream": lambda: build.stream(dev),
        "bound": lambda: build.bound("probe_gather", "gather_lanes_launch"),
        "ctypes launch": lambda: fn(*ptrs, tab.shape[0], tab.shape[1],
                                    idx.numel(), handle),
        "check_launch": lambda: build.check_launch("probe_gather", 0),
    }
    res = {}
    counted = build.LAUNCHES["probe_gather"]
    for name, piece in pieces.items():
        piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            piece()
        res[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    build.LAUNCHES["probe_gather"] = counted  # these calls are no launches
    return res


def run_probes(device):
    """Phase 8: the four probe CLIs as a user runs them, at the JAX
    scripts' shapes, counted to launch each probe kernel; every gather must
    be right and the sweep's time must follow its step count.  Then each
    probe kernel against its plain version on the same inputs, every
    variant (P1 on the script's x and on x + 4, P2 on
    ``ablate2.ring_cases``); P1's and P2's times beside their chain floor
    (4096 steps of one dependent shared load, timed here by
    ``chain_probe``); P4-a and P4-b beside the library calls that compute
    them, in turns (kernel, library, library, kernel), and each launch
    alone: 20 launches captured in one CUDA graph and replayed, so the
    device's time stands apart from the host's launch path.

    Returns (the launch counts, {kernel: Result}); each kernel's Result is
    that of the variant named in its source's note: P1 ``scan``, P2
    ``ring``, P3 int32 at T = 512, P4-b."""
    import numpy as np
    import torch

    from lzw_tpu_torch.kernels import ablate, probe
    from lzw_tpu_torch.scripts import (ablate2, ablate_kernel, chain_probe,
                                       probe_gpu, probe_i16)
    from lzw_tpu_torch.utils.card import cuda_ms

    def drive():
        p1 = ablate_kernel.main(["all"])
        p2 = ablate2.main([])
        p3 = {512: probe_i16.main([])}
        p3[256] = {str(dt).removeprefix("torch."): probe_i16.run(dt, 256)
                   for dt in (torch.int32, torch.int16)}
        return p1, p2, p3, probe_gpu.main(["all"])

    _, (p1, p2, p3, p4), launches = timed_run(
        drive, {name: 1 for name in PROBE_KERNELS}, "probes")
    if not (p4["a"] and p4["b"][0] and all(p4["b3"].values())):
        raise AssertionError(f"probe_gpu: a probe is WRONG: {p4}")
    for dt, ms in p3[512].items():
        # At half the steps a sweep that really runs takes about half the
        # time; one the compiler removed would not.  The int16 sweep at
        # T=256 has read 0.12-0.17 ms on one card, so a ratio below the
        # limit is timed again, three more times a side, best kept.
        t256 = p3[256][dt]
        if ms < 1.3 * t256:
            again = {t: min(probe_i16.run(getattr(torch, dt), t)
                            for _ in range(3)) for t in (512, 256)}
            ms, t256 = min(ms, again[512]), min(t256, again[256])
        if ms < 1.3 * t256:
            raise AssertionError(
                f"probe_scan {dt}: {ms:.4f} ms at T=512, {t256:.4f} "
                "ms at T=256: the time does not follow the steps")

    res, errs = {}, {}
    x = ablate_kernel.make_input(device)
    for v in ablate_kernel.ORIG + ablate_kernel.GRID:
        for tag, xi in (("", x), (" x+4", x + 4)):
            got = ablate.ablate_parse(xi, v)
            plain_ms, ref = once_ms(
                lambda: ablate.ablate_parse_reference(xi, v))
            errs[f"P1 {v}{tag}"] = max_abs_err((got,), (ref,))
            if v == "scan" and not tag:
                res["ablate_parse"] = result(
                    errs[f"P1 {v}"], p1[v][0], plain_ms, 8 * x.numel(),
                    8 * x.numel())
    # P2 on the script's x ("random") and on inputs that hit the ring, at
    # other cells and rings, near 2**23 and on lanes no multiple of 8; each
    # case's ring variant timed too.
    ring_ms = {}
    cases = ablate2.ring_cases(ablate2.STEPS, 8 * 128, 1000)
    for case, (x, cell, ring) in cases.items():
        x = torch.from_numpy(x).to(device)
        for v in ablate2.VARIANTS:
            got = ablate.ablate_ring(x, v, cell=cell, ring=ring)
            plain_ms, ref = once_ms(lambda: ablate.ablate_ring_reference(
                x, v, cell=cell, ring=ring))
            errs[f"P2 {v} {case}"] = max_abs_err((got,), (ref,))
            if v == "ring" and case == "random":
                # A key sits in at most one ring row at a time (it is
                # written only after a miss), so the function needs one
                # lookup per lane and step: its bound is its bytes.
                res["ablate_ring"] = result(
                    errs[f"P2 ring {case}"], p2[v][0], plain_ms,
                    8 * x.numel(), 8 * x.numel())
        ring_ms[case] = cuda_ms(lambda: ablate.ablate_ring(
            x, "ring", cell=cell, ring=ring), 3)
    for t in (512, 256):
        for dt in (torch.int32, torch.int16):
            x = probe_i16.make_input(dt, device, t)
            got = probe.probe_scan(x, rows=probe_i16.S)
            plain_ms, ref = once_ms(
                lambda: probe.probe_scan_reference(x, rows=probe_i16.S))
            name = str(dt).removeprefix("torch.")
            errs[f"P3 {name} T={t}"] = max_abs_err((got,), (ref,))
            # The script's zero fill gives 0 whatever the sweep computes;
            # at 998 a column is 998 where a step's value (1-999) exceeds
            # it and 0 elsewhere, both common at these T.
            got = probe.probe_scan(x, rows=probe_i16.S, fill=998)
            ref = probe.probe_scan_reference(x, rows=probe_i16.S, fill=998)
            errs[f"P3 {name} T={t} fill 998"] = max_abs_err((got,), (ref,))
            if not 0 < int((ref == 998).sum()) < ref.numel():
                raise AssertionError(f"P3 {name} T={t}: fill 998 shows no "
                                     "mix of 998 and 0")
            if t == 512 and dt == torch.int32:
                res["probe_scan"] = result(
                    errs[f"P3 {name} T={t}"], p3[t][name], plain_ms,
                    x.numel() * 4 + got.numel() * 4,
                    3 * t * probe_i16.S * x[0, 0].numel())
    x = torch.arange(8 * 128, dtype=torch.int32, device=device).reshape(
        8, 128)
    errs["P4-a"] = max_abs_err((probe.affine(x),),
                               (probe.affine_reference(x),))
    rng = np.random.default_rng(0)
    for height in (8192, *probe_gpu.HEIGHTS):
        tab, idx = probe_gpu.gather_inputs(height, 128, rng)
        got = probe.gather_lanes(tab, idx)
        plain_ms, ref = once_ms(lambda: probe.gather_lanes_reference(tab, idx))
        errs[f"P4-b H={height}"] = max_abs_err((got,), (ref,))
        if height == 8192:
            b_tab, b_idx, b_plain_ms = tab, idx, plain_ms
            got = probe.gather_loop(tab, idx)
            loop_plain_ms, ref = once_ms(
                lambda: probe.gather_loop_reference(tab, idx))
            errs["P4-b2"] = max_abs_err((got,), (ref,))
            # The slope between two chain lengths leaves out the launch.
            chain_ms = {n: cuda_ms(lambda n=n: probe.gather_loop(tab, idx, n),
                                   20) for n in (256, 4096)}
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise AssertionError(f"probes: kernel != plain, max_abs_err {bad}")
    idx64 = b_idx.long()
    calls = {"P4-a": lambda: probe.affine(x), "x * 2 + 1": lambda: x * 2 + 1,
             "P4-b": lambda: probe.gather_lanes(b_tab, b_idx),
             "torch.gather": lambda: torch.gather(b_tab, 0, idx64)}
    turns = {name: [] for name in calls}
    for a, b in (("P4-a", "x * 2 + 1"), ("P4-b", "torch.gather")):
        for name in (a, b, b, a):
            turns[name].append(cuda_ms(calls[name], 200))
    alone = {name: graph_ms(fn) for name, fn in calls.items()}
    path = launch_path_us(b_tab, b_idx, idx64)
    res["probe_gather"] = result(
        errs["P4-b H=8192"], sum(turns["P4-b"]) / 2, b_plain_ms,
        3 * 4 * b_idx.numel(), b_idx.numel(),
        sum(turns["torch.gather"]) / 2)
    host, start = chain_probe.table("load")
    steps = 1 << 20
    load_ns = cuda_ms(lambda: probe.chain_steps(
        torch.from_numpy(host).to(device), start, "load", 1, steps),
        1) * 1e6 / steps
    floor_ms = ablate_kernel.STEPS * load_ns / 1e6
    say("probes", "every probe kernel == its plain version (max_abs_err 0): "
        + ", ".join(errs) + f"; launches {launches}")
    say("probes", "P1 ablate_parse ms by variant (G=2 B=4096 x 128 lanes) "
        "[ns a step]: " + ", ".join(
            f"{v} {ms:.4f} [{ms * 1e6 / ablate_kernel.STEPS:.1f}]"
            for v, (ms, _) in p1.items())
        + f"; chain floor {floor_ms:.4f} ms ({ablate_kernel.STEPS} steps x "
        f"{load_ns:.2f} ns a dependent shared load); bytes bound "
        f"{res['ablate_parse'].bound_ms:.5f} ms"
        + "; P2 ablate_ring ms (4096 steps x 1024 lanes, cell 512) [ns a "
        "step]: " + ", ".join(
            f"{v} {ms:.4f} [{ms * 1e6 / ablate2.STEPS:.1f}]"
            for v, (ms, _) in p2.items())
        + f"; the same chain floor {ablate2.STEPS * load_ns / 1e6:.4f} ms; "
        f"bytes bound {res['ablate_ring'].bound_ms:.5f} ms; ring by case "
        "(cell, ring): " + ", ".join(
            f"{case} ({cases[case][1]}, {cases[case][2]}) {ms:.4f}"
            for case, ms in ring_ms.items()))
    say("probes", "P3 probe_scan best ms: " + ", ".join(
        f"{dt} T={t} {ms:.4f}" for t, by in p3.items()
        for dt, ms in by.items())
        + f"; int32/int16 at T=512 {p3[512]['int32'] / p3[512]['int16']:.3f}")
    say("probes", "P4 ms a call by CUDA events over 200 calls, in turns "
        "[alone: 20 launches in one CUDA graph]: " + ", ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
            + f" [{alone[name]:.4f}]" for name, ts in turns.items())
        + "; P4-b's launch path, host us a call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in path.items())
        + f"; P4-b2 {p4['b2']:.1f} ns per dependent gather of "
        f"128 (256 in a chain, plain {loop_plain_ms:.1f} ms), "
        f"{(chain_ms[4096] - chain_ms[256]) / 3840 * 1e6:.1f} ns per "
        f"dependent gather between chains of 256 ({chain_ms[256]:.4f} ms) "
        f"and 4096 ({chain_ms[4096]:.4f} ms); P4-b3 every height OK")
    say("kernels", "probes at the scripts' shapes: " + kernel_times(res))
    return launches, res


def corrupt_stream(spec, bad_code: int) -> bytes:
    """A strict one-block stream whose sixth code is ``bad_code``, past the
    decoder's next index: pass 1 reports exactly that code."""
    from lzw_tpu_torch.ops import reference as oracle

    codes = oracle.encode_codes(bytes((i * 7) % 40 for i in range(300)), spec)
    k = 6 if spec.variable else 5  # after the leading CLEAR, if any
    codes[k] = (bad_code, codes[k][1])
    return oracle.pack_codes(codes, spec.endianness)


def run_split(spec, data: bytes, block: int, label: str, lists):
    """Phase 9: the container over each device list of ``lists`` beside one
    device (cuda:0), every codec warmed up once, then counted runs in turns
    (one device, the lists, the lists again, one device): payloads equal to
    one device's container, a round trip on every ``pass2`` route, each
    run's launch and native-call counts exactly its ranges times one
    device's, none on the device route; then a corrupt block in the second
    range of the last list raises its own code, and with one in the first
    range too, the first one's.  Returns (the counted runs' launch counts,
    one device's container)."""
    from lzw_tpu_torch import BlockParallelCodec, UnexpectedCodeError
    from lzw_tpu_torch.kernels import build
    from lzw_tpu_torch.parallel import framing

    routes = ("host", "device", "auto")
    device_route = {"decode_pass1": 1, "word_ends": 1, "decode_pass2": 1,
                    "apply_words": 0, "decode_blocks": 0}
    expect = {"encode": {"encode_parse": 1},
              "host": {"decode_pass1": 1, "word_ends": 0, "decode_pass2": 0,
                       "apply_words": 1, "decode_blocks": 0},
              "device": device_route, "auto": device_route}
    configs = {"cuda:0": ["cuda:0"]}
    configs.update({",".join(map(str, devs)): devs for devs in lists})
    codecs = {name: {r: BlockParallelCodec(spec, block_size=block,
                                           device=devs, pass2=r)
                     for r in routes} for name, devs in configs.items()}
    for by_route in codecs.values():
        by_route["auto"].decode(by_route["auto"].encode(data))
    n_blocks = -(-len(data) // block)
    secs = {name: {step: [] for step in ("encode", *routes)}
            for name in codecs}
    counts = {}
    launches = []
    one_container = None

    def counted(name, step, fn):
        dt, out, lc = timed_run(fn, expect[step], f"{label} {name} {step}")
        got = {**{k: lc[k] for k in build.KERNELS}, **HOST_CALLS}
        ranges = len(codecs[name]["auto"]._ranges(n_blocks))
        want = {k: v * ranges for k, v in counts["cuda:0", step].items()} if (
            ("cuda:0", step) in counts) else got
        if got != want:
            raise AssertionError(f"{label} {name} {step}: counts {got}, "
                                 f"expected {ranges} x one device's {want}")
        counts.setdefault((name, step), got)
        secs[name][step].append(dt)
        launches.append(lc)
        return out

    for name in [*codecs, *reversed(codecs)]:
        by_route = codecs[name]
        container = counted(name, "encode",
                            lambda c=by_route["auto"]: c.encode(data))
        one_container = one_container or container
        if container != one_container:
            raise AssertionError(f"{label} {name}: payloads differ from one "
                                 "device's container")
        for r in routes:
            out = counted(name, r, lambda c=by_route[r]: c.decode(container))
            if out != data:
                raise AssertionError(f"{label} {name} {r}: round trip differs")

    # Where a device-route decode's time goes, each stage synchronised
    # (with several devices, per device; the ranges' D2H and their join
    # into the result are dec_d2h_out).
    mib = len(data) / MiB
    for name, devs in configs.items():
        stages: dict[str, float] = {}
        BlockParallelCodec(spec, block_size=block, device=devs,
                           pass2="device", stage_times=stages).decode(
            one_container)
        stage_line(f"{label} over {name}", "decode device", stages, mib)

    # A corrupt block in the second range, then one in the first as well.
    name = list(configs)[-1]
    ranges = codecs[name]["auto"]._ranges(n_blocks)
    if len(ranges) < 2:
        raise AssertionError(f"{label} {name}: one range only")
    _, payloads = framing.parse_frame(one_container)
    payloads = [bytes(p) for p in payloads]
    bad = (250, 251) if spec.variable else (4000, 4001)
    payloads[ranges[1].lo + 3] = corrupt_stream(spec, bad[1])
    for corrupt, code in (({}, bad[1]), ({5: bad[0]}, bad[0])):
        for i, c in corrupt.items():
            payloads[i] = corrupt_stream(spec, c)
        frame = framing.pack_frame(spec, block, len(data), payloads)
        for r in ("host", "device"):
            try:
                codecs[name][r].decode(frame)
            except UnexpectedCodeError as exc:
                if exc.code != code:
                    raise AssertionError(f"{label} {name} {r}: raised code "
                                         f"{exc.code}, expected {code}")
            else:
                raise AssertionError(f"{label} {name} {r}: corrupt block "
                                     "decoded")

    for name in codecs:
        n_ranges = len(codecs[name]["auto"]._ranges(n_blocks))
        say("split", f"{label} over {name}: {mib:.0f} MiB, {n_ranges} "
            "range(s); payloads == one device's container, round trip exact "
            "on every route, counts == ranges x one device's exactly, no "
            "native call on the device route; counts per run: " + "; ".join(
                f"{step} " + ", ".join(
                    f"{k} {v}" for k, v in counts[name, step].items() if v)
                for step in secs[name]) + "; MiB/s in run order: " + "; ".join(
                f"{step} " + ", ".join(f"{mib / t:.1f}" for t in ts)
                for step, ts in secs[name].items()))
    say("split", f"{label} over {name}: a corrupt block in range 2 raised "
        f"its code {bad[1]}, and with one in range 1 as well, range 1's "
        f"{bad[0]} (host and device routes)")
    return launches, one_container


def multihost_worker(argv) -> int:
    """One rank of phase 10 (``chip_smoke.py --multihost-worker BACKEND
    WORLD RANK PORT``): MultiHostBlockCodec over the group on
    cuda:(rank % device count), the 128 MiB gif7 image through ``encode``,
    ``encode_shards`` (this rank's half) and ``decode``, each step timed
    between barriers; prints one ``RESULT {json}`` line."""
    backend, world, rank, port = argv[0], *map(int, argv[1:4])
    sys.path.insert(0, str(ROOT))
    import hashlib

    import torch
    import torch.distributed as dist

    from lzw_tpu_torch import BlockParallelCodec, LzwSpec
    from lzw_tpu_torch.kernels import build
    from lzw_tpu_torch.parallel import MultiHostBlockCodec, multihost
    from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

    dev = rank % torch.cuda.device_count()
    torch.cuda.set_device(dev)
    multihost.initialize(backend=backend,
                         init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
    spec, bs = LzwSpec.gif(7), 1 << 16
    tokyo = load_tokyo_pixels(ROOT / "test-assets" / "tokyo_128_colors.png")
    data = tile(tokyo, 128 * MiB)
    codec = MultiHostBlockCodec(spec, bs, local_codec=BlockParallelCodec(
        spec, bs, device=f"cuda:{dev}"))
    small = data[: 4 * MiB]  # warm-up: kernel modules, pinned memory
    codec.decode(codec.encode(small))
    lo, hi = multihost._process_slice(-(-len(data) // bs), rank, world)
    shard = data[lo * bs : hi * bs]
    build.reset_counts()
    secs = {}

    def step(name, fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    container = step("encode", lambda: codec.encode(data))
    sharded = step("encode_shards",
                   lambda: codec.encode_shards(shard, len(data)))
    out = step("decode", lambda: codec.decode(container))
    launches = dict(build.LAUNCHES)
    dist.barrier()
    dist.destroy_process_group()
    print("RESULT " + json.dumps({
        "rank": rank, "device": f"cuda:{dev}", "secs": secs,
        "container": hashlib.sha256(container).hexdigest(),
        "sharded": hashlib.sha256(sharded).hexdigest(),
        "round_trip": out == data, "launches": launches}), flush=True)
    return 0


def run_multihost(want_digest: str) -> list[dict]:
    """Phase 10: two processes on ``gloo`` (and on ``nccl`` with two GPUs or
    more) run :func:`multihost_worker`; every rank's container and sharded
    container must be the one-process container (``want_digest``), its
    round trip exact and its launches one range's.  Returns the ranks'
    launch counts."""
    import socket
    import subprocess

    import torch

    n_gpu = torch.cuda.device_count()
    backends = ["gloo"] + (["nccl"] if n_gpu >= 2 else [])
    per_rank = {"encode_parse": 2, "decode_pass1": 1, "word_ends": 1,
                "decode_pass2": 1}
    launches = []
    for backend in backends:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
             backend, "2", str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT)) for rank in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        results = []
        for rank, (p, out) in enumerate(zip(procs, outs)):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"multihost {backend} rank {rank} "
                                     f"failed:\n{out[-3000:]}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
        for r in results:
            got = {k: r["launches"][k] for k in per_rank}
            if not (r["container"] == r["sharded"] == want_digest
                    and r["round_trip"] and got == per_rank):
                raise AssertionError(f"multihost {backend}: {r}")
            launches.append(r["launches"])
        say("multihost", f"{backend}, 2 ranks on "
            + ", ".join(r["device"] for r in results)
            + ": 128 MiB gif7 image, containers of encode and encode_shards "
            "identical across ranks and == the one-process container, round "
            f"trip exact, launches one range's each; wall {wall:.1f} s with "
            "the processes' start; per rank s (encode, encode_shards, "
            "decode): " + "; ".join(
                ", ".join(f"{r['secs'][k]:.3f}" for k in
                          ("encode", "encode_shards", "decode"))
                for r in results))
    if n_gpu < 2:
        say("multihost", f"nccl not run: {n_gpu} GPU visible, and NCCL "
            "refuses two ranks on one GPU")
    return launches


def run_facades(image: bytes) -> None:
    """Phase 11: the single-stream facades on the native runtime, on the
    host: the golden file, bytes and stream round trips of 16 MiB of the
    image plane for gif7, TIFF and fixed-12 (both endiannesses), and the
    reference's corrupt TIFF stream."""
    import io

    from lzw_tpu_torch import (
        Endianness, FixedCodec, GifCodec, TiffCodec, UnexpectedCodeError,
    )

    lorem = (ROOT / "test-assets" / "lorem_ipsum.txt").read_bytes()
    golden = (ROOT / "test-assets" / "lorem_ipsum_encoded.bin").read_bytes()
    auto = GifCodec(7)
    if auto.backend != "native" or auto.encode(lorem) != golden or (
            auto.decode(golden) != lorem):
        raise AssertionError("GifCodec(7) does not give the golden file back")
    data = image[: 16 * MiB]
    mib = len(data) / MiB
    rates = []
    for label, codec in (
            ("gif7", GifCodec(7, backend="native")),
            ("tiff", TiffCodec(backend="native")),
            ("fixed-12 LE", FixedCodec(Endianness.LITTLE, backend="native")),
            ("fixed-12 BE", FixedCodec(Endianness.BIG, backend="native"))):
        t = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            t[name] = time.perf_counter() - t0
            return out

        enc = timed("encode", lambda: codec.encode(data))
        dec = timed("decode", lambda: codec.decode(enc))
        dst = io.BytesIO()
        timed("encode_stream", lambda: codec.encode_stream(io.BytesIO(data),
                                                           dst))
        out = io.BytesIO()
        timed("decode_stream", lambda: codec.decode_stream(
            io.BytesIO(dst.getvalue()), out))
        if dec != data or dst.getvalue() != enc or out.getvalue() != data:
            raise AssertionError(f"facade {label}: a round trip differs")
        rates.append(f"{label} (ratio {len(enc) / len(data):.4f}) "
                     + ", ".join(f"{k} {mib / v:.1f}" for k, v in t.items()))
    try:
        TiffCodec(backend="native").decode(bytes(
            [0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60, 0x54]))
    except UnexpectedCodeError as exc:
        if exc.code != 258:
            raise AssertionError(f"corrupt TIFF: code {exc.code}, not 258")
    else:
        raise AssertionError("corrupt TIFF decoded")
    say("facades", "GifCodec(7) == the golden file both ways; bytes and "
        "stream round trips exact; corrupt TIFF raised code 258; host-runtime "
        f"MiB/s (native, one thread) on {mib:.0f} MiB: " + "; ".join(rates))


def run_entry() -> list[dict]:
    """Phase 12: ``entry()``'s step on the card against the native encoder
    on the same bytes, then ``dryrun_multichip`` over every visible GPU.
    Returns both runs' launch counts."""
    import torch

    from lzw_tpu_torch import Endianness, LzwSpec
    from lzw_tpu_torch.entry import dryrun_multichip, entry
    from lzw_tpu_torch.native.runtime import get_runtime

    fn, args = entry()
    _, (buf, n_bytes, err), l_entry = timed_run(
        lambda: fn(*args), {"encode_parse": 1, "decode_pass1": 0}, "entry")
    buf, n_bytes = buf.cpu().numpy(), n_bytes.cpu().numpy()
    native = get_runtime().encode_blocks(
        args[0].cpu().numpy().tobytes(), LzwSpec.fixed(Endianness.LITTLE),
        args[0].shape[1])
    if err.any() or [buf[i, : n_bytes[i]].tobytes()
                     for i in range(len(native))] != native:
        raise AssertionError("entry(): payloads differ from native "
                             "encode_blocks")
    n = torch.cuda.device_count()
    _, _, l_dry = timed_run(
        lambda: dryrun_multichip(n),
        {"encode_parse": 1, "decode_pass1": 1, "word_ends": 1,
         "decode_pass2": 1, "apply_words": 0}, "dryrun_multichip")
    say("entry", f"entry() on {args[0].device}: 4 x 4096 B == native "
        f"encode_blocks, launches {l_entry}; dryrun_multichip({n}) round "
        f"trips exact, launches {l_dry}")
    return [l_entry, l_dry]


def run_examples(tokyo: bytes) -> list[dict]:
    """Phase 13a: the two examples in-process, ``usage`` against the golden
    file and ``compress_image_data`` on cuda:0 with its round trip, its
    container equal to the native encoder's blocks.  Returns the launch
    counts of the second."""
    from lzw_tpu_torch import LzwSpec
    from lzw_tpu_torch.examples import compress_image_data, usage
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing

    n_lorem, n_golden = usage.run()
    _, out, launches = timed_run(
        lambda: compress_image_data.run(tokyo, "cuda:0"),
        {"encode_parse": 1, "decode_pass1": 1, "decode_pass2": 1},
        "compress_image_data")
    spec = LzwSpec.gif(7)
    native = framing.pack_frame(spec, out.block_size, len(tokyo),
                                get_runtime().encode_blocks(
                                    tokyo, spec, out.block_size))
    if out.container != native:
        raise AssertionError("compress_image_data: container differs from "
                             "the native encoder's blocks")
    say("examples", f"usage: {n_lorem} -> {n_golden} B == the golden file, "
        f"round trip exact; compress_image_data on cuda:0: {len(tokyo)} "
        f"pixels, single stream {len(out.single)} B, container "
        f"{len(out.container)} B ({out.n_devices} device, {out.block_size} "
        f"B blocks) == native blocks, round trip exact, launches {launches}")
    return [launches]


def predicted_peaks(spec, block: int, container: bytes) -> dict[str, int]:
    """Device bytes each operation adds at its peak, from the tensors that
    ``parallel/block.py`` and the kernels' wrappers hold at once; N blocks
    of B bytes, S the longest block's codes, P its payload bytes.

    Variable encode: blocks u8 NB and the parse's dense i32 N(B+1) stay
    while ``schedule.pack_variable`` scatters the data codes into its
    i64 N(Pe+3) buffer (Pe the packed width): the codes as i64 and, in
    ``ops.bitpack.scatter_symbols``, the byte offsets, the shifted codes,
    their three byte lanes and one lane's index, six more i64 [N, S].  Variable
    decode, every route: ``schedule.unpack_variable_device`` holds the
    payloads u8 NP, their i64 copy N(W+4) (W = max(P, the last code's
    byte + 3)), three gathered i64 [N, S] and three temporaries of
    the OR; pass 1 and the walk need less (dense, words, rows, ends i32
    [N, S] and the output).  Fixed encode: ``encode.pack12`` on the dense
    codes (N(B+1) i32, one zero column added by a copy) holds three i32
    byte planes and their stack (each [N, (B+2)/2, 3]) and the u8 result.
    Fixed decode: ``decode.unpack12`` holds the payloads u8 NP, their i32
    copy and 8/3 NP i32 of codes and temporaries (10.33 NP in all); the
    device route's walk holds the payloads, codes, words, pair rows and
    ends (8/3 NP each) and the flat output."""
    import numpy as np

    from lzw_tpu_torch.kernels.decode import prepare_variable_decode
    from lzw_tpu_torch.kernels.schedule import emission_schedule
    from lzw_tpu_torch.parallel import framing

    header, payloads = framing.parse_frame(container)
    n, size = len(payloads), header.orig_size
    p = max(len(x) for x in payloads)
    if spec.variable:
        mat = np.zeros((n, p), np.uint8)
        plens = np.array([len(x) for x in payloads], np.int32)
        for i, x in enumerate(payloads):
            mat[i, : len(x)] = np.frombuffer(x, np.uint8)
        s = prepare_variable_decode(mat, plens, spec)[3]
        sched = emission_schedule(spec, s)
        pe = (sched.total_bits(s) + 7) // 8 + 16
        w = max(p, int(sched.bit_off[s - 1] >> 3) + 3) + 4
        dec = n * p + 8 * n * w + 48 * n * s
        return {"encode": n * block + 4 * n * (block + 1)
                + 8 * n * (pe + 3) + 56 * n * s,
                "decode host": dec, "decode device": dec,
                "decode auto": dec}
    pf = (p + 2) // 3 * 3
    half = n * (block + 2) // 2  # codes in a pack12 byte plane
    host = round(n * pf * (5 + 16 / 3))
    device = max(host, round(n * pf * (1 + 4 * 8 / 3)) + size)
    return {"encode": n * block + 4 * n * (block + 1) + 4 * n * (block + 2)
            + 4 * 3 * half + 4 * 3 * half + 3 * half,
            "decode host": host, "decode device": device,
            "decode auto": device}


def run_memory(spec, data: bytes, block: int, label: str, smi: str,
               trace_dir: pathlib.Path | None = None) -> list[dict]:
    """Phase 13b: encode, then decode by ``pass2="host"``, ``"device"`` and
    ``"auto"``, each once on cuda:0 with the peak memory statistics reset
    just before it; prints each run's ``RunMetrics`` JSON and its peak
    from ``device_memory_report()`` beside the prediction.  With
    ``trace_dir`` the encode and the device-route decode each run under
    ``trace`` into a directory of their own, and each trace must hold the
    device events of its kernels.  Returns the launch counts."""
    import torch

    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.utils.profiling import (
        RunMetrics, device_memory_report, trace,
    )

    device_route = {"decode_pass1": 1, "word_ends": 1, "decode_pass2": 1,
                    "apply_words": 0, "decode_blocks": 0}
    runs = (("encode", "auto", {"encode_parse": 1},
             ("encode_parse_kernel",)),
            ("decode host", "host", {"decode_pass1": 1, "apply_words": 1,
                                     "decode_pass2": 0}, None),
            ("decode device", "device", device_route,
             ("decode_pass1_kernel", "word_ends_kernel",
              "decode_pass2_kernel")),
            ("decode auto", "auto", device_route, None))
    mib = len(data) / MiB
    container, predicted, launches = None, None, []
    for op, route, expect, kernels in runs:
        codec = BlockParallelCodec(spec, block_size=block, device="cuda:0",
                                   pass2=route)

        def fn():
            if op == "encode":
                return codec.encode(data)
            return codec.decode(container)

        traced = trace_dir is not None and kernels is not None
        where = None if not traced else trace_dir / op.replace(" ", "_")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = device_memory_report()["cuda:0"]["bytes_in_use"]
        if traced:
            with trace(where):
                dt, out, lc = timed_run(fn, expect, f"{label} {op}")
        else:
            dt, out, lc = timed_run(fn, expect, f"{label} {op}")
        mem = device_memory_report()["cuda:0"]
        launches.append(lc)
        if op == "encode":
            container = out
            predicted = predicted_peaks(spec, block, container)
            metrics = RunMetrics("encode", label, len(data), len(out), dt,
                                 -(-len(data) // block))
        else:
            if out != data:
                raise AssertionError(f"{label} {op}: round trip differs")
            metrics = RunMetrics("decode", label, len(container), len(out),
                                 dt, -(-len(data) // block))
        peak = mem["peak_bytes_in_use"]
        if not 0 < peak <= mem["bytes_limit"]:
            raise AssertionError(
                f"{label} {op}: peak {peak} B outside (0, "
                f"{mem['bytes_limit']}]")
        say("memory", f"{label} {mib:.0f} MiB {op}"
            f"{' (traced)' if traced else ''}: {metrics.to_json()}; "
            f"cuda:0 peak {peak / MiB:.1f} MiB (in use before "
            f"{before / MiB:.1f}, after {mem['bytes_in_use'] / MiB:.1f}; "
            f"the operation's own {(peak - before) / MiB:.1f}, predicted "
            f"{predicted[op] / MiB:.1f}); bytes_limit "
            f"{mem['bytes_limit'] / MiB:.1f} MiB; {smi}")
        if traced:
            trace_line(label, op, where, kernels, dt)
    return launches


def trace_line(label: str, op: str, where: pathlib.Path, kernels, dt: float):
    """Read the one trace file in ``where`` back; fail unless it holds a
    device kernel event named after each of ``kernels``; print the
    trace's total device-kernel time beside the operation's wall time."""
    files = list(where.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{label} {op}: {len(files)} trace files in "
                             f"{where}")
    events = json.loads(files[0].read_text())["traceEvents"]
    on_device = [e for e in events if e.get("cat") == "kernel"]
    missing = [k for k in kernels
               if not any(k in e.get("name", "") for e in on_device)]
    if missing:
        raise AssertionError(f"{label} {op}: the trace has no device event "
                             f"of {missing}")
    busy = sum(float(e.get("dur", 0)) for e in on_device) / 1e3
    say("trace", f"{label} {op}: {files[0].stat().st_size / MiB:.1f} MiB "
        f"trace, {len(on_device)} device kernel events, of them "
        + ", ".join(f"{k} {sum(k in e.get('name', '') for e in on_device)}"
                    for k in kernels)
        + f"; device-kernel time {busy:.2f} ms of {dt * 1e3:.1f} ms wall "
        f"({busy / (dt * 1e3):.3f})")


# The reference's crafted corrupt TIFF stream (`decoder.rs:758-769`).
CORRUPT_TIFF = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60,
                      0x54])


def stream_peak(spec, n_rows: int, m: int, out_bound: int) -> int:
    """Device bytes of ``ops.decode.decode_block`` on ``n_rows`` rows of
    ``m`` payload bytes: the payloads and lengths, pass 1's tables (three
    i32 [N, G]), words (three i32, a bool and the i16 wire code [N, S])
    and per-row results, pass 2's output u8 [N, out_bound] and its i64
    per-row key."""
    from lzw_tpu_torch.ops.decode import pass1_step_bound

    s = pass1_step_bound(m, spec)
    g = spec.alphabet_size + s + 2
    return n_rows * (m + 4 + 12 * g + 15 * s + 24 + out_bound + 8)


def error_streams(spec_var, spec_tiff) -> dict[str, tuple]:
    """(stream, spec) of each error the facades must raise alike: a
    truncated stream, a full table without a CLEAR, a code past the next
    index, and the reference's corrupt TIFF vector (code 258)."""
    from lzw_tpu_torch.ops import reference as oracle
    from lzw_tpu_torch.spec import Endianness, LzwSpec

    codes = [(0, 9)]
    width, next_index = 9, 258
    for _ in range(4096 - 258 + 2):
        codes.append((1, width))
        next_index += 1
        if next_index == (1 << width) and width < 12:
            width += 1
    missing = oracle.pack_codes(codes, Endianness.LITTLE)
    good = oracle.encode_bytes(bytes(range(128)) * 8, spec_var)
    # gif7: CLEAR, a literal, then 200 where the next index is 130.
    bad = oracle.pack_codes([(128, 8), (5, 8), (200, 8)], Endianness.LITTLE)
    return {"truncated": (good[: len(good) // 2], spec_var),
            "missing CLEAR": (missing, LzwSpec.variable(8,
                                                        Endianness.LITTLE)),
            "unexpected code": (bad, spec_var),
            "corrupt TIFF": (CORRUPT_TIFF, spec_tiff)}


def outcome(fn, *args):
    """("ok", bytes) or (error class name, its code)."""
    try:
        return "ok", fn(*args)
    except Exception as exc:  # compared by class and code
        return type(exc).__name__, getattr(exc, "code", None)


def run_stream_facades(image: bytes, smi: str, device,
                       size: int = 16 * MiB) -> dict[str, tuple]:
    """Phase 14a: the ``"torch"`` facades on ``device`` against
    ``"native"`` on ``size`` bytes (16 MiB) of the image plane (encode
    bytes equal, decode and stream round trips exact), the golden file
    both ways, the error streams (the same class and code as native), and
    each decode's peak memory beside :func:`stream_peak`.  Returns
    {flavor: (spec, encoded stream)}."""
    import io

    import torch

    from lzw_tpu_torch import (
        Endianness, FixedCodec, GifCodec, LzwCodec, LzwSpec, TiffCodec,
    )
    from lzw_tpu_torch.kernels import build

    lorem = (ROOT / "test-assets" / "lorem_ipsum.txt").read_bytes()
    golden = (ROOT / "test-assets" / "lorem_ipsum_encoded.bin").read_bytes()
    card = GifCodec(7, backend="torch", device=device)
    if card.encode(lorem) != golden or card.decode(golden) != lorem:
        raise AssertionError("torch GifCodec(7) does not give the golden "
                             "file back")
    data = image[:size]
    mib = len(data) / MiB
    rates, streams = [], {}
    for label, make in (
            ("gif7", lambda b, **kw: GifCodec(7, backend=b, **kw)),
            ("tiff", lambda b, **kw: TiffCodec(backend=b, **kw)),
            ("fixed-12 LE", lambda b, **kw: FixedCodec(
                Endianness.LITTLE, backend=b, **kw)),
            ("fixed-12 BE", lambda b, **kw: FixedCodec(
                Endianness.BIG, backend=b, **kw))):
        codec, native = make("torch", device=device), make("native")
        t = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
            return out

        before = dict(build.LAUNCHES)
        enc = timed("encode", lambda: codec.encode(data))
        ran = {k: build.LAUNCHES[k] - before[k]
               for k in ("stream_encode", "encode_parse")}
        if ran != {"stream_encode": 1, "encode_parse": 0}:
            raise AssertionError(f"torch {label} encode launched {ran}")
        if enc != native.encode(data):
            raise AssertionError(f"torch facade {label}: bytes != native")
        streams[label] = (codec.spec, enc)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        dec = timed("decode", lambda: codec.decode(enc))
        peak = torch.cuda.max_memory_allocated() - before
        dst = io.BytesIO()
        timed("encode_stream", lambda: codec.encode_stream(io.BytesIO(data),
                                                           dst))
        out = io.BytesIO()
        timed("decode_stream", lambda: codec.decode_stream(
            io.BytesIO(dst.getvalue()), out))
        if dec != data or dst.getvalue() != enc or out.getvalue() != data:
            raise AssertionError(f"torch facade {label}: a round trip "
                                 "differs")
        t0 = time.perf_counter()
        native.decode(enc)
        native_s = time.perf_counter() - t0
        rates.append(
            f"{label} (ratio {len(enc) / len(data):.4f}) "
            + ", ".join(f"{k} {mib / v:.2f}" for k, v in t.items())
            + f"; native decode {mib / native_s:.1f}; decode peak "
            f"{peak / MiB:.1f} MiB (predicted "
            f"{stream_peak(codec.spec, 1, len(enc), len(data)) / MiB:.1f})")
    errors = []
    for label, (stream, spec) in error_streams(LzwSpec.gif(7),
                                               LzwSpec.tiff()).items():
        got = outcome(LzwCodec(spec, "torch", device).decode, stream)
        want = outcome(LzwCodec(spec, "native").decode, stream)
        if got != want or got[0] == "ok":
            raise AssertionError(f"torch facade, {label}: {got} != native "
                                 f"{want}")
        errors.append(f"{label} {got[0]}" + (
            "" if got[1] is None else f" {got[1]}"))
    say("stream", f"torch facades on {device}: GifCodec(7) == the golden file "
        "both ways; bytes == native, bytes and stream round trips exact "
        f"on {mib:.0f} MiB; errors as native: {', '.join(errors)}; MiB/s: "
        + "; ".join(rates) + f"; {smi}")
    return streams


def run_stream_container(spec, data: bytes, block: int, label: str,
                         smi: str, device) -> tuple[list[dict], list[bytes]]:
    """Phase 14b: a container of blocks past ``MAX_BLOCK`` encoded on
    ``device`` (payloads == the native encoder's) and decoded with
    ``pass2="device"`` (the single-stream kernels, no native call): ==
    the input and == native ``decode_blocks``; MiB/s of each and the
    decode's peak memory beside :func:`stream_peak`.  Returns the launch
    counts of the encode and the decode, and the payloads."""
    import torch

    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing

    mib = len(data) / MiB
    rt = get_runtime()
    enc_s, container, l_enc = timed_run(
        lambda: BlockParallelCodec(spec, block_size=block,
                                   device=device).encode(data),
        {"encode_parse": 1}, f"{label} encode")
    _, payloads = framing.parse_frame(container)
    payloads = [bytes(p) for p in payloads]
    if payloads != rt.encode_blocks(data, spec, block):
        raise AssertionError(f"{label}: payloads != native encode_blocks")
    codec = BlockParallelCodec(spec, block_size=block, device=device,
                               pass2="device")
    codec.decode(container)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dec_s, out, l_dec = timed_run(
        lambda: codec.decode(container),
        {"stream_pass1": 1, "stream_pass2": 1, "decode_blocks": 0,
         "apply_words": 0, "decode_pass1": 0}, f"{label} decode")
    peak = torch.cuda.max_memory_allocated() - before
    stages = {}
    BlockParallelCodec(spec, block_size=block, device=device, pass2="device",
                       stage_times=stages).decode(container)
    t0 = time.perf_counter()
    native = rt.decode_blocks(payloads, spec, block)
    native_s = time.perf_counter() - t0
    if out != data or native != data:
        raise AssertionError(f"{label}: decode != input or native")
    m = max(len(p) for p in payloads)
    say("stream", f"{label}: {len(payloads)} blocks of {block} B past "
        f"MAX_BLOCK, longest payload {m} B; encode on {device} "
        f"{mib / enc_s:.1f} MiB/s (payloads == native encode_blocks); "
        f"pass2='device' decode {mib / dec_s:.1f} MiB/s == input == native "
        f"decode_blocks ({mib / native_s:.1f} MiB/s), no native call, "
        f"launches {l_dec}; decode peak {peak / MiB:.1f} MiB (predicted "
        f"{stream_peak(spec, len(payloads), m, block) / MiB:.1f}); {smi}")
    stage_line(label, "pass2='device' decode", stages, mib)
    return [l_enc, l_dec], payloads


def synced_stages(times: dict):
    """A ``stage(name)`` context manager that records each stage's seconds
    in ``times``, synchronising the card around it."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def stage(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0

    return stage


def run_stream_encode(image: bytes, smi: str, device,
                      facade: int = 16 * MiB, rows: int = 32,
                      row: int = 1 << 20) -> dict[str, Result]:
    """Phase 14c: the single-stream encode kernel ``stream_encode`` on
    ``device``.  On each facade's ``facade`` bytes (gif7, TIFF, fixed-12 LE
    and BE of the image plane, gif7 of the text tiled, and random gif7 and
    fixed-12 bytes, whose phrases are a byte or two): the ``"torch"``
    facade encode stage by stage (``enc_h2d``, ``enc_kernel``,
    ``enc_pack``, ``enc_d2h``, each synchronised) == native's bytes; the
    kernel on the stream's one row against its plain version, every array
    exact, by CUDA events, with ns a byte, a step (a phrase) and a round,
    phrases a round, its bytes bound and its chain floor (two dependent
    shared loads a round, the load's latency from ``chain_probe``);
    ``encode_parse`` on the same row,
    equal to it and timed once.  Then both kernels on ``rows`` x ``row``
    gif7 rows of the image plane (phase 14b's container rows),
    ``stream_encode`` == plain; then the edge rows of
    ``testdata.stream_encode_edge_cases`` in five flavors.  Returns
    {"stream_encode": Result on the gif7 image stream}."""
    import numpy as np
    import torch

    from lzw_tpu_torch import Endianness, LzwCodec, LzwSpec
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.kernels import probe
    from lzw_tpu_torch.ops import encode as senc
    from lzw_tpu_torch.scripts import chain_probe
    from lzw_tpu_torch.utils import testdata
    from lzw_tpu_torch.utils.card import cuda_ms, events_ms

    t_phase = time.perf_counter()
    host, start = chain_probe.table("load")
    tab = torch.from_numpy(host).to(device)
    steps = 1 << 20
    load_ns = cuda_ms(lambda: probe.chain_steps(tab, start, "load", 1,
                                                steps), 1) * 1e6 / steps
    text = tile((ROOT / "test-assets" / "lorem_ipsum.txt").read_bytes(),
                facade)
    fixed_le, fixed_be = (LzwSpec.fixed(Endianness.LITTLE),
                          LzwSpec.fixed(Endianness.BIG))
    noise = np.random.default_rng(14).integers(0, 256, facade).astype(
        np.uint8)
    out = {}
    for label, spec, data in (
            ("gif7 image", LzwSpec.gif(7), image[:facade]),
            ("tiff image", LzwSpec.tiff(), image[:facade]),
            ("fixed-12 LE image", fixed_le, image[:facade]),
            ("fixed-12 BE image", fixed_be, image[:facade]),
            ("gif7 text", LzwSpec.gif(7), text),
            ("gif7 random", LzwSpec.gif(7), (noise & 127).tobytes()),
            ("fixed-12 random", fixed_le, noise.tobytes())):
        mib = len(data) / MiB
        stages = {}
        wall, enc = once_ms(lambda: senc.encode_stream_bytes(
            data, spec, device=device, stage=synced_stages(stages)))
        if enc != LzwCodec(spec, "native").encode(data):
            raise AssertionError(f"{label}: facade encode != native")
        mat = np.zeros((1, -(-len(data) // 16) * 16), np.uint8)
        mat[0, : len(data)] = np.frombuffer(data, np.uint8)
        blocks_h = torch.from_numpy(mat)
        lens_h = torch.tensor([len(data)], dtype=torch.int32)
        blocks, lens = blocks_h.to(device), lens_h.to(device)
        *got, walk = tenc.encode_stream_codes(blocks, lens, spec,
                                              stats=True)
        steps, rounds = walk[0].tolist()
        plain_ms, want = once_ms(lambda: tenc.encode_blocks_codes_reference(
            blocks_h, lens_h, spec))
        # One timed call after a warm-up: a call takes about a second.
        ms = cuda_ms(lambda: tenc.encode_stream_codes(blocks, lens, spec), 1)
        codes = int(want[1][0])
        # The stream in, 4 B a code out, the count and the two errors.
        res = result(max_abs_err(got, want), ms, plain_ms,
                     len(data) + 4 * codes + 12, 0)
        if res.err:
            raise AssertionError(f"{label}: stream_encode != plain, "
                                 f"max_abs_err {res.err}")
        if label == "gif7 image":
            out["stream_encode"] = res
        old = ""
        if label != "fixed-12 BE image":  # the LE row's parse
            if max_abs_err(tenc.encode_blocks_codes(blocks, lens, spec),
                           got):
                raise AssertionError(f"{label}: encode_parse != "
                                     "stream_encode")
            parse_ms = events_ms([lambda: tenc.encode_blocks_codes(
                blocks, lens, spec)])
            old = (f"; encode_parse on the same row {parse_ms:.4f} ms "
                   f"({parse_ms * 1e6 / len(data):.2f} ns a byte, "
                   f"{parse_ms / ms:.2f}x), == stream_encode")
        say("stream", f"{label} {mib:.0f} MiB, {codes} codes: stream_encode "
            f"{ms:.4f} ms ({ms * 1e6 / len(data):.2f} ns a byte, "
            f"{ms * 1e6 / steps:.2f} ns a phrase, "
            f"{ms * 1e6 / max(rounds, 1):.2f} ns a round, "
            f"{len(data) / steps:.3f} bytes a phrase, "
            f"{steps / max(rounds, 1):.3f} phrases a round) == plain "
            f"exactly (plain {plain_ms:.1f} ms); bound {res.bound_ms:.5f} "
            f"ms by bytes, chain floor {2 * rounds * load_ns / 1e6:.1f}"
            f" ms ({load_ns:.2f} ns a dependent shared load)" + old
            + f"; torch facade encode {mib / wall * 1e3:.2f} MiB/s == "
            "native, stages " + ", ".join(
                f"{k} {v * 1e3:.2f} ms" for k, v in stages.items())
            + f"; {smi}")
    gif7 = LzwSpec.gif(7)
    mat = np.frombuffer(image[: rows * row], np.uint8).reshape(rows, row)
    blocks_h = torch.from_numpy(mat.copy())
    lens_h = torch.full((rows,), row, dtype=torch.int32)
    blocks, lens = blocks_h.to(device), lens_h.to(device)
    got = tenc.encode_stream_codes(blocks, lens, gif7)
    plain_ms, want = once_ms(lambda: tenc.encode_blocks_codes_reference(
        blocks_h, lens_h, gif7))
    err = max_abs_err(got, want)
    if err or max_abs_err(tenc.encode_blocks_codes(blocks, lens, gif7),
                          want):
        raise AssertionError(f"{rows} x {row} B gif7 rows: a kernel != "
                             f"plain (stream_encode max_abs_err {err})")
    ms = cuda_ms(lambda: tenc.encode_stream_codes(blocks, lens, gif7))
    parse_ms = cuda_ms(lambda: tenc.encode_blocks_codes(blocks, lens, gif7))
    say("stream", f"{rows} x {row} B gif7 image rows: stream_encode "
        f"{ms:.4f} ms ({ms * 1e6 / row:.2f} ns a byte of a row), "
        f"encode_parse {parse_ms:.4f} ms ({parse_ms * 1e6 / row:.2f}), both "
        f"== plain exactly (plain {plain_ms:.1f} ms); {smi}")
    specs = [LzwSpec.gif(2), gif7, LzwSpec.tiff(), fixed_le, fixed_be]
    n = testdata.check_stream_encode_edge_cases(device, specs)
    say("stream", f"encode edge cases: {n} rows of {len(specs)} flavors "
        "(testdata.stream_encode_edge_cases, one launch a flavor), "
        "stream_encode == plain exactly; phase 14c "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def stream_rows(streams: list[bytes]):
    """u8[N, M] rows (M the longest stream) and i32[N] lengths, as the
    facade (N = 1) and the container's big-block decode lay them out."""
    import numpy as np

    mat = np.zeros((len(streams), max(max(map(len, streams)), 1)), np.uint8)
    for i, s in enumerate(streams):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    return mat, np.array([len(s) for s in streams], np.int32)


def _plain_pass1_part(mat, lens, spec):
    """The plain pass 1 of some rows in a worker process: (its outputs as
    numpy arrays, seconds)."""
    import torch

    from lzw_tpu_torch.ops import decode as sdec

    t0 = time.perf_counter()
    out = sdec.decode_pass1(torch.from_numpy(mat), torch.from_numpy(lens),
                            spec)
    return {k: v.numpy() for k, v in out.items()}, time.perf_counter() - t0


class PlainPass1:
    """The plain pass 1 of a batch of rows, its rows split over the
    processes of ``pool`` (the rows are independent and the plain version
    loops over them).  :meth:`result` joins the parts in row order and
    gives (outputs as CPU tensors, milliseconds summed over the parts: the
    time of one call on all rows, less its per-call overhead)."""

    def __init__(self, pool, spec, mat, lens, parts: int):
        import numpy as np

        cuts = np.linspace(0, len(lens), min(parts, len(lens)) + 1)
        cuts = cuts.astype(int)
        self.futures = [pool.submit(_plain_pass1_part, mat[a:b], lens[a:b],
                                    spec)
                        for a, b in zip(cuts[:-1], cuts[1:])]

    def result(self):
        import numpy as np
        import torch

        parts = [f.result() for f in self.futures]
        out = {k: torch.from_numpy(np.concatenate([p[k] for p, _ in parts]))
               for k in parts[0][0]}
        return out, sum(dt for _, dt in parts) * 1e3


# Calls of each stream kernel a timing takes (CUDA events around them all).
STREAM_REPS = 10


def compare_stream(spec, mat, lens, plain: PlainPass1, label: str, device,
                   out_bound: int | None = None):
    """``stream_pass1`` and ``stream_pass2`` against their plain versions
    on the same rows on the card, every output array exact; pass 2 with
    ``out_bound`` (the container's block) or, as the facade calls it, the
    longest decoded row.  Each kernel is timed through its wrapper (which
    also allocates and zero-fills its outputs: the ``ms`` of its Result)
    and alone (its launch into buffers made once), STREAM_REPS calls after
    a warm-up.  Returns {kernel: Result}.

    Bounds, in bytes, count what the work needs of this run's data, not
    the arrays' sizes: pass 1 reads the valid payload bytes, the epoch
    table and the lengths, and writes the table entries it fills (the
    roots and the inserts, 12 B each), its words (15 B each, their wire
    code too) and per-row results (24 B); pass 2 reads those words (13 B
    each, not the code) and entries (8 B each: the
    prefix and the suffix) and writes the decoded bytes kept under
    ``out_bound`` and 8 B per row."""
    import torch

    from lzw_tpu_torch.ops import decode as sdec
    from lzw_tpu_torch.utils.card import cuda_ms

    rows = torch.from_numpy(mat).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    n = len(lens)
    got = sdec.decode_pass1(rows, lens_t, spec)
    ms1 = cuda_ms(lambda: sdec.decode_pass1(rows, lens_t, spec),
                  STREAM_REPS)
    planes = [[got[k] for k in keys] for keys in (
        sdec._TABLE_KEYS, sdec._WORD_KEYS, sdec._ROW_KEYS)]
    alone1 = cuda_ms(lambda: sdec._launch_pass1(
        rows, lens_t, spec, planes[0], planes[1], got["out_lit"],
        got["out_code"], planes[2], got["total_len"]), STREAM_REPS)
    want, plain_ms = plain.result()
    keys = list(want)
    err1 = max_abs_err([got[k] for k in keys], [want[k] for k in keys])
    longest = int(got["n_words"].max())
    codes = int(got["n_words"].sum())
    decoded = int(got["total_len"].sum())
    alphabet = spec.alphabet_size
    # The roots and the inserted entries (each inserted under a local code
    # of at least first_free, so its glocal is not 0).
    entries = n * alphabet + int(got["glocal"][:, alphabet:].ne(0).sum())
    # The epochs of the longest row: its CLEAR and EOI steps (length 0).
    at = int(got["n_words"].argmax())
    epochs = max(int(got["out_len"][at, :longest].eq(0).sum()), 1)
    epoch_bytes = 4 * len(sdec.epoch_widths(spec)[1])
    res = {"stream_pass1": result(
        err1, ms1, plain_ms, int(lens.sum()) + epoch_bytes + 4 * n
        + 12 * entries + 15 * codes + 24 * n, 0)}
    if out_bound is None:
        out_bound = max(int(got["total_len"].max()), 1)
    args = [got[k] for k in sdec.PASS2_KEYS] + [out_bound, alphabet]
    out = sdec.decode_pass2(*args)
    plain_ms, ref = once_ms(lambda: sdec.decode_pass2_reference(*args))
    err2 = max_abs_err(out, ref)
    ms2 = cuda_ms(lambda: sdec.decode_pass2(*args), STREAM_REPS)
    dst = torch.zeros((n, out_bound), dtype=torch.uint8, device=device)
    first_bad = torch.full((n,), -1, dtype=torch.int64, device=device)
    alone2 = cuda_ms(lambda: sdec._launch_pass2(
        args[:3], args[3:6], args[6], alphabet, dst, first_bad),
        STREAM_REPS)
    kept = int(got["total_len"].clamp(max=out_bound).sum())
    res["stream_pass2"] = result(
        err2, ms2, plain_ms, 13 * codes + 8 * entries + kept + 8 * n, 0)
    if err1 or err2:
        raise AssertionError(f"{label}: stream kernels != plain, "
                             f"max_abs_err {err1}, {err2}")
    if int(got["error"].abs().sum()) or int(out[1].ne(
            sdec.NO_ERROR_STEP).sum()):
        raise AssertionError(f"{label}: unexpected decode errors")
    r1, r2 = res["stream_pass1"], res["stream_pass2"]
    say("stream", f"{label}: N={n} rows of {mat.shape[1]} B, longest "
        f"{longest} codes in {epochs} epochs, {codes} codes in all; "
        + kernel_times(res) + f"; alone (no allocation or fill) "
        f"{alone1:.4f} / {alone2:.4f} ms; stream_pass1 "
        f"{ms1 * 1e6 / longest:.2f} ns a code of the longest row "
        f"({alone1 * 1e6 / longest:.2f} alone, "
        f"{alone1 * 1e3 / epochs:.2f} us an epoch), "
        f"{r1.bound_ms / ms1:.2%} of its bound ({r1.bound_ms / alone1:.2%} "
        f"alone), {decoded / MiB / ms1 * 1e3:.1f} MiB/s of output; "
        f"stream_pass2 {ms2 * 1e6 / codes:.4f} ns a code "
        f"({alone2 * 1e6 / codes:.4f} alone), {r2.bound_ms / ms2:.2%} of "
        f"its bound ({r2.bound_ms / alone2:.2%} alone), "
        f"{decoded / MiB / ms2 * 1e3:.1f} MiB/s; kernel == plain exactly")
    return res


def run_stream(image: bytes, smi: str, device, facade: int = 16 * MiB,
               depth: int = 32 * MiB, big: int = 1 << 20):
    """Phase 14: the single-stream codec on ``device``: the facades on
    ``facade`` bytes of ``image``, gif7 blocks of ``big`` bytes and TIFF
    blocks of ``big / 4`` over ``depth`` bytes of it (32 MiB, which keeps
    the whole script near 500 s); then both kernels against their plain
    versions at those shapes: each facade's stream and each container's
    payload rows, the plain pass 1 spread over a pool of processes.
    Returns (launch counts of its main-path runs, {kernel: Result} at the
    gif7 container's shape)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from lzw_tpu_torch import CodeSizeStrategy, Endianness, LzwSpec
    from lzw_tpu_torch.utils import testdata

    _, streams, l_fac = timed_run(
        lambda: run_stream_facades(image, smi, device, facade),
        {"stream_encode": 1, "encode_parse": 0, "stream_pass1": 1,
         "stream_pass2": 1, "decode_pass1": 0, "decode_blocks": 0,
         "apply_words": 0}, "torch facades")
    launches = [l_fac]
    batches = {}
    for spec, block, label in (
            (LzwSpec.gif(7), big, f"gif7 image {big >> 10} KiB blocks"),
            (LzwSpec.tiff(), big // 4, f"tiff image {big >> 12} KiB blocks")):
        runs, payloads = run_stream_container(spec, image[:depth], block,
                                              label, smi, device)
        launches += runs
        batches[f"{label} container rows"] = (spec, payloads, block)
    for label, (spec, enc) in streams.items():
        batches[f"{label} {facade >> 20} MiB facade stream"] = (spec, [enc],
                                                                None)
    workers = min(os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        # The single-row facade streams first: they take longest.
        jobs = {}
        for label in sorted(batches, key=lambda k: len(batches[k][1])):
            spec, rows, _ = batches[label]
            mat, lens = stream_rows(rows)
            jobs[label] = (mat, lens, PlainPass1(pool, spec, mat, lens,
                                                 workers))
        full = None
        for label, (spec, _, block) in batches.items():
            mat, lens, plain = jobs[label]
            res = compare_stream(spec, mat, lens, plain, label, device,
                                 block)
            full = full or res
    say("stream", f"kernels vs plain at the main path's shapes: "
        f"{time.perf_counter() - t0:.1f} s, plain pass 1 on {workers} "
        "processes")
    t0 = time.perf_counter()
    specs = [LzwSpec.gif(7), LzwSpec.gif(2), LzwSpec.tiff(),
             LzwSpec.fixed(Endianness.LITTLE), LzwSpec.fixed(Endianness.BIG),
             LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF)]
    n_rows = testdata.check_stream_edge_cases(device, specs)
    say("stream", f"edge cases: {n_rows} rows of {len(specs)} flavors "
        "(testdata.stream_edge_cases, one launch a flavor), stream_pass1 "
        "and stream_pass2 == plain exactly, pass 2 at two output bounds; "
        f"{time.perf_counter() - t0:.1f} s")
    full.update(run_stream_encode(image, smi, device, facade))
    return launches, full


def encode_block_peak(n: int, block: int, out_bytes: int) -> int:
    """Device bytes that ``ops.encode.encode_block`` on n rows of ``block``
    bytes, then ``ops.bitpack.pack_codes_torch`` on its slots, add at their
    peak; M = block + 1 codes a row at most, S = 2 * block + 3 slots, O =
    out_bytes + 3 packed bytes a row with the slack.

    encode_block, once the kernel's positions are made into the slots' i64
    index [n, M] (and freed): the dense codes i32 [n, M], the live and body
    masks (bool [n, M]) and the codes and widths i32 [n, S] while a width
    plane i32 [n, M] is scattered: 14 nM + 8 nS.  The pack, with those
    slots held (8 nS): the codes' bits and their bit offsets, i64 (16 nS),
    the i64 rows [n, O] (8 nO), and inside the lane scatter
    (``ops.bitpack.scatter_symbols``) the first bytes and the windows, i64
    (16 nS), and the three byte lanes and one lane's index, i64 (32 nS):
    72 nS + 8 nO."""
    M, S, O = block + 1, 2 * block + 3, out_bytes + 3
    return max(14 * n * M + 8 * n * S, 72 * n * S + 8 * n * O)


def run_encode_block(image: bytes, smi: str, device) -> list[dict]:
    """Phase 15: the JAX package's per-block encode contract on the card.

    On phase 3's 64 x 8 KiB rows of gif7, gif2, TIFF and fixed-12,
    ``encode_block`` on the card against ``encode_block`` on the CPU,
    ``fix_eoi_width`` both ways (every array exact); the positions instance
    it launches is held against its plain version by
    :func:`compare_kernels` at those rows and at both full-width shapes
    below.  Then at full width, 2048 x 64 KiB gif7 and 8192 x 4 KiB
    fixed-12 of the image plane: ``pack_codes_torch(encode_block(...,
    fix_eoi_width=True))`` counted to launch ``encode_parse``, its payloads
    equal block for block to those ``BlockParallelCodec`` frames for the
    same data; the positions instance and the container's instance on the
    same rows, the wrapper and the pack, by CUDA events, and the peak
    device memory of the wrapper and the pack beside
    :func:`encode_block_peak`.  Returns the counted runs' launches."""
    import numpy as np
    import torch

    from lzw_tpu_torch import BlockParallelCodec, Endianness, LzwSpec
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.ops import bitpack, encode
    from lzw_tpu_torch.parallel import framing
    from lzw_tpu_torch.utils import testdata
    from lzw_tpu_torch.utils.card import cuda_ms

    t0 = time.perf_counter()
    specs = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
             "tiff": LzwSpec.tiff(), "fixed": LzwSpec.fixed(Endianness.LITTLE)}
    for i, (label, spec) in enumerate(specs.items()):
        mat, lens = sample_blocks(spec, 64, 8192, seed=i)
        blocks, lens_t = torch.from_numpy(mat), torch.from_numpy(lens)
        blocks_d, lens_d = blocks.to(device), lens_t.to(device)
        for fix in (False, True):
            testdata.same_slots(
                f"{label} fix_eoi_width={fix}",
                encode.encode_block(blocks_d, lens_d, spec,
                                    fix_eoi_width=fix),
                encode.encode_block(blocks, lens_t, spec, fix_eoi_width=fix))
    say("encode_block", f"64 x 8 KiB rows: encode_block on {device} == on "
        "the CPU, fix_eoi_width both ways; "
        f"{time.perf_counter() - t0:.1f} s")

    launches = []
    for spec, block, depth, label in (
            (LzwSpec.gif(7), 1 << 16, 128 * MiB, "gif7 image"),
            (LzwSpec.fixed(Endianness.LITTLE), 1 << 12, 32 * MiB,
             "fixed-12 image")):
        data = image[:depth]
        mat = np.frombuffer(data, np.uint8).reshape(-1, block)
        n = mat.shape[0]
        blocks = torch.from_numpy(mat.copy()).to(device)
        lens = torch.full((n,), block, dtype=torch.int32, device=device)
        out_bytes = encode.packed_bound(block, spec)

        def run():
            res = encode.encode_block(blocks, lens, spec, fix_eoi_width=True)
            return res, bitpack.pack_codes_torch(
                res["codes"], res["widths"], spec.endianness, out_bytes)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        dt, (res, (buf, n_bytes)), lc = timed_run(
            run, {"encode_parse": 1}, f"{label} encode_block")
        peak = torch.cuda.max_memory_allocated() - before
        launches.append(lc)
        if int(res["error"].abs().sum()):
            raise AssertionError(f"{label}: encode_block reported an error")
        buf, n_bytes = buf.cpu().numpy(), n_bytes.cpu().numpy()
        del res
        container = BlockParallelCodec(spec, block_size=block,
                                       device=device).encode(data)
        payloads = framing.parse_frame(container)[1]
        if len(payloads) != n or any(
                buf[i, : n_bytes[i]].tobytes() != bytes(payloads[i])
                for i in range(n)):
            raise AssertionError(f"{label}: encode_block + pack_codes_torch "
                                 "!= the container's payloads")
        del buf
        n_codes = int(tenc.encode_blocks_codes(blocks, lens, spec)[1].sum())
        ms_pos = cuda_ms(lambda: tenc.encode_blocks_codes(
            blocks, lens, spec, positions=True))
        ms_plain = cuda_ms(lambda: tenc.encode_blocks_codes(blocks, lens,
                                                            spec))
        ms_wrap = cuda_ms(lambda: encode.encode_block(blocks, lens, spec,
                                                      fix_eoi_width=True))
        res = encode.encode_block(blocks, lens, spec, fix_eoi_width=True)
        ms_pack = cuda_ms(lambda: bitpack.pack_codes_torch(
            res["codes"], res["widths"], spec.endianness, out_bytes))
        del res
        # The positions instance moves the blocks in and 8 B a code out
        # (its code and its byte).
        bound = (n * block + 8 * n_codes) / HBM_BYTES_PER_S * 1e3
        say("encode_block", f"{label} {n} x {block} B: pack_codes_torch("
            "encode_block(fix_eoi_width=True)) == BlockParallelCodec's "
            f"payloads block for block, {dt * 1e3:.1f} ms once, launches "
            f"{lc}; encode_parse positions {ms_pos:.4f} ms (the container's "
            f"instance on the same rows {ms_plain:.4f}; bound "
            f"{bound:.5f} ms by bytes, {n_codes} codes), encode_block "
            f"{ms_wrap:.4f} ms, pack_codes_torch {ms_pack:.4f} ms, by CUDA "
            f"events; peak "
            f"{peak / MiB:.1f} MiB of the wrapper and the pack (predicted "
            f"{encode_block_peak(n, block, out_bytes) / MiB:.1f}); {smi}")
        del blocks
    say("encode_block", f"phase 15: {time.perf_counter() - t0:.1f} s")
    return launches


def run_contract(image: bytes, smi: str, device) -> list[dict]:
    """Phase 16: the container's contract on input past the alphabet and on
    blocks that decode past their size, at the main path's width.

    Encode: 2048 x 64 KiB gif2 blocks (128 MiB of the image plane reduced
    to 2 bits), each block's first byte set past the alphabet, through
    ``BlockParallelCodec(device=device, verify=False)``, counted to launch
    ``encode_parse``: every payload equal to the native runtime's
    single-stream encode of its block (which masks the first code to its
    slot), four of them to the CPU plain route's; the parse's dense codes
    on 64 of the rows against their plain version, the first byte whole in
    both; ``verify=True`` raises VerificationError, as the JAX container
    does.  Then the container's pack with the mask (``pack_dense``) beside
    the pack without it (``pack_variable``) on phase 4's gif7 dense codes,
    by CUDA events, in turns.  Decode: a gif7 container of 128 x 64 KiB
    blocks of the image plane whose blocks 37 and 90 hold streams of
    68 KiB raises UnexpectedCodeError with one code on ``pass2`` "host",
    "device" and "auto" (each counted to launch ``decode_pass1`` and call
    no native decoder), the code of block 37 in the plain pass 1 and in
    the oracle bounded at the block size; pass 1 on the card against its
    plain version on rows 36 and 37, every array exact.  Then the same
    container with a foreign early-CLEAR stream of 68 KiB (epochs of 2900
    bytes) in block 37, and a gif7 container of 8 x 256 KiB blocks (past
    ``MAX_BLOCK``) with a 260 KiB stream in block 3: each raises one
    UnexpectedCodeError code on "host", "device" and "auto" (each counted
    to launch ``decode_pass1`` or ``stream_pass1``, "host" and "auto" to
    call the native ``decode_blocks`` first, which cannot name the code),
    the plain route's, the plain witness's (pass 1 on the crossing epoch
    bounded at the room the earlier epochs leave; the single-stream
    decoder's word past the block) and the bounded oracle's.  Last, the
    same 8 x 256 KiB container with block 5 a stream that fills its block
    exactly, then a CLEAR and a first code naming an entry never inserted
    (``testdata.uninit_literal_stream``): that one-byte literal passes the
    block, and every route must raise the wire code read (255), which the
    single-stream pass 1 gives in ``out_code`` (its ``glocal`` names 0).
    Returns the counted runs' launches."""
    import numpy as np
    import torch

    from lzw_tpu_torch import BlockParallelCodec, LzwSpec
    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.kernels import schedule as tsched
    from lzw_tpu_torch.kernels.decode import MAX_BLOCK, variable_pass1
    from lzw_tpu_torch.kernels.nonstrict import (
        decode_variable_nonstrict_device,
    )
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.ops import decode as sdec
    from lzw_tpu_torch.ops import reference
    from lzw_tpu_torch.ops.encode import pack_dense
    from lzw_tpu_torch.parallel import framing
    from lzw_tpu_torch.utils.card import cuda_ms
    from lzw_tpu_torch.utils.testdata import (
        spliced_nonstrict_stream, uninit_literal_stream,
    )

    t0 = time.perf_counter()
    block = 1 << 16
    gif2, gif7 = LzwSpec.gif(2), LzwSpec.gif(7)
    rt = get_runtime()
    mat = (np.frombuffer(image[: 128 * MiB], np.uint8) & 3).reshape(
        -1, block).copy()
    n = mat.shape[0]
    mat[:, 0] = np.random.default_rng(16).integers(
        gif2.alphabet_size, 256, size=n)
    data = mat.tobytes()
    dt, container, l_enc = timed_run(
        lambda: BlockParallelCodec(gif2, block, device=device,
                                   verify=False).encode(data),
        {"encode_parse": 1}, "gif2 first bytes past the alphabet")
    launches = [l_enc]
    payloads = [bytes(p) for p in framing.parse_frame(container)[1]]
    with ThreadPoolExecutor(8) as pool:
        native = list(pool.map(
            lambda i: rt.encode(mat[i].tobytes(), gif2, fix_eoi=True),
            range(n)))
    bad = [i for i in range(n) if i >= len(payloads)
           or payloads[i] != native[i]]
    if len(payloads) != n or bad:
        raise AssertionError(
            f"gif2 first bytes: {len(bad)} of {n} payloads differ from the "
            f"native single-stream encode, first block {bad[:1]}")
    sample = [0, 1, n // 2, n - 1]
    plain = framing.parse_frame(BlockParallelCodec(
        gif2, block, device="cpu", verify=False).encode(
            mat[sample].tobytes()))[1]
    if [bytes(p) for p in plain] != [payloads[i] for i in sample]:
        raise AssertionError("gif2 first bytes: the card's payloads differ "
                             f"from the CPU plain route's on blocks {sample}")
    rows = torch.from_numpy(mat[:64]).to(device)
    lens = torch.full((64,), block, dtype=torch.int32, device=device)
    got = tenc.encode_blocks_codes(rows, lens, gif2)
    want = tenc.encode_blocks_codes_reference(rows.cpu(), lens.cpu(), gif2)
    err = max_abs_err(got, want)
    if err or (got[0][:, 0].cpu().numpy() != mat[:64, 0]).any():
        raise AssertionError(
            f"gif2 first bytes: encode_parse != plain (max_abs_err {err}) "
            "or its first dense code is not the whole first byte")
    verified = outcome(BlockParallelCodec(gif2, block, device=device,
                                          verify=True).encode, data)
    if verified[0] != "VerificationError":
        raise AssertionError(f"gif2 first bytes: verify=True gave "
                             f"{verified[0]}, not VerificationError")
    say("contract", f"gif2 {n} x {block} B, every first byte past the "
        f"alphabet: payloads == native single-stream encode block for "
        f"block, == the CPU plain route on blocks {sample}; encode_parse "
        "== plain on 64 rows, its first code the whole byte; verify=True "
        f"raises VerificationError; {dt * 1e3:.1f} ms once, launches "
        f"{l_enc}; {smi}")

    # The pack with and without the first code's mask, main-path shape.
    img = torch.from_numpy(np.frombuffer(image[: 128 * MiB], np.uint8)
                           .reshape(-1, block).copy()).to(device)
    dense, counts, _, _ = tenc.encode_blocks_codes(
        img, torch.full((n,), block, dtype=torch.int32, device=device), gif7)
    del img
    dense = dense[:, : max(int(counts.max()), 1)]
    packs = {"pack_variable": lambda: tsched.pack_variable(
                 dense, counts, gif7, fix_eoi=True),
             "pack_dense": lambda: pack_dense(dense, counts, gif7,
                                              fix_eoi=True)}
    outs = {name: fn() for name, fn in packs.items()}
    if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
        raise AssertionError("gif7: pack_dense != pack_variable on codes "
                             "within the alphabet")
    del outs
    times = {name: [] for name in packs}
    for name in ("pack_variable", "pack_dense", "pack_dense",
                 "pack_variable"):
        times[name].append(cuda_ms(packs[name]))
    say("contract", f"gif7 {n} x {block} B enc_pack by CUDA events, in "
        "turns: " + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                              + " ms" for k, v in times.items())
        + f"; {smi}")
    del dense, counts, packs

    # Blocks that decode past their size.
    data7 = image[: 8 * MiB]
    payloads7 = [bytes(p) for p in framing.parse_frame(BlockParallelCodec(
        gif7, block, device=device).encode(data7))[1]]
    clean7 = list(payloads7)
    for b, at in ((37, 9 * MiB), (90, 11 * MiB)):
        payloads7[b] = rt.encode(image[at : at + block + 4096], gif7,
                                 fix_eoi=True)
    frame = framing.pack_frame(gif7, block, len(data7), payloads7)
    routes = {}
    for route in ("host", "device", "auto"):
        codec = BlockParallelCodec(gif7, block, device=device, pass2=route)
        _, routes[route], lc = timed_run(
            lambda: outcome(codec.decode, frame),
            {"decode_pass1": 1, "apply_words": 0, "decode_blocks": 0},
            f"gif7 overflow {route}")
        launches.append(lc)
    sub = [payloads7[36], payloads7[37]]
    mat7 = np.zeros((2, max(len(p) for p in sub)), np.uint8)
    for i, p in enumerate(sub):
        mat7[i, : len(p)] = np.frombuffer(p, np.uint8)
    plens7 = np.array([len(p) for p in sub], np.int32)
    k = variable_pass1(mat7, plens7, gif7, block, device)
    p1 = variable_pass1(mat7, plens7, gif7, block, "cpu")
    err = max_abs_err((k.words, k.totals, k.err, k.err_code),
                      (p1.words, p1.totals, p1.err, p1.err_code))
    code = int(p1.err_code[1])
    bounded = reference.block_error([payloads7[37]], gif7, block)
    want = ("UnexpectedCodeError", code)
    if (err or p1.err.tolist() != [0, 2] or getattr(bounded, "code", None)
            != code or any(o != want for o in routes.values())):
        raise AssertionError(
            f"gif7 overflow: routes {routes}, plain pass 1 err "
            f"{p1.err.tolist()} code {code}, oracle {bounded!r}, kernel vs "
            f"plain max_abs_err {err}")
    say("contract", f"gif7 {len(payloads7)} x {block} B, blocks 37 and 90 "
        f"decoding past it: UnexpectedCodeError({code}) on host, device and "
        "auto (decode_pass1 launched, no native decoder called), == the "
        "plain pass 1's code (err 2) and the bounded oracle's; decode_pass1 "
        f"== plain on rows 36-37; launches {launches[1:]}")

    # A foreign (early-CLEAR) block, then a block past MAX_BLOCK, that
    # decode past their size: "host" and "auto" take the native
    # decode_blocks, which cannot name the code, then the device route.
    piece = 2900
    long7 = image[13 * MiB : 13 * MiB + block + 4096]
    foreign = spliced_nonstrict_stream(long7, gif7, piece, device=device)
    k_ep, room = divmod(block, piece)
    epoch = rt.encode(long7[k_ep * piece : (k_ep + 1) * piece], gif7,
                      fix_eoi=True)
    ep = variable_pass1(np.frombuffer(epoch, np.uint8)[None].copy(),
                        np.array([len(epoch)], np.int32), gif7, room, "cpu")
    plain = outcome(lambda: decode_variable_nonstrict_device(
        np.frombuffer(foreign, np.uint8)[None].copy(),
        np.array([len(foreign)], np.int32), gif7, block, device="cpu"))
    big = 2 * MAX_BLOCK
    data_big = image[: 8 * big]
    payloads_big = [bytes(p) for p in framing.parse_frame(BlockParallelCodec(
        gif7, big, device=device).encode(data_big))[1]]
    payloads_uninit = list(payloads_big)
    payloads_big[3] = rt.encode(image[20 * MiB : 20 * MiB + big + 4096],
                                gif7, fix_eoi=True)
    payloads_uninit[5], wire = uninit_literal_stream(gif7, big)

    def plain_single(stream):
        row = torch.from_numpy(np.frombuffer(stream, np.uint8)[None].copy())
        res = sdec.decode_block(row, torch.tensor([row.shape[1]],
                                                  dtype=torch.int32),
                                gif7, big, overflow_error=True)
        return int(res["error"][0]), int(res["error_code"][0])

    plain_big = plain_single(payloads_big[3])
    plain_uninit = plain_single(payloads_uninit[5])
    if plain_uninit[1] != wire:
        raise AssertionError(f"gif7 uninit literal: the plain decoder names "
                             f"{plain_uninit}, not the wire code {wire}")
    clean7[37] = foreign
    # Each case: its container, block size, the kernel its device route
    # launches, the plain route's outcome, the plain witness's (err kind,
    # code) and the kind it must be, and the failing stream.
    cases = {
        "foreign": (framing.pack_frame(gif7, block, len(data7), clean7),
                    block, "decode_pass1", plain,
                    (int(ep.err[0]), int(ep.err_code[0])), 2, foreign),
        "big": (framing.pack_frame(gif7, big, len(data_big), payloads_big),
                big, "stream_pass1", ("UnexpectedCodeError", plain_big[1]),
                plain_big, sdec.ERR_UNEXPECTED_CODE, payloads_big[3]),
        "uninit literal": (
            framing.pack_frame(gif7, big, len(data_big), payloads_uninit),
            big, "stream_pass1", ("UnexpectedCodeError", wire),
            plain_uninit, sdec.ERR_UNEXPECTED_CODE, payloads_uninit[5]),
    }
    for case, (frame, bs, kernel, want, (w_err, w_code), kind, stream) in (
            cases.items()):
        bounded = reference.block_error([stream], gif7, bs)
        got = {}
        for route in ("host", "device", "auto"):
            codec = BlockParallelCodec(gif7, bs, device=device, pass2=route)
            _, got[route], lc = timed_run(
                lambda: outcome(codec.decode, frame),
                {kernel: 1, "decode_blocks": int(route != "device")},
                f"gif7 {case} overflow {route}")
            launches.append(lc)
        if (want[0] != "UnexpectedCodeError" or w_code != want[1]
                or w_err != kind or getattr(bounded, "code", None)
                != want[1] or any(o != want for o in got.values())):
            raise AssertionError(
                f"gif7 {case} overflow: routes {got}, plain {want}, plain "
                f"witness ({w_err}, {w_code}), oracle {bounded!r}")
        say("contract", f"gif7 {case} block past its {bs} B: "
            f"{want[0]}({want[1]}) on host, device and auto ({kernel} "
            "launched on each, the native decode_blocks called on host and "
            "auto), == the plain route's, the plain "
            + ("pass 1 on the crossing epoch bounded at the room left"
               if case == "foreign" else "single-stream decoder's")
            + f" and the bounded oracle's; launches {launches[-3:]}")
    say("contract", f"phase 16: {time.perf_counter() - t0:.1f} s")
    return launches


def main(only: str | None = None) -> int:
    if not (ROOT / "lzw_tpu_torch").is_dir():
        print("chip_smoke.py: lzw_tpu_torch/ not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 3

    from lzw_tpu_torch import Endianness, LzwSpec
    from lzw_tpu_torch.kernels import build
    from lzw_tpu_torch.native import runtime
    from lzw_tpu_torch.utils import testdata
    from lzw_tpu_torch.utils.card import nvidia_smi_line
    from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

    # 1. Device.
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say("device", f"{kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    device = torch.device("cuda", 0)

    # 2. Build: one nvcc per kernel and the native runtime, all at once.
    def timed_build(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(build.KERNELS) + 1) as pool:
        jobs = {name: pool.submit(timed_build, lambda n=name: build.load(n))
                for name in build.KERNELS}
        jobs["native"] = pool.submit(timed_build, runtime.get_runtime)
        secs = {name: job.result() for name, job in jobs.items()}
    for name in build.KERNELS:
        say("build", f"{name}: nvcc {build.find_nvcc()} sm_90a, "
            f"{secs[name]:.2f} s")
    say("build", f"native runtime from {runtime.SOURCE.relative_to(ROOT)}: "
        f"{secs['native']:.2f} s")
    count_host_calls()
    assets = ROOT / "test-assets"
    tokyo = load_tokyo_pixels(assets / "tokyo_128_colors.png")
    if only == "--stream-only":
        t14 = time.perf_counter()
        launches, _ = run_stream(tile(tokyo, 128 * MiB), smi, device)
        say("done", f"phase 14: {time.perf_counter() - t14:.1f} s, "
            f"launches {launches}; wall time "
            f"{time.perf_counter() - t_start:.1f} s; {smi}")
        return 0
    if only == "--contract-only":
        launches = run_contract(tile(tokyo, 128 * MiB), smi, device)
        say("done", f"launches {launches}; wall time "
            f"{time.perf_counter() - t_start:.1f} s; {smi}")
        return 0
    if only == "--probes-only":
        launches, _ = run_probes(device)
        say("done", f"launches {launches}; wall time "
            f"{time.perf_counter() - t_start:.1f} s; {smi}")
        return 0
    if only == "--pass1-only":
        run_pass1_images(tokyo, device)
        run_pass1_bulk("gif7 image main-path shape", LzwSpec.gif(7),
                       tile(tokyo, 128 * MiB), 1 << 16, device)
        run_pass1_bulk("fixed-12 image container shape",
                       LzwSpec.fixed(Endianness.LITTLE),
                       tile(tokyo, 32 * MiB), 1 << 12, device)
        say("done", f"wall time {time.perf_counter() - t_start:.1f} s; "
            f"{smi}")
        return 0

    # 3. Kernel vs plain, all four flavors, 64 x 8 KiB.
    specs = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
             "tiff": LzwSpec.tiff(), "fixed": LzwSpec.fixed(Endianness.LITTLE)}
    for i, (label, spec) in enumerate(specs.items()):
        mat, lens = sample_blocks(spec, 64, 8192, seed=i)
        compare_kernels(spec, mat, lens, 8192, device, label, stride1=True)
    n_enc, n_pass1 = testdata.check_edge_cases(device)
    n_epochs = testdata.check_pass1_cases(device,
                                          testdata.pass1_epoch_cases())
    say("kernels", f"edge cases: encode_parse on {n_enc} cases with and "
        f"without positions and decode_pass1 on {n_pass1} + {n_epochs} "
        "cases x 3 row kinds == plain exactly")
    run_pass1_images(tokyo, device)

    # 4. The slice at full size.
    lorem = (assets / "lorem_ipsum.txt").read_bytes()
    gif7 = LzwSpec.gif(7)
    total = {name: 0 for name in build.KERNELS}

    def add(runs):
        for launches in runs:
            for name in total:
                total[name] += launches[name]

    for label, corpus in (("gif7 image", tokyo), ("gif7 text", lorem)):
        add(run_container(gif7, tile(corpus, 128 * MiB), 1 << 16, label))
    # The kernels at the main path's shapes (not counted as launches).
    data = np.frombuffer(tile(tokyo, 128 * MiB), np.uint8)
    mat = data.reshape(-1, 1 << 16).copy()
    lens = np.full(mat.shape[0], 1 << 16, np.int32)
    full = compare_kernels(gif7, mat, lens, 1 << 16, device,
                           "gif7 image main-path shape")
    del data, mat
    run_pass1_bulk("gif7 image main-path shape", gif7,
                   tile(tokyo, 128 * MiB), 1 << 16, device)

    # 5. Fixed-12 container, 32 MiB at 4 KiB blocks, and the kernels at its
    # shape.
    fixed = LzwSpec.fixed(Endianness.LITTLE)
    data = tile(tokyo, 32 * MiB)
    add(run_container(fixed, data, 1 << 12, "fixed-12 image"))
    mat = np.frombuffer(data, np.uint8).reshape(-1, 1 << 12).copy()
    lens = np.full(mat.shape[0], 1 << 12, np.int32)
    compare_kernels(fixed, mat, lens, 1 << 12, device,
                    "fixed-12 image container shape")
    del data, mat
    run_pass1_bulk("fixed-12 image container shape", fixed,
                   tile(tokyo, 32 * MiB), 1 << 12, device)

    # 6. Non-strict gif7 container, 128 x 64 KiB.
    add([run_nonstrict(gif7, tile(tokyo, 8 * MiB), 1 << 16,
                       "gif7 non-strict image")])

    # 7. The stride-1 route beside the stride-2 one at full width.
    launches, stride1 = run_stride1(gif7, tile(tokyo, 128 * MiB), 1 << 16,
                                    "gif7 image")
    add(launches)
    full["decode_pass2_stride1"] = stride1["decode_pass2_stride1"]
    add(run_stride1(fixed, tile(tokyo, 32 * MiB), 1 << 12,
                    "fixed-12 image")[0])

    # 8. The probe entry points.
    launches, probes = run_probes(device)
    add([launches])
    full.update(probes)

    # 9. The row split over every visible GPU (and cuda:0 twice on one).
    from lzw_tpu_torch.parallel import default_devices

    lists = [default_devices()]
    if torch.cuda.device_count() == 1:
        lists.append([device, device])
    image = tile(tokyo, 128 * MiB)
    launches, one_container = run_split(gif7, image, 1 << 16, "gif7 image",
                                        lists)
    add(launches)
    add(run_split(fixed, tile(tokyo, 32 * MiB), 1 << 12, "fixed-12 image",
                  lists)[0])

    # 10. Block ranges over two processes.
    add(run_multihost(hashlib.sha256(one_container).hexdigest()))
    del one_container

    # 11. The single-stream facades (host runtime; no kernel may launch).
    timed_run(lambda: run_facades(image),
              {"encode_parse": 0, "decode_pass1": 0, "word_ends": 0,
               "decode_pass2": 0, "stream_encode": 0, "stream_pass1": 0,
               "stream_pass2": 0}, "facades")

    # 12. The entry module.
    add(run_entry())

    # 13. The examples, then the memory report and the trace on the phase-4
    # image data and a fixed-12 container.
    add(run_examples(tokyo))
    with tempfile.TemporaryDirectory() as tmp:
        add(run_memory(gif7, image, 1 << 16, "gif7 image", smi,
                       pathlib.Path(tmp)))
    add(run_memory(fixed, tile(tokyo, 32 * MiB), 1 << 12, "fixed-12 image",
                   smi))

    # 14. The single-stream codec on the card: the "torch" facades, big
    # blocks through pass2="device", the stream kernels against plain.
    t14 = time.perf_counter()
    launches, stream = run_stream(image, smi, device)
    say("stream", f"phase 14: {time.perf_counter() - t14:.1f} s")
    add(launches)
    full.update(stream)

    # 15. The JAX package's per-block encode contract on the card.
    add(run_encode_block(image, smi, device))

    # 16. The container's contract past the alphabet and past a block.
    add(run_contract(image, smi, device))
    del image

    kernels = []
    for name, (src, rep) in KERNEL_SOURCES.items():
        r = full[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": total[name],
                        "max_abs_err": r.err, "ms": r.ms,
                        "plain_ms": r.plain_ms, "bound_ms": r.bound_ms,
                        "bound_by": r.bound_by, "library_ms": r.library_ms})
    print(json.dumps({"kernels": kernels}))
    say("done", f"wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(sys.argv[2:]))
    if sys.argv[1:] not in ([], ["--stream-only"], ["--contract-only"],
                            ["--probes-only"], ["--pass1-only"]):
        sys.exit(f"usage: {sys.argv[0]} [--stream-only | --contract-only | "
                 "--probes-only | --pass1-only]")
    sys.exit(main(only=(sys.argv[1:] or [None])[0]))
