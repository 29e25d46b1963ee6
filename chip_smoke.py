#!/usr/bin/env python3
"""Smoke run of the lzw_tpu_torch main path on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

1. device: the CUDA card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the nine CUDA kernels from
   ``lzw_tpu_torch/kernels/csrc`` (nvcc, sm_90a) and the native runtime
   from ``lzw_tpu_torch/native``, all at once;
3. kernel vs plain: the encode-parse kernel, pass 1 with its stride-2 and
   with its stride-1 pair rows, the word-offset scan ``word_ends`` and both
   pass-2 walks (stride-2 and stride-1), padded and flat, against their
   plain PyTorch versions on the card, exact equality, the flat bytes
   against the padded rows' masked bytes and both walks' bytes against the
   blocks, for gif7, gif2, tiff
   and fixed-12 on 64 blocks x 8 KiB of random and compressible data; then
   the encode-parse and pass-1 kernels on the edge cases of their
   one-chain-per-warp design (``lzw_tpu_torch.utils.testdata``: blocks of
   length 0, 1, 2 and B in one launch, partly filled CTAs and more blocks
   than one round of chains, full tables, resets, KwKwK runs, errors and
   the words past each block's stop), pass 1 with every row kind, exact;
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
   same inputs in every variant, exact, and the yardstick library calls;
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
   the native encoder, and ``dryrun_multichip`` over every visible GPU.

Phases 1-8 run on cuda:0.  Each timing of the encode-parse and pass-1
kernels also prints their chains in flight (CTAs per SM from the occupancy
query x warps per CTA x SMs), the rounds of chains the launch takes and the
ns per chain step:
the kernel's time over rounds x steps of the longest block.  Each timing
of a walk (``[walk]`` lines) prints the walk's launch alone, the scan, the
torch call the scan replaced, the flat and padded wrappers, the longest
word and the walk's time over the dependent loads along it.

It prints a ``{"kernels": [...]}`` line, each kernel with its bound (the
least time for the bytes it must move at 3.35 TB/s, or for its 32-bit
integer operations at 16.7 T/s, whichever is larger), and ends with
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.  It imports nothing of
JAX or of the JAX package ``lzw_tpu``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
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
    # TPU's dictionary layout.
    "encode_parse": ("lzw_tpu_torch/kernels/csrc/encode_parse.cu",
                     "lzw_tpu/kernels/encode_pallas.py:501 (K1), :595 (K2), "
                     ":92 (K6), :105 (K7), :679 (K8)"),
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
        say("chains", f"{label}: {p1_name} " + chain_line(
            "decode_pass1", n_blocks, int(n_codes.max()), n / n_blocks, ms,
            codes.device))
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
    """The encode, pass-1 (stride-2 rows) and stride-2 walk kernels against
    their plain versions on the same CUDA inputs, and the walk's bytes
    against the blocks; with ``stride1`` also pass 1 with stride-1 rows and
    the stride-1 walk.

    Returns {kernel: Result}.  The encoder's bound: it reads the blocks'
    bytes and lengths and writes each code and three stats per block, about
    8 integer operations per input byte."""
    import torch

    from lzw_tpu_torch.kernels import encode as tenc
    from lzw_tpu_torch.utils.card import cuda_ms

    blocks_t = torch.from_numpy(mat).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    enc = tenc.encode_blocks_codes(blocks_t, lens_t, spec)
    plain_ms_e, enc_ref = once_ms(
        lambda: tenc.encode_blocks_codes_reference(blocks_t, lens_t, spec))
    err_e = max_abs_err(enc, enc_ref)
    ms_e = cuda_ms(lambda: tenc.encode_blocks_codes(blocks_t, lens_t, spec))
    if err_e:
        raise AssertionError(
            f"{label}: encode_parse != plain, max_abs_err {err_e}")
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
        + kernel_times(res) + ", kernel == plain exactly, "
        + ("both walks" if stride1 else "pass 2") + " == input")
    return res


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


def run_probes(device):
    """Phase 8: the four probe CLIs as a user runs them, at the JAX
    scripts' shapes, counted to launch each probe kernel; every gather must
    be right and the sweep's time must follow its step count.  Then each
    probe kernel against its plain version on the same inputs, every
    variant, and the library calls that compute P4-a and P4-b.

    Returns (the launch counts, {kernel: Result}); each kernel's Result is
    that of the variant named in its source's note: P1 ``scan``, P2
    ``ring``, P3 int32 at T = 512, P4-b."""
    import numpy as np
    import torch

    from lzw_tpu_torch.kernels import ablate, probe
    from lzw_tpu_torch.scripts import (ablate2, ablate_kernel, probe_gpu,
                                       probe_i16)
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
    x = ablate2.make_input(device)
    for v in ablate2.VARIANTS:
        got = ablate.ablate_ring(x, v)
        plain_ms, ref = once_ms(lambda: ablate.ablate_ring_reference(x, v))
        errs[f"P2 {v}"] = max_abs_err((got,), (ref,))
        if v == "ring":
            # On these inputs a key sits in at most one ring row at a time
            # (it is written only after a miss), so the function needs one
            # lookup per lane and step, as P1's table; the kernel's scan of
            # all 512 rows is the TPU's design, not the function's work.
            res["ablate_ring"] = result(
                errs["P2 ring"], p2[v][0], plain_ms, 8 * x.numel(),
                8 * x.numel())
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
    a_ms = cuda_ms(lambda: probe.affine(x), 20)
    a_lib = cuda_ms(lambda: x * 2 + 1, 20)
    rng = np.random.default_rng(0)
    for height in (8192, *probe_gpu.HEIGHTS):
        tab, idx = probe_gpu.gather_inputs(height, 128, rng)
        got = probe.gather_lanes(tab, idx)
        plain_ms, ref = once_ms(lambda: probe.gather_lanes_reference(tab, idx))
        errs[f"P4-b H={height}"] = max_abs_err((got,), (ref,))
        if height == 8192:
            idx64 = idx.long()
            res["probe_gather"] = result(
                errs["P4-b H=8192"], p4["b"][1], plain_ms,
                3 * 4 * idx.numel(), idx.numel(),
                cuda_ms(lambda: torch.gather(tab, 0, idx64), 20))
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
    say("probes", "every probe kernel == its plain version (max_abs_err 0): "
        + ", ".join(errs) + f"; launches {launches}")
    say("probes", "P1 ablate_parse ms by variant (G=2 B=4096 x 128 lanes): "
        + ", ".join(f"{v} {ms:.4f}" for v, (ms, _) in p1.items())
        + "; P2 ablate_ring ms (4096 steps x 1024 lanes, cell 512): "
        + ", ".join(f"{v} {ms:.4f}" for v, (ms, _) in p2.items()))
    say("probes", "P3 probe_scan best ms: " + ", ".join(
        f"{dt} T={t} {ms:.4f}" for t, by in p3.items()
        for dt, ms in by.items())
        + f"; int32/int16 at T=512 {p3[512]['int32'] / p3[512]['int16']:.3f}")
    say("probes", f"P4-a {a_ms:.4f} ms (library call x * 2 + 1 "
        f"{a_lib:.4f} ms); P4-b2 {p4['b2']:.1f} ns per dependent gather of "
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


def main() -> int:
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

    # 3. Kernel vs plain, all four flavors, 64 x 8 KiB.
    specs = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
             "tiff": LzwSpec.tiff(), "fixed": LzwSpec.fixed(Endianness.LITTLE)}
    for i, (label, spec) in enumerate(specs.items()):
        mat, lens = sample_blocks(spec, 64, 8192, seed=i)
        compare_kernels(spec, mat, lens, 8192, device, label, stride1=True)
    n_enc, n_pass1 = testdata.check_edge_cases(device)
    say("kernels", f"edge cases: encode_parse on {n_enc} cases and "
        f"decode_pass1 on {n_pass1} cases x 3 row kinds == plain exactly")

    # 4. The slice at full size.
    assets = ROOT / "test-assets"
    tokyo = load_tokyo_pixels(assets / "tokyo_128_colors.png")
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
               "decode_pass2": 0}, "facades")

    # 12. The entry module.
    add(run_entry())

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
    sys.exit(main())
