#!/usr/bin/env python3
"""Smoke run of the lzw_tpu_torch main path on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

1. device: the CUDA card's name and ``nvidia-smi`` name and power limit;
2. build: compiles both CUDA kernels from ``lzw_tpu_torch/kernels/csrc``
   (nvcc, sm_90a) and the native runtime from ``lzw_tpu/native``;
3. kernel vs plain: the encode-parse and pass-1 kernels against their plain
   PyTorch versions on the card, exact equality, for gif7, gif2, tiff and
   fixed-12 on 64 blocks x 8 KiB of random and compressible data;
4. the slice: ``BlockParallelCodec(LzwSpec.gif(7), device="cuda")`` on
   128 MiB (2048 x 64 KiB blocks) of the tiled image corpus and of the tiled
   text corpus: every payload equal to the native runtime's encoder, a
   byte-exact round trip, the launch counts of both kernels, stage and end
   to end MiB/s; then both kernels against their plain versions at the
   main path's shapes;
5. a 32 MiB fixed-12 round trip at 4 KiB blocks with the same checks.

It prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.  It imports nothing of
JAX or of the JAX package ``lzw_tpu``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
MiB = 1 << 20
ENCODE_SRC = "lzw_tpu_torch/kernels/csrc/encode_parse.cu"
DECODE_SRC = "lzw_tpu_torch/kernels/csrc/decode_pass1.cu"
# The TPU kernels the two CUDA kernels replace (file:line of the kernel
# function; see PERF.md for the whole table).
ENCODE_REPLACES = "lzw_tpu/kernels/encode_pallas.py:501"
DECODE_REPLACES = "lzw_tpu/kernels/decode_pallas.py:128"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def compare_kernels(spec, mat, lens, block, device, label):
    """Both kernels against their plain versions on the same CUDA inputs.

    Returns per-kernel (max_abs_err, kernel ms, plain ms)."""
    import torch

    from lzw_tpu_torch.kernels import decode as tdec
    from lzw_tpu_torch.kernels import encode as tenc

    blocks_t = torch.from_numpy(mat).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    enc = tenc.encode_blocks_codes(blocks_t, lens_t, spec)
    plain_ms_e, enc_ref = once_ms(
        lambda: tenc.encode_blocks_codes_reference(blocks_t, lens_t, spec))
    err_e = max_abs_err(enc, enc_ref)
    ms_e = cuda_ms(lambda: tenc.encode_blocks_codes(blocks_t, lens_t, spec))
    dense, counts = enc[0], enc[1]
    codes, n_codes, sched_t = pass1_inputs(spec, dense, counts, device)
    dec = tdec.decode_pass1(codes, n_codes, spec, block, sched_t)
    plain_ms_d, dec_ref = once_ms(lambda: tdec.decode_pass1_reference(
        codes, n_codes, spec, block, sched_t))
    err_d = max_abs_err(dec, dec_ref)
    ms_d = cuda_ms(lambda: tdec.decode_pass1(codes, n_codes, spec, block,
                                             sched_t))
    if err_e or err_d:
        raise AssertionError(
            f"{label}: kernel != plain (encode max_abs_err {err_e}, "
            f"pass 1 max_abs_err {err_d})"
        )
    if int(enc[2].abs().sum()) or int(dec[2].abs().sum()):
        raise AssertionError(f"{label}: unexpected error flags")
    say("kernels", f"{label}: N={mat.shape[0]} B={block} "
        f"codes={int(counts.sum())} max code/block={int(counts.max())}; "
        f"encode_parse {ms_e:.3f} ms (plain {plain_ms_e:.1f} ms), "
        f"decode_pass1 {ms_d:.3f} ms (plain {plain_ms_d:.1f} ms), "
        "kernel == plain exactly")
    return {"encode_parse": (err_e, ms_e, plain_ms_e),
            "decode_pass1": (err_d, ms_d, plain_ms_d)}


def run_container(spec, data: bytes, block: int, label: str,
                  device="cuda"):
    """Encode + decode through BlockParallelCodec with every check; returns
    (end-to-end seconds of encode, of decode, stage times, launches)."""
    import numpy as np
    import torch

    from lzw_tpu_torch import BlockParallelCodec
    from lzw_tpu_torch.kernels import build
    from lzw_tpu_torch.native.runtime import get_runtime
    from lzw_tpu_torch.parallel import framing

    size = len(data)
    # Stage breakdown (each stage ends in a synchronise); also the warm-up.
    stages: dict[str, float] = {}
    codec = BlockParallelCodec(spec, block_size=block, device=device,
                               stage_times=stages)
    container = codec.encode(data)
    if codec.decode(container) != data:
        raise AssertionError(f"{label}: staged round trip differs")
    # End to end, with the launch counts of exactly this run.
    codec = BlockParallelCodec(spec, block_size=block, device=device)
    build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    container2 = codec.encode(data)
    t1 = time.perf_counter()
    out = codec.decode(container2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    if container2 != container:
        raise AssertionError(f"{label}: two encodes differ")
    if out != data:
        k = next(i for i, (a, b) in enumerate(zip(out, data)) if a != b)
        raise AssertionError(f"{label}: round trip differs at byte {k}")
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
    for name in build.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{label}: kernel {name} never launched")
    ratio = len(container) / size
    mib = size / MiB
    say("slice", f"{label}: {mib:.0f} MiB in {size // block} blocks of "
        f"{block} B, ratio {ratio:.4f}; payloads == native encoder, round "
        f"trip exact; launches {launches}")
    say("slice", f"{label}: end to end encode {mib / (t1 - t0):.1f} MiB/s "
        f"({(t1 - t0) * 1e3:.1f} ms), decode {mib / (t2 - t1):.1f} MiB/s "
        f"({(t2 - t1) * 1e3:.1f} ms)")
    say("slice", f"{label}: stages (MiB/s over {mib:.0f} MiB): " + ", ".join(
        f"{k} {mib / v:.1f} ({v * 1e3:.1f} ms)" for k, v in stages.items()))
    return launches


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
    from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say("device", f"{kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    device = torch.device("cuda", 0)

    # 2. Build.
    for name in build.KERNELS:
        t0 = time.perf_counter()
        build.load(name)
        say("build", f"{name}: nvcc {build.find_nvcc()} sm_90a, "
            f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    runtime.get_runtime()
    say("build", f"native runtime from {runtime.SOURCE.relative_to(ROOT)}: "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. Kernel vs plain, all four flavors, 64 x 8 KiB.
    specs = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
             "tiff": LzwSpec.tiff(), "fixed": LzwSpec.fixed(Endianness.LITTLE)}
    for i, (label, spec) in enumerate(specs.items()):
        mat, lens = sample_blocks(spec, 64, 8192, seed=i)
        compare_kernels(spec, mat, lens, 8192, device, label)

    # 4. The slice at full size.
    assets = ROOT / "test-assets"
    tokyo = load_tokyo_pixels(assets / "tokyo_128_colors.png")
    lorem = (assets / "lorem_ipsum.txt").read_bytes()
    gif7 = LzwSpec.gif(7)
    total = {name: 0 for name in build.KERNELS}
    for label, corpus in (("gif7 image", tokyo), ("gif7 text", lorem)):
        launches = run_container(gif7, tile(corpus, 128 * MiB), 1 << 16,
                                 label)
        for name in total:
            total[name] += launches[name]
    # Both kernels at the main path's shapes (not counted as launches).
    data = np.frombuffer(tile(tokyo, 128 * MiB), np.uint8)
    mat = data.reshape(-1, 1 << 16).copy()
    lens = np.full(mat.shape[0], 1 << 16, np.int32)
    full = compare_kernels(gif7, mat, lens, 1 << 16, device,
                           "gif7 image main-path shape")

    # 5. Fixed-12 container, 32 MiB at 4 KiB blocks.
    run_container(LzwSpec.fixed(Endianness.LITTLE), tile(tokyo, 32 * MiB),
                  1 << 12, "fixed-12 image")

    kernels = []
    for name, src, rep in (("encode_parse", ENCODE_SRC, ENCODE_REPLACES),
                           ("decode_pass1", DECODE_SRC, DECODE_REPLACES)):
        err, ms, plain_ms = full[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": total[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
