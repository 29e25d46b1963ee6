"""Device busy share of a container decode, by route, on one CUDA card.

Run from the repository root::

    python3 -m lzw_tpu_torch.utils.profile_decode

For the gif7 image container (128 MiB, 64 KiB blocks) and the fixed-12 one
(32 MiB, 4 KiB blocks), and for each decode route (``pass2="host"`` and
``pass2="device"``): three timed decodes, then one decode under
``torch.profiler``.  It prints the profiled decode's wall time, the sum of
the device time of every kernel and copy (events on the device only, not
the host ops that launched them), their ratio (the busy share; one stream,
so nothing overlaps) and the eight largest device events.  Last, the
flat pass-2 wrapper at the gif7 shape beside its word-offset scan kernel
alone, by CUDA events.  Each number is printed beside the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from lzw_tpu_torch import BlockParallelCodec, Endianness, LzwSpec
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

ROOT = pathlib.Path(__file__).resolve().parents[2]
MiB = 1 << 20


def _tile(data: bytes, n: int) -> bytes:
    return (data * (n // len(data) + 1))[:n]


def _device_ms(evt) -> float:
    """Milliseconds an event ran on the device; 0 for host-side events (an
    ``aten::`` op's device time is that of the kernels it launched, which
    appear as events of their own)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    return evt.device_time_total / 1e3


def profile_route(label: str, codec: BlockParallelCodec, container: bytes,
                  data: bytes, top: int = 8) -> None:
    from torch.profiler import ProfilerActivity, profile

    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = codec.decode(container)
        dt = time.perf_counter() - t0
        if out != data:
            raise AssertionError(f"{label}: round trip differs")
        print(f"{label} decode rep {rep}: {dt * 1e3:.1f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.decode(container)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(((_device_ms(e), e.key) for e in prof.key_averages()
                     if _device_ms(e) > 0), reverse=True)
    busy = sum(ms for ms, _ in events)
    print(f"{label} profiled wall {wall:.1f} ms; device activity "
          f"{busy:.1f} ms; busy share {busy / wall:.3f}", flush=True)
    for ms, key in events[:top]:
        print(f"   {key[:70]:70s} {ms:.2f} ms")


def cuda_ms(fn, reps: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA device", file=sys.stderr)
        return 3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tokyo = load_tokyo_pixels(ROOT / "test-assets" / "tokyo_128_colors.png")
    cells = (("gif7 image", LzwSpec.gif(7), 1 << 16, 128 * MiB),
             ("fixed-12 image", LzwSpec.fixed(Endianness.LITTLE), 1 << 12,
              32 * MiB))
    for name, spec, block, size in cells:
        data = _tile(tokyo, size)
        container = BlockParallelCodec(spec, block_size=block,
                                       device="cuda:0").encode(data)
        for route in ("host", "device"):
            codec = BlockParallelCodec(spec, block_size=block, device="cuda:0",
                                       pass2=route)
            profile_route(f"{name} {route}", codec, container, data)

    # Pass 2 at the gif7 main shape: the flat wrapper and its scan kernel.
    spec = LzwSpec.gif(7)
    data = _tile(tokyo, 128 * MiB)
    container = BlockParallelCodec(spec, device="cuda:0").encode(data)
    _, payloads = framing.parse_frame(container)
    mat = np.zeros((len(payloads), max(len(p) for p in payloads)), np.uint8)
    plens = np.zeros(len(payloads), np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    p = tdec.variable_pass1(mat, plens, spec, 1 << 16, "cuda",
                           rows="stride2")
    wrapper = cuda_ms(lambda: tdec.decode_pass2_stride2_flat(
        p.dense, p.words, p.pair, p.counts_t, p.totals, 1 << 16, spec,
        p.sched))
    scan = cuda_ms(lambda: tdec.word_ends(p.words, p.counts_t, 1 << 16))
    print(f"{smi}: flat pass-2 wrapper {wrapper:.3f} ms, scan kernel "
          f"word_ends alone {scan:.3f} ms, at N={mat.shape[0]} "
          f"S={p.dense.shape[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
