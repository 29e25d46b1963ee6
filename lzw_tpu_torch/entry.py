"""Entry points: one batched encode step on a device, and a round trip of
the container over several devices.

The counterpart of the JAX package's ``__graft_entry__.py``::

    python -m lzw_tpu_torch.entry          # on the visible CUDA devices
"""

from __future__ import annotations

import numpy as np
import torch

from lzw_tpu_torch.kernels.encode import encode_blocks_codes, pack12
from lzw_tpu_torch.parallel.block import BlockParallelCodec, default_devices
from lzw_tpu_torch.spec import Endianness, LzwSpec

__all__ = ["entry", "dryrun_multichip"]

BLOCK_SIZE = 4096


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, example_args)``: the batched fixed-12 (little-endian)
    block encode, the encode-parse kernel then ``pack12``, on 4 blocks of
    4096 random bytes from ``default_rng(0)`` on ``device``.

    ``fn(blocks, lens)`` gives (payloads u8[N, PB], lengths i32[N], err
    i32[N]); row n's payload is ``payloads[n, :lengths[n]]``.  On the CPU
    the kernel's plain version runs.
    """
    spec = LzwSpec.fixed(Endianness.LITTLE)

    def forward(blocks: torch.Tensor, lens: torch.Tensor):
        dense, counts, err, _ = encode_blocks_codes(blocks, lens, spec)
        buf, n_bytes = pack12(dense, counts, little=True)
        return buf, n_bytes, err

    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(
        rng.integers(0, 256, size=(4, BLOCK_SIZE)).astype(np.uint8)).to(device)
    lens = torch.full((4,), BLOCK_SIZE, dtype=torch.int32, device=device)
    return forward, (blocks, lens)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Encode and decode a container split over ``n_devices`` devices: the
    first ``n_devices`` visible CUDA devices, or with ``device_type="cpu"``
    the CPU named ``n_devices`` times (the kernels' plain versions).  Fixed-12
    little-endian and GIF cs=8 at 512-byte blocks, ``verify=True``, on
    ``n_devices * 512 + 17`` random bytes from ``default_rng(7)``; raises
    when a round trip differs."""
    if device_type == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        devices = default_devices(device_type)[:n_devices]
        if len(devices) != n_devices:
            raise RuntimeError(
                f"need {n_devices} {device_type} devices, have "
                f"{len(devices)}")
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=n_devices * 512 + 17).astype(
        np.uint8).tobytes()
    for spec in (LzwSpec.fixed(Endianness.LITTLE), LzwSpec.gif(8)):
        codec = BlockParallelCodec(spec, block_size=512, device=devices,
                                   verify=True)
        if codec.decode(codec.encode(data)) != data:
            raise RuntimeError(f"multichip round trip failed for {spec}")
    print(f"dryrun_multichip({n_devices}): encode+decode round-trip OK")


if __name__ == "__main__":
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() run OK")
    dryrun_multichip(torch.cuda.device_count())
