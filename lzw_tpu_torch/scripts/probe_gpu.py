"""Capability probes on the card for kernel-strategy selection.

The counterpart of the JAX package's ``scripts/probe_tpu.py``::

    python -m lzw_tpu_torch.scripts.probe_gpu [a|b|b3|c|d|e|all]

- a: an elementwise kernel, ``x * 2 + 1`` on i32[8, 128];
- b: the per-lane gather ``tab[idx[0, l], l]`` from an i32[8192, 128]
  table, then (b2) a loop of 256 dependent gathers: ns per gather of 128;
- b3: the gather at table heights 8, 16, 32, 64 and 512;
- c: the port's encode parse (``encode_parse`` + the 12-bit pack) on one
  and on 16 fixed-12 blocks of 4096 B, where the JAX probe timed its lax
  codec, which the port does not have;
- d: a lockstep dictionary lookup by masked compare over [8192, 1024] per
  step, as torch ops;
- e: a per-lane gather + scatter loop over [1024, 8192], as torch ops.

a, b, b2 and b3 run the kernels of ``kernels/csrc/probe_gather.cu``
(``kernels/probe.py``); every check prints OK or WRONG.  Inputs come from
``numpy.random.default_rng(seed)``; times are CUDA events.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lzw_tpu_torch.kernels import encode as tenc
from lzw_tpu_torch.kernels import probe
from lzw_tpu_torch.utils import card

HEIGHTS = (8, 16, 32, 64, 512)


def _ok(flag: bool) -> str:
    return "OK" if flag else "WRONG"


def gather_inputs(height: int, lanes: int, rng) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The probe's table i32[height, lanes] of 0, 1, 2, ... on the card and
    one row of random indices i32[1, lanes] into it."""
    dev = card.require_card()
    tab = torch.arange(height * lanes, dtype=torch.int32,
                       device=dev).reshape(height, lanes)
    idx = torch.from_numpy(rng.integers(0, height, (1, lanes))).to(
        torch.int32).to(dev)
    return tab, idx


def gather_ok(tab: torch.Tensor, idx: torch.Tensor) -> bool:
    """The gather kernel's output against numpy's indexing of the table."""
    out = probe.gather_lanes(tab, idx).cpu().numpy()
    expect = tab.cpu().numpy()[idx.cpu().numpy()[0], np.arange(tab.shape[1])]
    return bool((out[0] == expect).all())


def probe_a() -> bool:
    x = torch.arange(8 * 128, dtype=torch.int32,
                     device=card.require_card()).reshape(8, 128)
    ok = bool((probe.affine(x).cpu().numpy()
               == x.cpu().numpy() * 2 + 1).all())
    print(f"A basic kernel: {'OK' if ok else 'FAIL'}", flush=True)
    return ok


def probe_b(seed: int = 0) -> tuple[bool, float]:
    """Returns (the gather is right, ms per call)."""
    H = 8192
    tab, idx = gather_inputs(H, 128, np.random.default_rng(seed))
    ok = gather_ok(tab, idx)
    ms = card.cuda_ms(lambda: probe.gather_lanes(tab, idx), 20)
    print(f"B gather[{H},128] kernel: {_ok(ok)} {ms * 1e3:.1f}us", flush=True)
    return ok, ms


def probe_b2(seed: int = 0) -> float:
    """Gather repeated in a loop; returns ns per dependent gather of 128."""
    H, L, STEPS = 8192, 128, 256
    tab, idx = gather_inputs(H, L, np.random.default_rng(seed))
    ms = card.cuda_ms(lambda: probe.gather_loop(tab, idx, STEPS), 20)
    print(f"B2 looped gather: {ms / STEPS * 1e6:.0f} ns/gather-of-128",
          flush=True)
    return ms / STEPS * 1e6


def probe_b3(seed: int = 0) -> dict[int, bool]:
    """The gather at each table height; returns height -> right."""
    rng = np.random.default_rng(seed)
    res = {}
    for H in HEIGHTS:
        res[H] = gather_ok(*gather_inputs(H, 128, rng))
        print(f"B3 gather H={H}: {_ok(res[H])}", flush=True)
    return res


def probe_c(seed: int = 0) -> None:
    dev = card.require_card()
    B = 4096
    rng = np.random.default_rng(seed)
    for n in (1, 16):
        blocks = torch.from_numpy(
            rng.integers(0, 256, (n, B)).astype(np.uint8)).to(dev)
        lens = torch.full((n,), B, dtype=torch.int32, device=dev)
        dt = card.cuda_ms(lambda: tenc.encode_blocks_fixed(blocks, lens),
                          5) / 1e3
        if n == 1:
            print(f"C encode_parse fixed-12 {B}B: {dt * 1e3:.3f} ms = "
                  f"{B / dt / 1e6:.2f} MB/s/block", flush=True)
        else:
            print(f"C encode_parse fixed-12 x{n}: {dt * 1e3:.3f} ms = "
                  f"{n * B / dt / 1e6:.2f} MB/s", flush=True)


def probe_d(seed: int = 0) -> None:
    """Lockstep dictionary via masked compare over [H, L] per step."""
    dev = card.require_card()
    H, L, STEPS = 8192, 1024, 64
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.integers(0, 1 << 21, (H, L))).to(
        torch.int32).to(dev)
    keys = torch.from_numpy(rng.integers(0, 1 << 21, L)).to(
        torch.int32).to(dev)

    def run():
        acc = torch.zeros(L, dtype=torch.int32, device=dev)
        for i in range(STEPS):
            eq = tab == ((keys + i) & (H - 1))[None, :]
            acc = acc + torch.where(eq, 1, 0).amax(dim=0).to(torch.int32)
        return acc

    dt = card.cuda_ms(run, 5) / 1e3
    per_byte = dt / (STEPS * L)
    print(f"D onehot-scan [{H},{L}]: {dt / STEPS * 1e6:.1f} us/step = "
          f"{1 / per_byte / 1e6:.1f} MB/s equivalent", flush=True)


def probe_e(seed: int = 0) -> None:
    """Per-lane gather/scatter cost in a loop of torch ops."""
    dev = card.require_card()
    H, L, STEPS = 8192, 1024, 512
    rng = np.random.default_rng(seed)
    tab0 = torch.from_numpy(rng.integers(0, H, (L, H))).to(torch.int32).to(dev)
    idx0 = torch.from_numpy(rng.integers(0, H, L)).to(torch.int32).to(dev)
    lanes = torch.arange(L, device=dev)

    def run():
        tab, idx = tab0.clone(), idx0
        acc = torch.zeros(L, dtype=torch.int32, device=dev)
        for i in range(STEPS):
            got = tab.gather(1, idx.long()[:, None])[:, 0]
            if i & 1:
                tab[lanes, idx.long()] = got + 1
            idx = (idx + got) & (H - 1)
            acc = acc + got
        return acc

    dt = card.cuda_ms(run, 3) / 1e3
    print(f"E gather+scatter loop [{L},{H}]: {dt / STEPS * 1e6:.1f} us/step "
          f"= {STEPS * L / dt / 1e6:.1f} Mlookup/s -> "
          f"{STEPS * L / dt / 1e6:.1f} MB/s-equiv", flush=True)


def main(argv: list[str] | None = None) -> dict[str, object]:
    """Runs the probes that ``argv`` names (default all); returns each
    probe's result by name."""
    args = sys.argv[1:] if argv is None else argv
    which = args[0] if args else "all"
    if which not in ("a", "b", "b3", "c", "d", "e", "all"):
        raise SystemExit("usage: python -m lzw_tpu_torch.scripts.probe_gpu "
                         "[a|b|b3|c|d|e|all]")
    card.require_card()
    print(card.card_line(), flush=True)
    res: dict[str, object] = {}
    if which in ("all", "a"):
        res["a"] = probe_a()
    if which in ("all", "b"):
        res["b"] = probe_b()
        res["b2"] = probe_b2()
    if which in ("all", "b3"):
        res["b3"] = probe_b3()
    if which in ("all", "d"):
        probe_d()
    if which in ("all", "e"):
        probe_e()
    if which in ("all", "c"):
        probe_c()
    return res


if __name__ == "__main__":
    main()
