"""What fills an encode chain step on the card::

    python -m lzw_tpu_torch.scripts.chain_probe [--sass DIR]

Times three dependent chains through a 64 KiB table in shared memory
(``csrc/chain_probe.cu``, :func:`lzw_tpu_torch.kernels.probe.chain_steps`),
each by one thread and by a whole warp on the same values, in ``clock64``
cycles and in ns by CUDA events: ``load`` (the bare dependent shared
load), ``parse`` (``encode_parse.cu``'s hit step: the multiply-add and
``__umulhi`` hash, then the entry's code) and ``stream``
(``stream_encode.cu``'s: one LOP3 from the loaded link to the next
entry), and ``branch`` and ``store``, the load chain with a global store
on about one step in four (an encoder's miss) behind a data-dependent
branch, or made every step with the count advanced by a select.  Each chain's last value is checked against the plain loop (OK or
WRONG).  With ``--sass DIR`` it also writes ``cuobjdump -sass`` of the
``encode_parse`` and ``stream_encode`` libraries to ``DIR/<name>.sass``.
Prints the card's name and power limit first; raises without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

from lzw_tpu_torch.kernels import build, probe
from lzw_tpu_torch.utils import card

STEPS = 1 << 20


def table(mode: str, seed: int = 0) -> tuple[np.ndarray, int]:
    """The chain's table (u32 words as i32[CHAIN_WORDS]) and start: a
    random cycle of word indices for ``load``, ``branch`` and ``store``,
    random codes for
    ``parse``, and for ``stream`` u64 entries whose high word is a link
    (a multiple of 16 below 64 KiB)."""
    rng = np.random.default_rng(seed)
    n = probe.CHAIN_WORDS
    if mode in ("load", "branch", "store"):
        order = rng.permutation(n)
        tab = np.empty(n, np.int64)
        tab[order] = np.roll(order, -1)
        return tab.astype(np.int32), int(order[0])
    tab = rng.integers(0, 1 << 31, n).astype(np.int64)
    if mode == "stream":
        tab[1::2] &= 0xFFF0
    return tab.astype(np.int32), 16 * int(rng.integers(0, 4096))


def run(steps: int = STEPS) -> list[str]:
    dev = card.require_card()
    lines = []
    for mode in probe.CHAIN_MODES:
        host, start = table(mode)
        tab = torch.from_numpy(host).to(dev)
        want = probe.chain_steps_reference(torch.from_numpy(host), start,
                                           mode, 4096)
        for lanes in (1, 32):
            _, got = probe.chain_steps(tab, start, mode, lanes, 4096)
            cycles, _ = probe.chain_steps(tab, start, mode, lanes, steps)
            ms = card.events_ms([lambda: probe.chain_steps(
                tab, start, mode, lanes, steps)])
            lines.append(
                f"[chain] {mode} lanes={lanes}: {cycles / steps:.2f} "
                f"cycles a step, {ms * 1e6 / steps:.2f} ns a step by CUDA "
                f"events ({cycles / (ms * 1e6):.3f} GHz over the launch); "
                f"value == plain: {'OK' if got == want else 'WRONG'}")
    return lines


def sass(out_dir: pathlib.Path) -> list[str]:
    """``cuobjdump -sass`` of the two encode kernels' libraries."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tool = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    lines = []
    for name in ("encode_parse", "stream_encode"):
        text = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        (out_dir / f"{name}.sass").write_text(text)
        lines.append(f"[sass] {name}: {len(text.splitlines())} lines -> "
                     f"{out_dir / f'{name}.sass'}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    card.require_card()
    print(card.card_line(), flush=True)
    lines = run()
    if args.sass is not None:
        lines += sass(args.sass)
    print("\n".join(lines))
    return 0 if all("WRONG" not in s for s in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
