"""Dictionary-shape statistics on the benchmark corpora, from the encoder.

The counterpart of the JAX package's ``scripts/analyze_dictionary.py``::

    python -m lzw_tpu_torch.scripts.analyze_dictionary [--device cuda|cpu]

For gif7 and fixed-12 over each corpus of ``utils.corpus.load_corpus`` it
prints the JAX script's lines: steps, miss rate, average and longest
phrase, and the children-per-parent histogram of the last dictionary
epoch.  The JAX script walks its own Python dictionary; here the numbers
come from :func:`lzw_tpu_torch.ops.encode.encode_block`'s slots, one row
per corpus on ``--device`` (default ``cuda``: the encode-parse kernel;
``cpu``: its plain version, slow past tens of KiB).  A miss is a filled
miss slot, a phrase runs from one miss's byte to the next, and each miss
that inserts adds a child to the code it emits.

The encoder resets its table at the miss after the one that inserts the
last code (``encode_parse.cu``, ``lzw_tpu/ops/encode.py:156-164``); the
JAX script resets right after that last insert, one miss earlier, so its
histogram of a variable flavor's last epoch after a reset is not the
encoder's.  The lines here are the encoder's.
"""

from __future__ import annotations

import argparse
import collections
import pathlib

import numpy as np
import torch

from lzw_tpu_torch.ops.encode import encode_block
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, MAX_WIDTH, Endianness, LzwSpec
from lzw_tpu_torch.utils.corpus import load_corpus

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "test-assets"


def dictionary_stats(data: bytes, spec: LzwSpec,
                     device: str | torch.device = "cuda") -> dict:
    """Misses, phrase lengths and the last epoch's children per parent of
    one stream's encode on ``device``.

    Returns ``steps`` (lookups after the first byte), ``misses``,
    ``phrases`` (i64 byte lengths of the phrases emitted at misses) and
    ``children`` (a Counter: children per parent -> parents).
    """
    n = len(data)
    row = torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy())
    res = encode_block(row[None].to(device),
                       torch.tensor([n], dtype=torch.int32, device=device),
                       spec)
    codes = res["codes"][0].cpu().numpy()
    widths = res["widths"][0].cpu().numpy()
    # Miss slots: 1 + 2i (variable) or 2i (fixed) for the miss at byte i;
    # a reset CLEAR follows its miss at 2 + 2i.
    first = 1 if spec.variable else 0
    miss = np.nonzero(widths[first : 2 * n : 2])[0]
    emitted = codes[first : 2 * n : 2][miss]
    phrases = np.diff(miss, prepend=0)
    if spec.variable:
        resets = np.nonzero(widths[2 : 2 * n + 1 : 2] == MAX_WIDTH)[0]
        # The last epoch's inserting misses: those after the last reset,
        # whose own miss inserts nothing.
        parents = emitted[miss > resets[-1]] if len(resets) else emitted
    else:
        # Fixed-12 inserts until the table holds 4096 codes, then freezes.
        parents = emitted[: MAX_TABLE_SIZE - spec.first_free_code]
    per_parent = np.bincount(parents)
    children = collections.Counter(per_parent[per_parent > 0].tolist())
    return {"steps": n - 1, "misses": len(miss), "phrases": phrases,
            "children": children}


def analyze(data: bytes, spec: LzwSpec, label: str,
            device: str | torch.device = "cuda") -> None:
    """Print the JAX script's two lines for ``data`` under ``spec``."""
    st = dictionary_stats(data, spec, device)
    phrases, child_hist = st["phrases"], st["children"]
    n_parents = sum(child_hist.values()) or 1
    avg_len = phrases.sum() / max(len(phrases), 1)
    max_len = int(phrases.max()) if len(phrases) else 0
    print(f"{label}:")
    print(f"  steps {st['steps']}, miss rate {st['misses'] / st['steps']:.2f}, "
          f"avg phrase {avg_len:.2f} B, max phrase {max_len}")
    top = {c: n for c, n in sorted(child_hist.items())[:5]}
    print(f"  children-per-parent histogram (top): {top} "
          f"(parents with 1 child: {child_hist.get(1, 0) / n_parents:.0%})")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for name, data in load_corpus(ASSETS).items():
        analyze(data, LzwSpec.gif(7), f"{name} / gif cs=7", args.device)
        analyze(data, LzwSpec.fixed(Endianness.LITTLE), f"{name} / fixed-12",
                args.device)


if __name__ == "__main__":
    main()
