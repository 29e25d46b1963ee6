"""The one traffic generator: a mix's parameters in, a cell's inputs and
the times its requests arrive out.

A mix is a file ``portbench/traffic/<name>.json``.  Its keys:

* ``window``: how an input is cut from the configuration's corpus (read
  round, past its end to its start):

  - ``"block"``: each block of ``block_size`` bytes is a window of the
    corpus; every input of the cell holds the same blocks, each input in
    an order of its own drawn from the seed;
  - ``"call"``: each input is one window of ``bytes_per_call`` bytes;

* ``offsets``: where the windows start: ``"even"``, spread evenly over
  the corpus, the same for every seed; or ``"seed"``, drawn from the seed
  (distinct while the corpus has room);
* ``bytes_per_call``: the uncompressed bytes of each input (a whole
  number of blocks with ``"block"`` windows);
* ``inputs``: how many distinct inputs the requests cycle through, so that
  no request repeats the one before it;
* ``ops``: the calls of one request, in order, each ``"encode"`` or
  ``"decode"``.  A decode decodes the container the request's last encode
  returned or, where no encode came before it, the reference's container
  of the input, made in set-up (so ``["decode"]`` is a decode-only mix);
* ``loop``: ``"closed"``, each caller sends its next request when its last
  one returned; or ``"open"``, requests arrive at fixed times, whether or
  not the last one returned, and a call's latency counts from its
  request's arrival;
* ``callers``: how many callers send requests at once, each with a codec
  of its own;
* ``rate_per_s`` and ``arrivals`` (open loop only): requests a second, and
  ``"even"`` (one every ``1 / rate_per_s`` seconds) or ``"random"``
  (``rate_per_s`` a second on average, each at a time drawn from the
  seed);
* ``why``: one line on what the mix stands for.

No other key is read, and a file with another is refused.  Every seed
gives the same sizes and the same number of requests; the seed moves the
offsets, the blocks' orders and the random arrivals only.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

KEYS = {"window", "offsets", "bytes_per_call", "inputs", "ops", "loop",
        "callers", "rate_per_s", "arrivals", "why"}
OPEN_KEYS = {"rate_per_s", "arrivals"}
CHOICES = {"window": ("block", "call"), "offsets": ("even", "seed"),
           "loop": ("closed", "open"), "arrivals": ("even", "random")}
OPS = ("encode", "decode")


@dataclasses.dataclass
class Input:
    """One input: its bytes, and for ``"block"`` windows the distinct block
    rows (shared by every input of the cell) and the row of each block."""

    data: bytes
    rows: np.ndarray | None = None
    order: np.ndarray | None = None


def load_mix(path: str | pathlib.Path) -> dict:
    mix = json.loads(pathlib.Path(path).read_text())
    extra = set(mix) - KEYS
    if extra:
        raise ValueError(f"{path}: keys {sorted(extra)} are not read")
    is_open = mix.get("loop") == "open"
    if not is_open and OPEN_KEYS & set(mix):
        raise ValueError(f"{path}: {sorted(OPEN_KEYS & set(mix))} are for "
                         "an open loop only")
    for key, choices in CHOICES.items():
        if (is_open or key not in OPEN_KEYS) and mix.get(key) not in choices:
            raise ValueError(f"{path}: {key} {mix.get(key)!r} is not one of "
                             f"{choices}")
    ops = mix.get("ops")
    if not ops or not isinstance(ops, list) or any(op not in OPS
                                                   for op in ops):
        raise ValueError(f"{path}: ops {ops!r} are not a list of {OPS}")
    if int(mix["inputs"]) < 2 or int(mix["bytes_per_call"]) < 1:
        raise ValueError(f"{path}: needs inputs >= 2 and bytes_per_call >= 1")
    if int(mix.get("callers", 0)) < 1:
        raise ValueError(f"{path}: needs callers >= 1")
    if is_open and not float(mix.get("rate_per_s", 0)) > 0:
        raise ValueError(f"{path}: an open loop needs rate_per_s > 0")
    return mix


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A generator of the seed's own stream: any whole number is a seed."""
    return np.random.default_rng([seed % 2**64, *stream])


def _offsets(mix: dict, n: int, span: int, seed: int) -> np.ndarray:
    """``n`` window offsets in [0, span)."""
    if mix["offsets"] == "even":
        return np.arange(n) * span // n
    return rng_of(seed, 2).choice(span, n, replace=n > span)


def make_inputs(mix: dict, plane: np.ndarray, block_size: int,
                seed: int) -> list[Input]:
    """The distinct inputs of a cell, from ``--seed``."""
    n_bytes = int(mix["bytes_per_call"])
    count = int(mix["inputs"])
    P = len(plane)
    width = block_size if mix["window"] == "block" else n_bytes
    ring = np.concatenate([plane] * (-(-(P + width) // P)))
    windows = np.lib.stride_tricks.sliding_window_view(ring, width)
    if mix["window"] == "call":
        return [Input(windows[o].tobytes())
                for o in _offsets(mix, count, P, seed)]
    if n_bytes % block_size:
        raise ValueError(f"bytes_per_call {n_bytes} is not a whole number "
                         f"of {block_size}-byte blocks")
    n_blocks = n_bytes // block_size
    rows = windows[_offsets(mix, n_blocks, P, seed)]
    orders = [rng_of(seed, 1, i).permutation(n_blocks) for i in range(count)]
    return [Input(rows[o].tobytes(), rows, o) for o in orders]


def arrivals(mix: dict, seconds: float, seed: int,
             at_least: int = 1) -> np.ndarray | None:
    """The times, in seconds from the window's start, at which an open
    loop's requests arrive: ``round(rate_per_s * seconds)`` of them (at
    least ``at_least``), the same number for every seed.  None for a
    closed loop."""
    if mix["loop"] != "open":
        return None
    rate = float(mix["rate_per_s"])
    n = max(at_least, round(rate * seconds))
    if mix["arrivals"] == "even":
        return np.arange(n) / rate
    span = max(seconds, n / rate)
    return np.sort(rng_of(seed, 3).uniform(0.0, span, n))


def needs_containers(mix: dict) -> bool:
    """Whether a request decodes before it encodes: its container is then
    the reference's, made in set-up."""
    return mix["ops"][0] == "decode"

