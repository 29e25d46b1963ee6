"""Pass 1's dictionary epochs, on the CPU: the kernel's layout, the
schedule's epoch shape it relies on, and its edge cases.

``csrc/decode_pass1.cu`` decodes a block with one CTA, the block's epochs
one after another, each epoch's steps at once; an epoch takes only the
offset, the last length and the stop of the epochs before it.  A CUDA
kernel has no interpret mode, so these tests hold what the kernel assumes
(its CTA against ``chains.DECODE_PASS1``, and epoch ``e`` of the schedule
rows at steps ``[e * P, (e + 1) * P)``) and hold the card-only cases of
``testdata.pass1_epoch_cases`` to the edge each claims, through the plain
version.  ``tests/test_torch_cuda.py`` holds the kernel on those cases.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from lzw_tpu_torch.kernels import build, chains
from lzw_tpu_torch.kernels import decode as tdec
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.spec import MAX_TABLE_SIZE, LzwSpec
from lzw_tpu_torch.utils import testdata

SPECS = {"gif7": LzwSpec.gif(7), "gif2": LzwSpec.gif(2),
         "gif8": LzwSpec.gif(8), "tiff": LzwSpec.tiff()}


def _constants() -> dict[str, int]:
    """The ``constexpr int`` constants of ``decode_pass1.cu``, each
    expression evaluated over the ones before it."""
    text = (pathlib.Path(build.CSRC) / "decode_pass1.cu").read_text()
    out: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) =\s*([^;]+);", text):
        out[name] = int(eval(" ".join(expr.split()), {}, dict(out)))
    return out


def test_layout_matches_the_source():
    k = _constants()
    assert chains.DECODE_PASS1 == (k["kThreads"], k["kSharedBytes"])
    assert k["kEpochSteps"] == k["kThreads"] * k["kPerThread"] == 4096
    assert chains.DECODE_PASS1.shared_bytes <= chains.MAX_SHARED_BYTES


@pytest.mark.parametrize("name", list(SPECS))
def test_schedule_rows_are_epochs_of_a_cta(name):
    # The kernel takes epoch e as steps [e * P, (e + 1) * P) with next
    # index first_free + k - 1 at step k >= 1, and a CTA holds its steps.
    spec = SPECS[name]
    P = tsched.epoch_steps(spec)
    assert P <= 4096 - spec.first_free_code + 1 <= 4096
    S = 3 * P + 17
    nxt, start = tsched.schedule_rows(spec, S)
    t = np.arange(S)
    k = t % P
    assert (start == t - k).all()
    assert (nxt == np.where(k == 0, spec.first_free_code - 1,
                            spec.first_free_code + k - 1)).all()


@functools.lru_cache(maxsize=None)
def _plain(index: int):
    """Case ``index`` of ``pass1_epoch_cases`` and the plain pass 1's
    words, totals, err and err_code on it, as NumPy arrays."""
    c = testdata.pass1_epoch_cases()[index]
    out = tdec.decode_pass1_reference(
        torch.from_numpy(c.codes), torch.from_numpy(c.n_codes), c.spec,
        c.block_size, None if c.sched is None else torch.from_numpy(c.sched))
    return c, [t.numpy() for t in out]


def _stop(words: np.ndarray) -> int:
    """A row's first hole (its length if none)."""
    holes = np.flatnonzero((words >> 29) == tdec.KIND_HOLE)
    return int(holes[0]) if len(holes) else len(words)


def _lens(words: np.ndarray) -> np.ndarray:
    return (words >> 17) & 0xFFF


P7 = tsched.epoch_steps(LzwSpec.gif(7))
FIXED_STEPS = MAX_TABLE_SIZE + 1 - 256
# Each claim: (case index, rows, check(case, (words, totals, err, err_code),
# row)).  Every row of a claim holds its check.
CLAIMS = {
    # n_codes past S: every step decodes.
    "counts past the row": (0, [0], lambda c, o, r: o[2][r] == 0
                            and _stop(o[0][r]) == c.codes.shape[1]),
    # n_codes at epoch 1, 2 and 3's first step: the holes start there.
    "counts on an epoch start": (0, [1, 2, 3], lambda c, o, r: o[2][r] == 0
                                 and _stop(o[0][r]) == c.n_codes[r]
                                 and c.n_codes[r] % P7 == 0),
    # A code past the next index at step 100 and step 1 of epoch 3.
    "past the next index in epoch 3": (
        0, [4, 5], lambda c, o, r: o[2][r] == 1
        and _stop(o[0][r]) in (3 * P7 + 100, 3 * P7 + 1)
        and o[3][r] == c.codes[r, _stop(o[0][r])]),
    # Stale non-root first codes (200, CLEAR, EOI, 4000) emit a literal 0,
    # and KwKwK after each copies both of the step's bytes.
    "stale first codes": (0, [6], lambda c, o, r: o[2][r] == 0 and all(
        o[0][r][e * P7] == ((tdec.KIND_LIT << 29) | (1 << 17))
        and c.codes[r, e * P7] >= c.spec.alphabet_size
        and o[0][r][e * P7 + 1] >> 17 == 2 for e in range(4))),
    # B passes block_size at epoch 2's first step.
    "overflow at an epoch start": (1, [0], lambda c, o, r: o[2][r] == 2
                                   and _stop(o[0][r]) == 2 * P7),
    # A passes it mid-epoch 2, where epoch 2's own words do not: only the
    # offset the epochs before it pass on shows the overflow.
    "overflow through the offset": (1, [1], lambda c, o, r: o[2][r] == 2
                                    and 2 * P7 < _stop(o[0][r])
                                    and _lens(o[0][r][2 * P7:_stop(
                                        o[0][r]) + 1]).sum()
                                    <= c.block_size),
    # D passes it inside epoch 1, though epoch 2's words are shorter.
    "overflow in an earlier epoch": (1, [2], lambda c, o, r: o[2][r] == 2
                                     and P7 < _stop(o[0][r]) < 2 * P7),
    "no overflow": (1, [3], lambda c, o, r: o[2][r] == 0
                    and o[1][r] <= c.block_size),
    # Fixed-12 rows that decode past the table's freeze, KwKwK on 4096
    # across the tail's chunk edge and at its first step, or stop at the
    # freeze, at the chunk edge and before the freeze.
    "fixed-12 frozen tail": (2, [0, 1, 2, 4, 6], lambda c, o, r: o[2][r] == 0
                             and _stop(o[0][r]) == min(c.n_codes[r],
                                                       c.codes.shape[1])),
    "fixed-12 KwKwK on 4096": (2, [1], lambda c, o, r: all(
        (o[0][r][j] >> 29) == tdec.KIND_COPY
        for j in range(FIXED_STEPS + 4096 - 6, FIXED_STEPS + 4096 + 6))),
    # A code past the next index in the tail (4100) and before the freeze.
    "fixed-12 past the next index": (2, [3, 7], lambda c, o, r: o[2][r] == 1
                                     and o[3][r] in (4100, 256 + 1999 + 5)
                                     and (_stop(o[0][r]) > FIXED_STEPS)
                                     == (r == 3)),
    "fixed-12 overflow in the tail": (2, [5], lambda c, o, r: o[2][r] == 2
                                      and FIXED_STEPS + 4096
                                      < _stop(o[0][r]) < c.codes.shape[1]),
}


@pytest.mark.parametrize("claim", list(CLAIMS))
def test_epoch_cases_show_their_edge(claim):
    index, rows, check = CLAIMS[claim]
    c, out = _plain(index)
    for r in rows:
        assert check(c, out, r), (claim, r)
