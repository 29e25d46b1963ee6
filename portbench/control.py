"""The control of the comparison: the reference in the program's place, with
one of the configuration's guarantees broken.

The configurations state no precision, so the control breaks a guarantee:
every block is encoded without its last code, the prefix left when the
block's input ends (``portbench.reference.lzw.parse(flush=False)``), the
step a parallel encoder most easily loses.  Its containers are
well-formed and decode, short of each block's last word, so the
comparison has to find the lost bytes.  For a facade configuration the
control is the reference's one stream without its last code
(``portbench.reference.lzw.encode_stream(flush=False)``), with its EOI,
decoded by the lockstep decoder on its one stream.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

runs the harness at the cell's own size with the control as the codec,
one pass of the window over the cell's inputs a seed, and prints each
seed's numbers beside their limits.  It needs no card.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import pathlib
import sys
import time

import numpy as np

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import check, harness  # noqa: E402
from portbench.reference import container, lzw  # noqa: E402
from portbench.reference.lzw import Wire  # noqa: E402


class ReferenceCodec:
    """The reference as the configuration's codec, a container or one
    stream (a facade): ``flush=False`` is the control, ``True`` the
    reference itself, sound."""

    def __init__(self, config: dict, flush: bool = True, executor=None,
                 shards: int = 1):
        self.wire = Wire.from_dict(config["wire"])
        self.facade = harness.entry(config) == "facade"
        self.block_size = harness.block_size(config)
        self.flush = flush
        self.executor = executor
        self.shards = shards

    def encode(self, data: bytes) -> bytes:
        if self.facade:
            return lzw.encode_stream(data, self.wire, flush=self.flush)
        (payload, lengths, _), = container.encode_many(
            [data], self.wire, self.block_size, self.flush, self.executor,
            self.shards)
        return container.assemble(self.wire, self.block_size, len(data),
                                  payload, lengths)

    def decode(self, data: bytes) -> bytes:
        if self.facade:
            return lzw.decode(np.frombuffer(data, np.uint8), [len(data)],
                              self.wire).tobytes()
        return container.decode(data, self.executor, self.shards)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    import torch

    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, args.workload)
    try:
        _controls(cell, args.seed, torch.device("cpu"))
    finally:
        harness.end_children()
    return 0


def _controls(cell, seeds, device) -> None:
    """One control run a seed, on one pool of reference workers."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(harness.WORKERS,
                                                mp_context=ctx) as ex:
        def control(config, devices, stage_times=None):
            return ReferenceCodec(config, False, ex, harness.WORKERS)

        for seed in seeds:
            t0 = time.perf_counter()
            _, numbers = harness.run_cell(
                cell, seed, 0.0, False, [device], [], t0,
                make_codec=control, min_iterations=int(cell.mix["inputs"]),
                warm=False)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "numbers": numbers, "limits": check.LIMITS,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
