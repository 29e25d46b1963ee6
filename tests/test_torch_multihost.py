"""Block ranges split over processes (``torch.distributed``), on the CPU.

Mirrors tests/test_multihost.py: the single-process invariants, and real
``gloo`` process groups on localhost whose ranks round-trip uneven block
counts (idle ranks), host-sharded encode and empty input, each assembling
byte-identical containers that equal the JAX package's single-process
container of the same data.

The worker of the multi-process cases is this module run as a script::

    python tests/test_torch_multihost.py <port> <n_procs> <rank> <outdir>
"""

import ast
import hashlib
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The cases of tests/multihost_worker.py (the same block counts, splits and
# sizes in blocks) at 1 KiB blocks, where it has 4 KiB: the plain versions
# keep the two ranks inside the test's time limit.
BS = 1024
_BASE = np.random.default_rng(7).integers(
    0, 128, size=3 * BS + 250).astype(np.uint8)
CASES = {
    "uneven": _BASE.tobytes(),               # 4 blocks
    "tiny": _BASE[:100].tobytes(),           # 1 block
    "empty": b"",
    "exact": _BASE[: 2 * BS].tobytes(),      # 2 full blocks
}
FLAVORS = ("fixed", "gif")


def _specs():
    from lzw_tpu_torch import Endianness, LzwSpec

    return {"fixed": LzwSpec.fixed(Endianness.LITTLE), "gif": LzwSpec.gif(7)}


def _codec(spec):
    from lzw_tpu_torch.parallel import BlockParallelCodec, MultiHostBlockCodec

    return MultiHostBlockCodec(
        spec, BS, local_codec=BlockParallelCodec(spec, BS, device="cpu"))


def _digest(container: bytes) -> str:
    return hashlib.sha256(container).hexdigest()


def _worker(port: int, n_procs: int, rank: int, outdir: str) -> int:
    """One rank: every case through encode and decode, and the sharded
    encode of "uneven"; writes its results to ``outdir/proc<rank>.out``."""
    import torch
    import torch.distributed as dist

    from lzw_tpu_torch.parallel import multihost

    # Two ranks share the host's cores with the test run.
    torch.set_num_threads(1)
    multihost.initialize(backend="gloo",
                         init_method=f"tcp://127.0.0.1:{port}",
                         world_size=n_procs, rank=rank)
    if multihost.process_count() != n_procs:
        raise RuntimeError("the group did not form")
    results = {}
    for flavor, spec in _specs().items():
        codec = _codec(spec)
        for name, data in CASES.items():
            container = codec.encode(data)
            results[f"{flavor}.{name}.ok"] = codec.decode(container) == data
            results[f"{flavor}.{name}.digest"] = _digest(container)
    # Host-sharded encode: each rank holds only its own byte range.
    codec = _codec(_specs()["fixed"])
    data = CASES["uneven"]
    lo, hi = multihost._process_slice(-(-len(data) // BS), rank, n_procs)
    container = codec.encode_shards(data[lo * BS : hi * BS], len(data))
    results["shards.ok"] = codec.decode(container) == data
    results["shards.digest"] = _digest(container)
    dist.destroy_process_group()
    pathlib.Path(outdir, f"proc{rank}.out").write_text(repr(results))
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_digests() -> dict[str, str]:
    """The JAX package's single-process containers of every case."""
    from lzw_tpu.parallel.multihost import MultiHostBlockCodec as JaxCodec
    from lzw_tpu.spec import Endianness as JEndianness
    from lzw_tpu.spec import LzwSpec as JSpec

    specs = {"fixed": JSpec.fixed(JEndianness.LITTLE), "gif": JSpec.gif(7)}
    out = {}
    for flavor, spec in specs.items():
        codec = JaxCodec(spec, block_size=BS)
        for name, data in CASES.items():
            out[f"{flavor}.{name}.digest"] = _digest(codec.encode(data))
    out["shards.digest"] = out["fixed.uneven.digest"]
    return out


def _run_workers(n_procs, tmp_path, timeout):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(n_procs), str(rank),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=env) for rank in range(n_procs)]
    try:
        want = _jax_digests()
        t_end = time.monotonic() + timeout
        outputs = [p.communicate(timeout=max(t_end - time.monotonic(), 1))[0]
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = [ast.literal_eval((tmp_path / f"proc{r}.out").read_text())
               for r in range(n_procs)]
    return results, want


def _check(results, want):
    for r in results:
        for key, val in r.items():
            if key.endswith(".ok"):
                assert val is True, f"{key} failed: {r}"
    # Every rank assembled the JAX package's single-process container.
    for key, digest in want.items():
        assert {r[key] for r in results} == {digest}, key


def test_two_process_gloo_round_trip(tmp_path):
    results, want = _run_workers(2, tmp_path, timeout=25)
    _check(results, want)


@pytest.mark.slow
def test_three_process_gloo_round_trip(tmp_path):
    results, want = _run_workers(3, tmp_path, timeout=120)
    _check(results, want)


def test_process_slice_balance():
    from lzw_tpu.parallel.multihost import _process_slice as jax_slice

    from lzw_tpu_torch.parallel.multihost import _process_slice

    for n_blocks in (0, 1, 7, 64, 65):
        for n_proc in (1, 2, 3, 4):
            spans = [_process_slice(n_blocks, p, n_proc)
                     for p in range(n_proc)]
            assert spans == [jax_slice(n_blocks, p, n_proc)
                             for p in range(n_proc)]
            assert spans[0][0] == 0
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c
            assert spans[-1][1] == n_blocks


@pytest.mark.parametrize("flavor", FLAVORS)
def test_single_process_round_trip(flavor):
    from lzw_tpu_torch.parallel import multihost

    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    data = np.random.default_rng(0).integers(
        0, 128, size=20000).astype(np.uint8).tobytes()
    codec = _codec(_specs()[flavor])
    container = codec.encode(data)
    assert container == codec.local.encode(data)
    assert codec.decode(container) == data
    assert codec.encode_shards(data, len(data)) == container
    with pytest.raises(ValueError, match="whole input"):
        codec.encode_shards(data[:100], len(data))


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    import torch.distributed as dist

    from lzw_tpu_torch.parallel import multihost

    def refuse(**kwargs):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()
    multihost.initialize(backend="gloo", world_size=1, rank=0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize(backend="gloo")
    assert not dist.is_initialized()


if __name__ == "__main__":
    port, n_procs, rank, outdir = sys.argv[1:5]
    sys.exit(_worker(int(port), int(n_procs), int(rank), outdir))
