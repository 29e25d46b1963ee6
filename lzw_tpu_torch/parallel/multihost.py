"""Block ranges split over processes, on ``torch.distributed``.

Port of ``lzw_tpu/parallel/multihost.py``.  Each process (rank) encodes or
decodes its contiguous range of blocks with its local
:class:`~lzw_tpu_torch.parallel.block.BlockParallelCodec`, which splits the
range again over the process's own devices; then every rank gathers every
rank's payloads, or decoded bytes, in block order, so each one assembles the
whole result.

The exchange is two fixed-shape ``all_gather``s, as the JAX package's
``process_allgather`` takes them: first the lengths, then the bytes padded
to the global maximum; nothing is pickled.  The bytes are host bytes, so a
``gloo`` group gathers CPU tensors; an ``nccl`` group gathers them on this
rank's current CUDA device (``torch.cuda.set_device``): NCCL refuses two
ranks on one GPU.

A single process (no initialised group, or a group of one) is the local
codec itself.  ``torch.distributed`` learns of no cluster by itself: give
:func:`initialize` the address (``init_method="tcp://host:port"``), the
world size and the rank.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.parallel.block import (
    BlockParallelCodec, _part_slice as _process_slice, local_devices,
)
from lzw_tpu_torch.spec import LzwSpec

__all__ = ["initialize", "MultiHostBlockCodec", "process_count",
           "process_index"]


def initialize(**kwargs) -> None:
    """Initialise the ``torch.distributed`` process group with
    ``init_process_group(**kwargs)``; a no-op when it is already
    initialised or when the run is a single process (``world_size``, from
    the arguments or ``$WORLD_SIZE``, below 2)."""
    if _initialized():
        return
    world = int(kwargs.get("world_size", -1))
    if world == -1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2:
        return
    dist.init_process_group(**kwargs)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks of the group, 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if _initialized() else 0


class MultiHostBlockCodec:
    """Block-parallel codec sharding block ranges across processes.

    Each process encodes/decodes its contiguous range of blocks on its local
    devices, then the payload bytes are all-gathered so every process
    assembles the full container in submission order.

    Args:
      spec: the wire spec.
      block_size: uncompressed bytes per block.
      local_codec: the codec of this process's range; by default a
        :class:`BlockParallelCodec` over :func:`local_devices`.
    """

    def __init__(self, spec: LzwSpec, block_size: int = 1 << 16,
                 local_codec: BlockParallelCodec | None = None):
        self.spec = spec
        self.block_size = block_size
        self.local = local_codec or BlockParallelCodec(
            spec, block_size, device=local_devices()
        )

    # ---- encode --------------------------------------------------------------

    def encode(self, data: bytes) -> bytes:
        """Compress; every process must pass identical ``data``.

        For host-sharded inputs use :meth:`encode_shards` with per-host
        chunks.
        """
        n_proc = process_count()
        if n_proc == 1:
            return self.local.encode(data)
        n_blocks = math.ceil(len(data) / self.block_size)
        lo, hi = _process_slice(n_blocks, process_index(), n_proc)
        local_payloads = self._encode_payloads_of(
            data[lo * self.block_size : hi * self.block_size])
        all_payloads = _exchange_block_payloads(local_payloads, n_blocks)
        return framing.pack_frame(
            self.spec, self.block_size, len(data), all_payloads
        )

    def encode_shards(self, shard: bytes, total_size: int) -> bytes:
        """Compress host-sharded input: process p holds blocks [lo_p, hi_p).

        ``shard`` must be exactly this process's contiguous byte range under
        the balanced block split of a ``total_size``-byte stream (the same
        split :meth:`encode` computes); every process receives the full
        container.
        """
        n_proc = process_count()
        if n_proc == 1:
            if len(shard) != total_size:
                raise ValueError("single-process shard must be the whole input")
            return self.local.encode(shard)
        n_blocks = math.ceil(total_size / self.block_size)
        lo, hi = _process_slice(n_blocks, process_index(), n_proc)
        expect = self._range_size(total_size, lo, hi)
        if len(shard) != expect:
            raise ValueError(
                f"process {process_index()} shard is {len(shard)} bytes, "
                f"expected {expect}"
            )
        local_payloads = self._encode_payloads_of(shard)
        all_payloads = _exchange_block_payloads(local_payloads, n_blocks)
        return framing.pack_frame(
            self.spec, self.block_size, total_size, all_payloads
        )

    def _encode_payloads_of(self, chunk: bytes) -> list[bytes]:
        if not chunk:
            return []
        _, payloads = framing.parse_frame(self.local.encode(chunk))
        return [bytes(p) for p in payloads]

    # ---- decode --------------------------------------------------------------

    def decode(self, container: bytes) -> bytes:
        """Decompress; every process passes the container and receives the
        whole output."""
        n_proc = process_count()
        if n_proc == 1:
            return self.local.decode(container)
        header, payloads = framing.parse_frame(container)
        lo, hi = _process_slice(header.n_blocks, process_index(), n_proc)
        local_out = b"" if lo >= hi else self.local.decode(
            framing.pack_frame(
                self.spec, self.block_size,
                self._range_size(header.orig_size, lo, hi),
                [bytes(p) for p in payloads[lo:hi]],
            )
        )
        # One decoded blob per process, gathered in process order; idle
        # processes contribute an empty blob.  Concatenation in process
        # order is submission order because the block split is contiguous.
        out = b"".join(_exchange_blobs(local_out))
        if len(out) != header.orig_size:
            raise framing.FramingError(
                f"decoded {len(out)} bytes, container claims "
                f"{header.orig_size}"
            )
        return out

    def _range_size(self, total: int, lo: int, hi: int) -> int:
        end = min(hi * self.block_size, total)
        return max(0, end - lo * self.block_size)


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this rank's
    current CUDA device on ``nccl``, else the CPU."""
    if dist.get_backend() == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(arr: np.ndarray) -> np.ndarray:
    """``all_gather`` of an array of the same shape on every rank:
    [ranks, *arr.shape], in rank order."""
    dev = _comm_device()
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def _exchange_block_payloads(local: list[bytes],
                             n_blocks: int) -> list[bytes]:
    """All-gather per-process payload lists, reassembled in block order.

    The gathers need identical shapes on every process, so each side pads
    its list to the balanced per-process maximum (``ceil(n/P)``) and its
    payload matrix to the *global* maximum payload length (one gather of the
    lengths first).  Reconstruction slices per process using the same
    deterministic split: no sentinel decoding of padding rows.
    """
    n_proc = dist.get_world_size()
    per = math.ceil(n_blocks / n_proc) if n_blocks else 1
    lens = np.zeros(per, np.int64)
    lens[: len(local)] = [len(p) for p in local]
    all_lens = _all_gather(lens)  # [P, per]
    gmax = int(all_lens.max()) if all_lens.size else 0
    buf = np.zeros((per, max(gmax, 1)), np.uint8)
    for i, p in enumerate(local):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    all_bufs = _all_gather(buf)  # [P, per, gmax]
    out: list[bytes] = []
    for p in range(n_proc):
        lo, hi = _process_slice(n_blocks, p, n_proc)
        for j in range(hi - lo):
            out.append(all_bufs[p, j, : all_lens[p, j]].tobytes())
    if len(out) != n_blocks:
        raise RuntimeError(f"gathered {len(out)} payloads for {n_blocks} "
                           "blocks")
    return out


def _exchange_blobs(local: bytes) -> list[bytes]:
    """All-gather one variable-length blob per process, in process order."""
    all_n = _all_gather(np.array([len(local)], np.int64)).reshape(-1)
    gmax = int(all_n.max()) if all_n.size else 0
    buf = np.zeros(max(gmax, 1), np.uint8)
    if local:
        buf[: len(local)] = np.frombuffer(local, np.uint8)
    all_bufs = _all_gather(buf)
    return [all_bufs[p, : all_n[p]].tobytes() for p in range(len(all_n))]
