"""Launch geometry of the one-chain-per-warp encode kernel, and the CTAs
of the single-stream encode kernel and of decode pass 1.

``csrc/encode_parse.cu`` runs one LZW block's chain per warp, with the
block's dictionary and a small staging window of its inputs in dynamic
shared memory; a warp that finishes its block takes another
(``csrc/warp_chain.cuh``).  This module computes the grid from the card's
SM count and the kernel's occupancy; the occupancy query is the only part
that needs the card.  ``csrc/stream_encode.cu`` and ``csrc/decode_pass1.cu``
launch a CTA of fixed shape per row or block (:class:`CtaLayout`).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

from lzw_tpu_torch.kernels import build

__all__ = ["Layout", "LAYOUTS", "CtaLayout", "STREAM_ENCODE",
           "STREAM_ENCODE_CHUNK", "DECODE_PASS1",
           "MAX_SHARED_BYTES", "Geometry", "geometry", "ctas_per_sm",
           "launch_geometry", "chains_in_flight"]

# Dynamic shared memory one CTA may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232448


class Layout(NamedTuple):
    """A kernel's CTA: ``warps`` chains, each with ``chain_bytes`` of shared
    memory (its dictionary and its staging window)."""

    warps: int
    chain_bytes: int


# The sizes are the kernels' own (kChainBytes in each source).
LAYOUTS = {
    # 7168 u32 hash slots and a 48-int window: 8 chains per SM.
    "encode_parse": Layout(8, 4 * 7168 + 4 * 48),
}


class CtaLayout(NamedTuple):
    """A kernel's CTA: ``threads`` threads and ``shared_bytes`` of dynamic
    shared memory; its launch function refuses any other."""

    threads: int
    shared_bytes: int


# ``csrc/stream_encode.cu``'s CTA, one a row (warp 0 runs the chain, warp
# 1 fills the ring), the source's kThreads and kSharedBytes: the table
# (16384 u64 slots, two a bucket), the ring of 4 spans, each a chunk of
# STREAM_ENCODE_CHUNK bytes with 16 before it and 48 after it, as prefix
# hashes (u32, one more and 3 spare a span) and as bytes, and two u32
# counters in a 16-byte slot; every flavor takes the same CTA, one an SM.
STREAM_ENCODE_CHUNK = 4096
STREAM_ENCODE = CtaLayout(
    64, 8 * 16384 + 4 * 4 * (STREAM_ENCODE_CHUNK + 64 + 4)
    + 4 * (STREAM_ENCODE_CHUNK + 64) + 16)

# ``csrc/decode_pass1.cu``'s CTA, one a block (kThreads, kSharedBytes): by
# step of an epoch (4096 at most), the code (i32), the forest link (u32),
# the local offset (i32), the word's length (u16) and first byte (u8).
DECODE_PASS1 = CtaLayout(1024, 4096 * (4 + 4 + 4 + 2 + 1))

_ctas: dict[tuple[str, int], int] = {}
_ctas_lock = threading.Lock()


class Geometry(NamedTuple):
    """A launch: ``grid`` CTAs of ``warps`` warps with ``shared_bytes`` of
    dynamic shared memory; ``chains`` warps in all, each taking at most
    ``rounds`` blocks."""

    grid: int
    warps: int
    shared_bytes: int
    chains: int
    rounds: int


def geometry(layout: Layout, n_blocks: int, sms: int,
             ctas: int) -> Geometry:
    """The launch of ``layout`` for ``n_blocks`` blocks on ``sms`` SMs that
    hold ``ctas`` CTAs each: no more CTAs than fit the card at once, and no
    more than the blocks need.  Raises ValueError when the tables do not
    fit a CTA or no CTA fits the card."""
    warps, chain = layout
    shared = warps * chain
    if not 1 <= warps <= 32 or shared > MAX_SHARED_BYTES:
        raise ValueError(f"{warps} warps need {shared} bytes of shared "
                         f"memory; a CTA has at most {MAX_SHARED_BYTES}")
    if sms < 1 or ctas < 1:
        raise ValueError(f"no CTA fits: {sms} SMs x {ctas} CTAs")
    if n_blocks <= 0:
        return Geometry(0, warps, shared, 0, 0)
    grid = min(math.ceil(n_blocks / warps), sms * ctas)
    chains = grid * warps
    return Geometry(grid, warps, shared, chains, math.ceil(n_blocks / chains))


def ctas_per_sm(name: str, device) -> int:
    """CTAs of kernel ``name`` that one SM holds at its layout
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, after the shared
    limit is set); raises when the card refuses the shared memory or fits
    none."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (name, index)
    with _ctas_lock:
        if key not in _ctas:
            _ctas[key] = _query_ctas(name, index)
        return _ctas[key]


def _query_ctas(name: str, index: int) -> int:
    warps, chain = LAYOUTS[name]
    fn = build.bound(name, f"{name}_occupancy")
    out = ctypes.c_int(0)
    with build.on_device(torch.device("cuda", index)):
        rc = fn(warps, warps * chain, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"kernel {name}: occupancy query failed: CUDA "
                           f"error {rc}")
    if out.value < 1:
        raise RuntimeError(f"kernel {name}: no CTA of {warps} warps fits "
                           "an SM")
    return out.value


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_geometry(name: str, n_blocks: int, device) -> Geometry:
    """:func:`geometry` of kernel ``name`` on the CUDA ``device``."""
    return geometry(LAYOUTS[name], n_blocks, _sms(device),
                    ctas_per_sm(name, device))


def chains_in_flight(name: str, device) -> int:
    """Chains the card runs at once: CTAs per SM x warps x SMs."""
    return ctas_per_sm(name, device) * LAYOUTS[name].warps * _sms(device)
