"""The LZWT block container (v1), written from its layout.

Layout (all integers little endian)::

    offset  size  field
    0       4     magic  b"LZWT"
    4       1     version (1)
    5       1     flavor: 0 = variable, 1 = fixed
    6       1     code_size (2..8; 8 for fixed)
    7       1     endianness: 0 = little, 1 = big
    8       1     strategy: 0 = default, 1 = tiff (early change)
    9       3     reserved (0)
    12      4     block_size (uncompressed bytes per block)
    16      4     n_blocks
    20      8     orig_size (total uncompressed bytes)
    28      4     reserved (0)
    32      4*n   per-block compressed byte lengths
    ...           concatenated block payloads

Each block is one stream of its wire format over ``block_size`` bytes of
the input (the last block the rest), its EOI widened as
:mod:`portbench.reference.lzw` describes (``fix_eoi``).
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference import lzw
from portbench.reference.lzw import Wire

MAGIC = b"LZWT"
HEADER = "<4sBBBBB3xIIQ4x"
HEADER_SIZE = struct.calcsize(HEADER)


class ContainerError(ValueError):
    """A container whose header or length table is malformed."""


def header(wire: Wire, block_size: int, n_blocks: int, orig_size: int) -> bytes:
    return struct.pack(HEADER, MAGIC, 1, 0 if wire.variable else 1,
                       wire.code_size, 0 if wire.little else 1,
                       1 if wire.early_change else 0, block_size, n_blocks,
                       orig_size)


def blocks_of(data: np.ndarray, block_size: int) -> list[np.ndarray]:
    """``data`` cut into rows of equal length: the full blocks as one
    u8[n, block_size] matrix, then the short last block, if any, alone."""
    full = len(data) // block_size
    groups = []
    if full:
        groups.append(data[: full * block_size].reshape(full, block_size))
    if len(data) > full * block_size:
        groups.append(data[full * block_size:][None, :])
    return groups


def _encode_rows(rows: np.ndarray, wire: Wire, flush: bool):
    codes, n_codes = lzw.parse(rows, wire, flush=flush)
    payload, lengths = lzw.pack(codes, n_codes, wire, fix_eoi=True)
    return payload, lengths, n_codes


def _run(jobs, executor):
    """``fn(*args)`` of each job, in order: in this process, or on the
    workers of ``executor``."""
    if executor is None:
        return [fn(*args) for fn, *args in jobs]
    futures = [executor.submit(fn, *args) for fn, *args in jobs]
    return [f.result() for f in futures]


def encode_many(inputs, wire: Wire, block_size: int, flush: bool = True,
                executor=None, shards: int = 1):
    """The container parts of each input: (payload u8, lengths
    i64[n_blocks], data codes i64[n_blocks]).  The full blocks of every
    input, which share one length, are cut into ``shards`` runs of rows,
    each parsed on a worker of ``executor`` (a process pool) when it is
    given; each short last block is a job of its own."""
    arrs = [np.frombuffer(d, np.uint8) if isinstance(d, bytes) else d
            for d in inputs]
    full = [len(a) // block_size for a in arrs]
    rows = np.concatenate([a[: f * block_size].reshape(f, block_size)
                           for a, f in zip(arrs, full)]) if sum(full) else \
        np.zeros((0, block_size), np.uint8)
    jobs = [(_encode_rows, part, wire, flush)
            for part in np.array_split(rows, max(1, min(shards, len(rows))))
            if len(part)]
    tails = [i for i, (a, f) in enumerate(zip(arrs, full))
             if len(a) > f * block_size]
    jobs += [(_encode_rows, arrs[i][full[i] * block_size:][None, :], wire,
              flush) for i in tails]
    done = _run(jobs, executor)
    n_split = len(jobs) - len(tails)
    body = [np.concatenate(col) for col in zip(*done[:n_split])] \
        if n_split else [np.zeros(0, np.uint8), np.zeros(0, np.int64),
                         np.zeros(0, np.int64)]
    payload, lengths, counts = body
    ends = np.concatenate([[0], np.cumsum(lengths)])
    parts, row = [], 0
    for i, f in enumerate(full):
        pay = payload[ends[row]:ends[row + f]]
        lens, cnt = lengths[row:row + f], counts[row:row + f]
        row += f
        if i in tails:
            t = done[n_split + tails.index(i)]
            pay = np.concatenate([pay, t[0]])
            lens = np.concatenate([lens, t[1]])
            cnt = np.concatenate([cnt, t[2]])
        parts.append((pay, lens, cnt))
    return parts


def assemble(wire: Wire, block_size: int, orig_size: int, payload: np.ndarray,
             lengths: np.ndarray) -> bytes:
    n = len(lengths)
    return (header(wire, block_size, n, orig_size)
            + np.asarray(lengths, "<u4").tobytes() + payload.tobytes())


def encode(data: bytes | np.ndarray, wire: Wire, block_size: int,
           flush: bool = True) -> bytes:
    """The container of ``data``; ``flush=False`` is the control's, each
    block without its last code."""
    (payload, lengths, _), = encode_many([data], wire, block_size, flush)
    return assemble(wire, block_size, len(data), payload, lengths)


def read_header(container: bytes):
    """(wire, block_size, n_blocks, orig_size, lengths i64[n_blocks])."""
    if len(container) < HEADER_SIZE:
        raise ContainerError("shorter than the header")
    (magic, version, flavor, code_size, endian, strategy, block_size,
     n_blocks, orig_size) = struct.unpack_from(HEADER, container, 0)
    if magic != MAGIC or version != 1 or flavor > 1 or endian > 1 \
            or strategy > 1:
        raise ContainerError("not an LZWT v1 header")
    wire = Wire.from_dict({
        "flavor": "variable" if flavor == 0 else "fixed",
        "code_size": code_size,
        "endianness": "little" if endian == 0 else "big",
        "strategy": "tiff" if strategy else "default"})
    end = HEADER_SIZE + 4 * n_blocks
    if len(container) < end:
        raise ContainerError("shorter than its length table")
    lengths = np.frombuffer(container, "<u4", n_blocks, HEADER_SIZE).astype(
        np.int64)
    if len(container) != end + int(lengths.sum()):
        raise ContainerError("payload bytes differ from the length table")
    return wire, block_size, n_blocks, orig_size, lengths


def decode(container: bytes, executor=None, shards: int = 1) -> bytes:
    """The bytes of every block, in order; the blocks cut into ``shards``
    runs decoded on the workers of ``executor`` when it is given."""
    wire, _, _, _, lengths = read_header(container)
    start = HEADER_SIZE + 4 * len(lengths)
    payload = np.frombuffer(container, np.uint8, offset=start)
    ends = np.cumsum(lengths)
    jobs = []
    for run in np.array_split(np.arange(len(lengths)),
                              max(1, min(shards, len(lengths)))):
        if len(run) == 0:
            continue
        lo = int(ends[run[0]] - lengths[run[0]])
        hi = int(ends[run[-1]])
        jobs.append((lzw.decode, payload[lo:hi], lengths[run], wire))
    outs = _run(jobs, executor)
    return b"".join(o.tobytes() for o in outs)
