"""Block-parallel LZW over one or more torch devices: the LZWT container.

Port of ``lzw_tpu/parallel/block.py``.  Input is cut into independently
dictionaried blocks (the same LZWT container, byte-identical to the JAX
package's), and payloads are gathered in submission order.  The block rows
are split into contiguous ranges, one per device of the codec (the split
of ``lzw_tpu/parallel/multihost.py:_process_slice``; the counterpart of
the JAX codec's ``shard_map`` over a ``Mesh``); each range runs the
single-device pipeline below on a worker thread of its own, under its
device, and the results are joined in block order.  One range runs in the
calling thread.

Encode: host prep -> H2D -> encode-parse kernel -> device bit-pack -> D2H
of the payload bytes.  Decode: host count recovery -> H2D -> device unpack
-> pass-1 kernel, then pass 2 by the ``pass2`` route:

* host: D2H of the descriptors -> the native runtime's ``apply_words``;
* device: the scan and pass-2 kernels, which write the blocks' bytes back
  to back -> one D2H of them into pinned memory.  Non-strict
  (foreign early-CLEAR) streams are split at their CLEARs on the host and
  decode on the device too (:mod:`lzw_tpu_torch.kernels.nonstrict`).

By default a CUDA codec takes the device route for strict blocks and the
native runtime's threaded decoder for non-strict ones.

Decode runs in steps with a join between them, so the result and the
error never depend on the number of ranges or on which thread ends first:
the count recovery of every range, then, only when every block is strict,
each range's device work up to pass 1 (and the pass-2 kernel), then, only
when no block failed pass 1, each range's D2H or host pass 2.  The error
raised is that of the first failing block in container order.  A
non-strict block anywhere sends the whole container down the non-strict
route, as one device would: the native runtime's ``decode_blocks``, or the
non-strict device route on the codec's first device.

On a CPU device the kernels' plain versions run.

Left out against the JAX codec: the padding of the batch to power-of-two
rows and kernel groups (XLA's static shapes), the lax-codec path, and the
TPU's "non-cell block size -> native encode" route (the CUDA kernel takes
any block size).
"""

from __future__ import annotations

import contextlib
import math
import subprocess
import threading
import time
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.decode import (
    MAX_BLOCK, decode_fixed_all_device, decode_pass1_fixed,
    decode_variable_all_device, prepare_variable_decode, variable_pass1,
)
from lzw_tpu_torch.kernels.encode import encode_blocks_codes, pack12
from lzw_tpu_torch.kernels.nonstrict import decode_variable_nonstrict_device
from lzw_tpu_torch.native.runtime import NativeRuntime, get_runtime
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.spec import (
    Endianness,
    LzwError,
    LzwSpec,
    UnexpectedCodeError,
    VerificationError,
)

__all__ = ["BlockParallelCodec", "DEFAULT_BLOCK_SIZE",
           "DEFAULT_FIXED_BLOCK_SIZE", "default_devices", "local_devices"]

DEFAULT_BLOCK_SIZE = 1 << 16
# The fixed flavor freezes its dictionary after 4096 entries, so small blocks
# re-learn and usually compress better.
DEFAULT_FIXED_BLOCK_SIZE = 1 << 12
PASS2_ROUTES = ("auto", "device", "host")
_NO_CUDA = ("BlockParallelCodec(device='cuda') needs a CUDA device, and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain versions")


def default_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every visible device of ``device_type`` in index order, the
    counterpart of ``default_mesh``: the CUDA devices that
    ``CUDA_VISIBLE_DEVICES`` leaves, or the CPU.  Raises RuntimeError when
    no CUDA device is visible."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r} is not 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """This process's devices, the counterpart of ``local_mesh``.  A torch
    process addresses only the devices it sees, so these are
    :func:`default_devices`; a rank that should use fewer is launched with
    ``CUDA_VISIBLE_DEVICES``."""
    return default_devices(device_type)


def _resolve_devices(device) -> tuple[torch.device, ...]:
    """The codec's devices: "cuda" without an index is every visible CUDA
    device, any other single device itself, a sequence its entries."""
    if isinstance(device, (str, torch.device)):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            return tuple(default_devices("cuda"))
        devices = (dev,)
    elif isinstance(device, Sequence):
        devices = tuple(torch.device(d) for d in device)
    else:
        raise TypeError(f"device must be a device or a sequence of them, "
                        f"not {type(device).__name__}")
    if not devices:
        raise ValueError("the device list is empty")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"devices of one type only, got {list(devices)}")
    if devices[0].type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        for d in devices:
            if d.index is None or d.index >= torch.cuda.device_count():
                raise ValueError(
                    f"{d} in a device list: name each CUDA device by one of "
                    f"the {torch.cuda.device_count()} visible indices")
    return devices


def _part_slice(n_blocks: int, part: int, parts: int) -> tuple[int, int]:
    """Contiguous block range [lo, hi) of one of ``parts`` parts, balanced
    (``ceil(n_blocks / parts)`` blocks each, the last ones possibly fewer
    or none)."""
    per = math.ceil(n_blocks / parts)
    lo = min(part * per, n_blocks)
    hi = min(lo + per, n_blocks)
    return lo, hi


class _Range(NamedTuple):
    """Blocks [lo, hi) of a container, handled on ``device``."""

    device: torch.device
    lo: int
    hi: int


def _no_stage(name: str):
    return contextlib.nullcontext()


def _on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _read_exact(src, n: int) -> bytes:
    """Read exactly n bytes unless EOF (short reads happen on pipes/sockets)."""
    parts = []
    got = 0
    while got < n:
        chunk = src.read(n - got)
        if not chunk:
            break
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _payload_matrix(payloads, width: int):
    mat = np.zeros((len(payloads), width), np.uint8)
    plens = np.zeros(len(payloads), np.int32)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    return mat, plens


class BlockParallelCodec:
    """Container-format codec over the blocks of one or more devices.

    Args:
      spec: the wire spec.
      block_size: uncompressed bytes per block (64 KiB variable, 4 KiB fixed
        by default).
      device: a torch device or a sequence of them; the block rows are split
        into one contiguous range per entry.  "cuda" without an index is
        every visible CUDA device (:func:`default_devices`), "cuda:i" that
        one; a device named twice runs two ranges at once.  CUDA raises
        without a card; a list of CPU devices runs the plain versions.
      verify: decode-check the largest payload of each encode on the host
        (default: on for CUDA devices, where the kernels are in the path).
      stage_times: a dict that, when given, accumulates the seconds of each
        pipeline stage; each stage then ends in a synchronisation of its
        device.  With several devices a stage's key is ``"<stage>@<device>"``
        (``"dec_pass1@cuda:1"``), the sum over that device's ranges; the
        join of the ranges' bytes into the result is timed as a stage of
        the whole codec, with the plain key: ``dec_d2h_out`` (the ranges'
        D2H into one host buffer, then one copy) and ``dec_apply_words``
        (the copy of the host pass 2's blocks).
      pass2: where decode resolves pass 1's descriptors.  "auto" (the
        default) picks from the device: on CUDA the pass-2 kernel for
        strict blocks and the native ``decode_blocks`` for non-strict ones;
        elsewhere the native runtime for both; the device route wherever
        the runtime cannot build.  "host" forces the native runtime's
        ``apply_words`` (raises when it cannot build); "device" forces the
        pass-2 kernel for every block, strict or not, and decode never
        touches the native runtime (block_size at most ``MAX_BLOCK``).
    """

    def __init__(self, spec: LzwSpec, block_size: int | None = None,
                 device: str | torch.device | Sequence = "cuda",
                 verify: bool | None = None,
                 stage_times: dict[str, float] | None = None,
                 pass2: str = "auto"):
        spec.validate()
        if block_size is None:
            block_size = (
                DEFAULT_BLOCK_SIZE if spec.variable else DEFAULT_FIXED_BLOCK_SIZE
            )
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        if pass2 not in PASS2_ROUTES:
            raise ValueError(f"pass2 {pass2!r} is not one of {PASS2_ROUTES}")
        if pass2 == "device" and block_size > MAX_BLOCK:
            raise ValueError(
                f"pass2='device' decodes blocks of at most {MAX_BLOCK} bytes, "
                f"not {block_size}"
            )
        self.devices = _resolve_devices(device)
        # The first device; every device of the list has its type.
        self.device = self.devices[0]
        self.spec = spec
        self.block_size = block_size
        self.verify = self.device.type == "cuda" if verify is None else bool(
            verify)
        self.stage_times = stage_times
        self._stage_lock = threading.Lock()
        self.pass2 = pass2

    # ---- ranges, threads and stages --------------------------------------

    def _ranges(self, n_blocks: int) -> list[_Range]:
        """The non-empty block ranges of ``n_blocks`` blocks, one per device
        entry at most, in block order."""
        k = len(self.devices)
        out = []
        for i, dev in enumerate(self.devices):
            lo, hi = _part_slice(n_blocks, i, k)
            if lo < hi:
                out.append(_Range(dev, lo, hi))
        return out

    @staticmethod
    def _map(fn, ranges: list[_Range], states=None) -> list:
        """``fn(range)``, or ``fn(range, state)`` with the range's entry of
        ``states``, for every range under its device: in this thread for
        one range, else on one worker thread per range.  Returns the results
        in block order; when ranges raise, the exception of the first of
        them in block order is raised, whichever thread ended first."""
        if states is None:
            args = [(r,) for r in ranges]
        else:
            args = list(zip(ranges, states))

        def run(a):
            with _on_device(a[0].device):
                return fn(*a)

        if len(args) == 1:
            return [run(args[0])]
        with ThreadPoolExecutor(len(args),
                                thread_name_prefix="lzw-range") as pool:
            futures = [pool.submit(run, a) for a in args]
        return [f.result() for f in futures]

    def _stage_fn(self, device: torch.device | None = None):
        """The stage timer of work on ``device``, or with None of the codec
        as a whole: ``stage(name)`` is a context manager that, with
        ``stage_times`` given, synchronises the device (or every device)
        around its body and adds the seconds under the stage's key (with a
        lock: ranges run on several threads)."""
        if self.stage_times is None:
            return _no_stage
        key = "" if device is None or len(self.devices) == 1 else f"@{device}"
        devices = self.devices if device is None else (device,)

        def sync():
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        @contextlib.contextmanager
        def stage(name: str):
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            dt = time.perf_counter() - t0
            with self._stage_lock:
                self.stage_times[name + key] = (
                    self.stage_times.get(name + key, 0.0) + dt)

        return stage

    # ---- public API ----------------------------------------------------------

    def encode(self, data: bytes) -> bytes:
        """Compress to the LZWT container."""
        data = bytes(data)
        n_blocks = math.ceil(len(data) / self.block_size) if data else 0
        if n_blocks == 0:
            return framing.pack_frame(self.spec, self.block_size, 0, [])
        arr = np.frombuffer(data, np.uint8)
        per_range = self._map(lambda r: self._encode_range(r, arr),
                              self._ranges(n_blocks))
        payloads = [p for part in per_range for p in part]
        if self.verify:
            self._verify_sample(data, payloads)
        return framing.pack_frame(self.spec, self.block_size, len(data),
                                  payloads)

    def _encode_range(self, r: _Range, arr: np.ndarray) -> list[bytes]:
        """The payloads of blocks [r.lo, r.hi) of ``arr``, encoded on
        ``r.device``; raises the error of the range's first failing
        block."""
        stage = self._stage_fn(r.device)
        bs = self.block_size
        n = r.hi - r.lo
        src = arr[r.lo * bs : r.hi * bs]
        with stage("enc_host_prep"):
            blocks = np.zeros((n, bs), np.uint8)
            lens = np.full(n, bs, np.int32)
            full = len(src) // bs
            blocks[:full] = src[: full * bs].reshape(full, bs)
            rem = len(src) - full * bs
            if rem:
                blocks[full, :rem] = src[full * bs :]
                lens[full] = rem
        with stage("enc_h2d"):
            blocks_t = torch.from_numpy(blocks).to(r.device)
            lens_t = torch.from_numpy(lens).to(r.device)
        with stage("enc_kernel"):
            dense, counts, errs, err_codes = encode_blocks_codes(
                blocks_t, lens_t, self.spec
            )
        errs = errs.cpu().numpy()
        if errs.any():
            i = int(np.argmax(errs != 0))
            raise UnexpectedCodeError(
                int(err_codes[i]), self.spec.code_size
            )
        with stage("enc_pack"):
            if self.spec.variable:
                # Pack only the columns some block filled.
                width = max(int(counts.max()), 1)
                bufs, n_bytes = _sched.pack_variable(
                    dense[:, :width], counts, self.spec, fix_eoi=True
                )
            else:
                little = self.spec.endianness is Endianness.LITTLE
                bufs, n_bytes = pack12(dense, counts, little)
                bufs = bufs[:, : int(n_bytes.max())]
        with stage("enc_d2h"):
            bufs = bufs.cpu().numpy()
            n_bytes = n_bytes.cpu().numpy()
        return [bufs[i, : n_bytes[i]].tobytes() for i in range(n)]

    def _verify_sample(self, data: bytes, payloads: list[bytes]) -> None:
        """Decode-check the largest payload of the batch against its source
        on the host: the native runtime, or where it cannot build, the
        kernels' plain versions on the CPU (blocks of at most
        ``MAX_BLOCK`` bytes; larger ones raise the build error).  Raises
        :class:`VerificationError` on a mismatch."""
        i = max(range(len(payloads)), key=lambda k: len(payloads[k]))
        bs = self.block_size
        expect = data[i * bs : (i + 1) * bs]
        try:
            rt = get_runtime()
        except (OSError, subprocess.CalledProcessError):
            if bs > MAX_BLOCK:
                raise
            rt = None
        try:
            if rt is not None:
                got = rt.decode(payloads[i], self.spec)
            else:
                plain = BlockParallelCodec(self.spec, bs, device="cpu",
                                           pass2="device", verify=False)
                got = plain.decode(framing.pack_frame(
                    self.spec, bs, len(expect), [payloads[i]]))
        except LzwError as exc:
            raise VerificationError(i, f"decode failed: {exc}") from exc
        if got != expect:
            k = next(
                (j for j, (a, b) in enumerate(zip(got, expect)) if a != b),
                min(len(got), len(expect)),
            )
            raise VerificationError(
                i, f"{len(got)}/{len(expect)} bytes, first diff at {k}"
            )

    def decode(self, container: bytes) -> bytes:
        """Decompress an LZWT container (order-preserving gather)."""
        header, payloads = framing.parse_frame(bytes(container))
        # Wire-equivalence, not dataclass equality: any spec constructor that
        # names the same byte format decodes the container.
        if not header.spec.wire_equivalent(self.spec):
            raise framing.FramingError(
                f"container spec {header.spec} != codec spec {self.spec}"
            )
        if header.n_blocks == 0:
            return b""
        out = None
        if self.block_size <= MAX_BLOCK:
            if self.spec.variable:
                # None: a non-strict (foreign early-CLEAR) stream.
                out = self._decode_variable(payloads)
                if out is None and self._native() is None:
                    out = self._decode_variable_nonstrict(payloads)
            else:
                out = self._decode_fixed(payloads)
        if out is None:
            # Blocks past the descriptor bound, or non-strict streams with
            # the native runtime at hand: its threaded decoder.
            out = get_runtime().decode_blocks(
                [bytes(p) for p in payloads], self.spec, self.block_size
            )
        if len(out) != header.orig_size:
            raise framing.FramingError(
                f"decoded {len(out)} bytes, container claims "
                f"{header.orig_size}"
            )
        return out

    def _native(self) -> NativeRuntime | None:
        """The native runtime, or None with ``pass2="device"`` or when
        ``pass2="auto"`` and it cannot build."""
        if self.pass2 == "device":
            return None
        if self.pass2 == "host":
            return get_runtime()
        try:
            return get_runtime()
        except (OSError, subprocess.CalledProcessError):
            return None

    def _host_pass2(self) -> NativeRuntime | None:
        """The runtime that resolves strict blocks' descriptors, or None for
        the pass-2 kernel.  "auto" takes the kernel on a CUDA device (it
        beat ``apply_words`` end to end on every strict container measured
        on the H100, PERF.md) and the host off it, when the runtime
        builds."""
        if self.pass2 == "auto" and self.device.type == "cuda":
            return None
        return self._native()

    def _decode_fixed(self, payloads) -> bytes:
        rt = self._host_pass2()
        little = self.spec.endianness is Endianness.LITTLE
        bs = self.block_size

        def pass1(r: _Range):
            stage = self._stage_fn(r.device)
            sub = payloads[r.lo : r.hi]
            with stage("dec_host_prep"):
                width = ((max(len(p) for p in sub) + 2) // 3) * 3
                mat, plens = _payload_matrix(sub, max(width, 3))
            with stage("dec_h2d"):
                mat_t = torch.from_numpy(mat).to(r.device)
                plens_t = torch.from_numpy(plens).to(r.device)
            if rt is None:
                out, _, errs, err_codes = decode_fixed_all_device(
                    mat_t, plens_t, bs, little, stage, flat=True)
                return _host(errs), _host(err_codes), out
            with stage("dec_pass1"):
                words, _, _, errs, err_codes, codes = decode_pass1_fixed(
                    mat_t, plens_t, bs, little)
            return _host(errs), _host(err_codes), (words, codes)

        ranges = self._ranges(len(payloads))
        states = self._map(pass1, ranges)
        self._raise_pass1(states)
        return self._finish(rt, ranges, [s[2] for s in states])

    def _decode_variable(self, payloads) -> bytes | None:
        """Strict-schedule decode; None when any block is non-strict.  The
        count recovery of every range comes first, so a batch the host
        finds non-strict makes no H2D and launches nothing."""
        rt = self._host_pass2()
        bs = self.block_size

        def recover(r: _Range):
            stage = self._stage_fn(r.device)
            sub = payloads[r.lo : r.hi]
            with stage("dec_host_prep"):
                mat, plens = _payload_matrix(sub, max(len(p) for p in sub))
            with stage("dec_count_recovery"):
                prep = prepare_variable_decode(mat, plens, self.spec)
            return mat, plens, prep

        def pass1(r: _Range, state):
            mat, plens, prep = state
            stage = self._stage_fn(r.device)
            if rt is None:
                out, _, errs, err_codes, strict = decode_variable_all_device(
                    mat, plens, self.spec, bs, r.device, stage, flat=True,
                    prep=prep)
                return strict, (_host(errs), _host(err_codes), out)
            p = variable_pass1(mat, plens, self.spec, bs, r.device,
                               stage=stage, prep=prep)
            return p.strict, (_host(p.err), _host(p.err_code),
                              (p.words, p.dense))

        ranges = self._ranges(len(payloads))
        recovered = self._map(recover, ranges)
        if not all(state[2][1].all() for state in recovered):
            return None
        passed = self._map(pass1, ranges, recovered)
        # Control codes in data slots show only in the device unpack.
        if not all(strict.all() for strict, _ in passed):
            return None
        states = [s for _, s in passed]
        self._raise_pass1(states)
        return self._finish(rt, ranges, [s[2] for s in states])

    def _decode_variable_nonstrict(self, payloads) -> bytes:
        """Foreign early-CLEAR blocks: split at their CLEARs on the host,
        every epoch decoded on the codec's first device."""
        def run(r: _Range):
            stage = self._stage_fn(r.device)
            with stage("dec_host_prep"):
                mat, plens = _payload_matrix(
                    payloads, max(len(p) for p in payloads))
            return b"".join(decode_variable_nonstrict_device(
                mat, plens, self.spec, self.block_size, r.device, stage))

        return self._map(run, [_Range(self.device, 0, len(payloads))])[0]

    @staticmethod
    def _raise_pass1(states) -> None:
        """Raise the pass-1 error of the first failing block in container
        order: ``states`` are the ranges' (errs, err_codes, ...) in block
        order."""
        for errs, err_codes, _ in states:
            if errs.any():
                i = int(np.argmax(errs != 0))
                raise UnexpectedCodeError(int(err_codes[i]))

    def _finish(self, rt, ranges: list[_Range], states) -> bytes:
        """Every range's bytes after a pass 1 without errors, in block
        order, copied once into the result: the flat walks' bytes (one
        pinned host buffer, each range's D2H into its slice), or with
        ``rt`` the host's pass 2 over (words, codes)."""
        if rt is None:
            return self._fetch(ranges, states)
        bs = self.block_size

        def apply(r: _Range, state) -> list[np.ndarray]:
            words, codes = state
            stage = self._stage_fn(r.device)
            with stage("dec_d2h_words"):
                words = words.cpu().numpy()
            with stage("dec_apply_words"):
                outs, tlens = rt.apply_words(words, bs, codes=codes)
                return [outs[i, : tlens[i]] for i in range(len(tlens))]

        per_range = self._map(apply, ranges, states)
        with self._stage_fn()("dec_apply_words"):
            return b"".join(b for blocks in per_range for b in blocks)

    def _fetch(self, ranges: list[_Range], flats) -> bytes:
        """The ranges' flat bytes, back to back in block order (the walks
        wrote each range's blocks back to back), as ``bytes``: one pinned
        host buffer, each range's D2H into its slice, then one copy."""
        ends = np.cumsum([flat.numel() for flat in flats])
        with self._stage_fn()("dec_d2h_out"):
            host = torch.empty(int(ends[-1]), dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")

            def copy(r: _Range, i: int):
                dst = host[ends[i] - flats[i].numel() : ends[i]]
                dst.copy_(flats[i], non_blocking=True)
                if r.device.type == "cuda":
                    torch.cuda.current_stream(r.device).synchronize()

            self._map(copy, ranges, range(len(ranges)))
            return host.numpy().tobytes()

    # ---- streaming container API ----------------------------------------------

    def encode_stream(self, src, dst, batch_blocks: int = 256) -> int:
        """Compress ``src`` into ``dst`` as an LZWS record stream.

        ``batch_blocks`` blocks are read, encoded as one batch and written
        as records before the next batch is read, so memory is O(batch).
        Returns the number of *uncompressed* bytes consumed.
        """
        framing.write_stream_header(dst, self.spec, self.block_size)
        total = 0
        while True:
            chunk = _read_exact(src, self.block_size * batch_blocks)
            if not chunk:
                break
            total += len(chunk)
            _, payloads = framing.parse_frame(self.encode(chunk))
            for p in payloads:
                framing.write_stream_record(dst, bytes(p))
        framing.write_stream_end(dst, total)
        return total

    def decode_stream(self, src, dst, batch_blocks: int = 256) -> int:
        """Decompress an LZWS record stream; returns bytes written.

        Only the final block of the stream may be shorter than block_size.
        """
        spec, block_size = framing.read_stream_header(src)
        if not spec.wire_equivalent(self.spec):
            raise framing.FramingError(
                f"stream spec {spec} != codec spec {self.spec}"
            )
        if block_size != self.block_size:
            raise framing.FramingError(
                f"stream block size {block_size} != codec {self.block_size}"
            )
        written = 0
        blocks_done = 0
        batch: list[bytes] = []
        orig_size = None

        def flush(records: list[bytes], final: bool):
            nonlocal written, blocks_done
            if not records:
                return
            if final:
                sub_orig = orig_size - blocks_done * self.block_size
            else:
                # Every record with a successor is a full block.
                sub_orig = len(records) * self.block_size
            out = self.decode(framing.pack_frame(
                self.spec, self.block_size, sub_orig, records
            ))
            dst.write(out)
            written += len(out)
            blocks_done += len(records)

        while orig_size is None:
            rec = framing.read_stream_record(src)
            if isinstance(rec, int):
                orig_size = rec
                flush(batch, final=True)
            else:
                batch.append(rec)
                # Keep one record in reserve: the last record of the stream
                # may be a short tail block.
                if len(batch) > batch_blocks:
                    flush(batch[:-1], final=False)
                    batch = batch[-1:]
        if written != orig_size:
            raise framing.FramingError(
                f"decoded {written} bytes, stream claims {orig_size}"
            )
        return written

    def decode_range(self, container: bytes, start_block: int,
                     end_block: int) -> bytes:
        """Decode blocks [start_block, end_block) only."""
        header, payloads = framing.parse_frame(bytes(container))
        if not 0 <= start_block <= end_block <= header.n_blocks:
            raise IndexError(
                f"block range [{start_block}, {end_block}) outside "
                f"0..{header.n_blocks}"
            )
        if start_block == end_block:
            return b""
        end = min(end_block * self.block_size, header.orig_size)
        sub_orig = max(0, end - start_block * self.block_size)
        sub = framing.pack_frame(
            self.spec, self.block_size, sub_orig,
            [bytes(p) for p in payloads[start_block:end_block]],
        )
        return self.decode(sub)
