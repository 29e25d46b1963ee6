"""Block-parallel LZW on one torch device: the LZWT container codec.

Port of ``lzw_tpu/parallel/block.py``.  Input is cut into independently
dictionaried blocks (the same LZWT container, byte-identical to the JAX
package's), every block is parsed at once on the device, and payloads are
gathered in submission order.

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

On a CPU device the kernels' plain versions run.

Left out against the JAX codec: the ``shard_map`` mesh and its padding of
the batch to power-of-two rows and kernel groups (the port runs on one
device; spreading block rows over GPUs is later work), the lax-codec path,
and the TPU's "non-cell block size -> native encode" route (the CUDA kernel
takes any block size).
"""

from __future__ import annotations

import contextlib
import math
import subprocess
import time

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.decode import (
    MAX_BLOCK, decode_fixed_all_device, decode_pass1_fixed,
    decode_variable_all_device, to_host, variable_pass1,
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
           "DEFAULT_FIXED_BLOCK_SIZE"]

DEFAULT_BLOCK_SIZE = 1 << 16
# The fixed flavor freezes its dictionary after 4096 entries, so small blocks
# re-learn and usually compress better.
DEFAULT_FIXED_BLOCK_SIZE = 1 << 12
PASS2_ROUTES = ("auto", "device", "host")


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


class BlockParallelCodec:
    """Container-format codec over the blocks of one device.

    Args:
      spec: the wire spec.
      block_size: uncompressed bytes per block (64 KiB variable, 4 KiB fixed
        by default).
      device: the torch device the kernels run on; "cuda" needs a card and
        raises without one.
      verify: decode-check the largest payload of each encode on the host
        (default: on for CUDA devices, where the kernels are in the path).
      stage_times: a dict that, when given, accumulates the seconds of each
        pipeline stage; each stage then ends in a device synchronisation.
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
                 device: str | torch.device = "cuda",
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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BlockParallelCodec(device='cuda') needs a CUDA device, and "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the plain versions"
            )
        self.spec = spec
        self.block_size = block_size
        self.verify = self.device.type == "cuda" if verify is None else bool(
            verify)
        self.stage_times = stage_times
        self.pass2 = pass2

    @contextlib.contextmanager
    def _stage(self, name: str):
        if self.stage_times is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.stage_times[name] = (
            self.stage_times.get(name, 0.0) + time.perf_counter() - t0
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- public API ----------------------------------------------------------

    def encode(self, data: bytes) -> bytes:
        """Compress to the LZWT container."""
        data = bytes(data)
        n_blocks = math.ceil(len(data) / self.block_size) if data else 0
        if n_blocks == 0:
            return framing.pack_frame(self.spec, self.block_size, 0, [])
        bs = self.block_size
        with self._stage("enc_host_prep"):
            blocks = np.zeros((n_blocks, bs), np.uint8)
            lens = np.full(n_blocks, bs, np.int32)
            arr = np.frombuffer(data, np.uint8)
            full = len(data) // bs
            blocks[:full] = arr[: full * bs].reshape(full, bs)
            rem = len(data) - full * bs
            if rem:
                blocks[full, :rem] = arr[full * bs :]
                lens[full] = rem
        with self._stage("enc_h2d"):
            blocks_t = torch.from_numpy(blocks).to(self.device)
            lens_t = torch.from_numpy(lens).to(self.device)
        with self._stage("enc_kernel"):
            dense, counts, errs, err_codes = encode_blocks_codes(
                blocks_t, lens_t, self.spec
            )
        errs = errs.cpu().numpy()
        if errs.any():
            i = int(np.argmax(errs != 0))
            raise UnexpectedCodeError(
                int(err_codes[i]), self.spec.code_size
            )
        with self._stage("enc_pack"):
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
        with self._stage("enc_d2h"):
            bufs = bufs.cpu().numpy()
            n_bytes = n_bytes.cpu().numpy()
        payloads = [bufs[i, : n_bytes[i]].tobytes() for i in range(n_blocks)]
        if self.verify:
            self._verify_sample(data, payloads)
        return framing.pack_frame(self.spec, self.block_size, len(data),
                                  payloads)

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
                out = self._decode_variable(payloads, header.orig_size)
                if out is None and self._native() is None:
                    out = self._decode_variable_nonstrict(payloads)
            else:
                out = self._decode_fixed(payloads, header.orig_size)
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

    def _payload_matrix(self, payloads, width: int):
        mat = np.zeros((len(payloads), width), np.uint8)
        plens = np.zeros(len(payloads), np.int32)
        for i, p in enumerate(payloads):
            mat[i, : len(p)] = np.frombuffer(p, np.uint8)
            plens[i] = len(p)
        return mat, plens

    def _decode_fixed(self, payloads, orig_size: int) -> bytes:
        rt = self._host_pass2()
        with self._stage("dec_host_prep"):
            width = ((max(len(p) for p in payloads) + 2) // 3) * 3
            mat, plens = self._payload_matrix(payloads, max(width, 3))
        with self._stage("dec_h2d"):
            mat_t = torch.from_numpy(mat).to(self.device)
            plens_t = torch.from_numpy(plens).to(self.device)
        little = self.spec.endianness is Endianness.LITTLE
        if rt is None:
            out, _, errs, err_codes = decode_fixed_all_device(
                mat_t, plens_t, self.block_size, little, self._stage,
                flat=True)
            self._raise_pass1(errs, err_codes)
            return self._gather(out, orig_size)
        with self._stage("dec_pass1"):
            words, _, _, errs, err_codes, codes = decode_pass1_fixed(
                mat_t, plens_t, self.block_size, little)
        self._raise_pass1(errs, err_codes)
        return self._apply(rt, words, len(payloads), codes)

    def _decode_variable(self, payloads, orig_size: int) -> bytes | None:
        """Strict-schedule decode; None when any block is non-strict."""
        rt = self._host_pass2()
        with self._stage("dec_host_prep"):
            mat, plens = self._payload_matrix(
                payloads, max(len(p) for p in payloads)
            )
        if rt is None:
            out, _, errs, err_codes, strict = decode_variable_all_device(
                mat, plens, self.spec, self.block_size, self.device,
                self._stage, flat=True)
        else:
            p = variable_pass1(mat, plens, self.spec, self.block_size,
                               self.device, stage=self._stage)
            errs, err_codes, strict = p.err, p.err_code, p.strict
        if not strict.all():
            return None
        self._raise_pass1(errs, err_codes)
        if rt is None:
            return self._gather(out, orig_size)
        return self._apply(rt, p.words, len(payloads), p.dense)

    def _decode_variable_nonstrict(self, payloads) -> bytes:
        """Foreign early-CLEAR blocks: split at their CLEARs on the host,
        every epoch decoded on the device."""
        with self._stage("dec_host_prep"):
            mat, plens = self._payload_matrix(
                payloads, max(len(p) for p in payloads)
            )
        parts = decode_variable_nonstrict_device(
            mat, plens, self.spec, self.block_size, self.device, self._stage
        )
        return b"".join(parts)

    @staticmethod
    def _raise_pass1(errs, err_codes) -> None:
        errs = errs.cpu().numpy()
        if errs.any():
            i = int(np.argmax(errs != 0))
            raise UnexpectedCodeError(int(err_codes[i]))

    def _apply(self, rt, words, n: int, codes) -> bytes:
        """Resolve the descriptors on the host."""
        with self._stage("dec_d2h_words"):
            words = words.cpu().numpy()
        with self._stage("dec_apply_words"):
            outs, tlens = rt.apply_words(words, self.block_size, codes=codes)
            return b"".join(outs[i, : tlens[i]].tobytes() for i in range(n))

    def _gather(self, flat: torch.Tensor, orig_size: int) -> bytes:
        """The blocks' decoded bytes, which the flat walk wrote back to
        back: a length check against the container's, then one copy into
        pinned host memory."""
        with self._stage("dec_d2h_out"):
            if flat.numel() != orig_size:
                raise framing.FramingError(
                    f"decoded {flat.numel()} bytes, container claims "
                    f"{orig_size}"
                )
            return to_host(flat).tobytes()

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
