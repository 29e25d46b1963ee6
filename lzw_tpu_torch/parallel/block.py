"""Block-parallel LZW on one torch device: the LZWT container codec.

Port of ``lzw_tpu/parallel/block.py``.  Input is cut into independently
dictionaried blocks (the same LZWT container, byte-identical to the JAX
package's), every block is parsed at once on the device, and payloads are
gathered in submission order.

Encode: host prep -> H2D -> encode-parse kernel -> device bit-pack -> D2H
of the payload bytes.  Decode: host count recovery -> H2D -> device unpack
-> pass-1 kernel -> D2H of the descriptors -> host ``apply_words`` (the
native runtime).  On a CPU device the kernels' plain versions run.

Left out against the JAX codec: the ``shard_map`` mesh and its padding of
the batch to power-of-two rows and kernel groups (the port runs on one
device; spreading block rows over GPUs is later work), the lax-codec path,
and the TPU's "non-cell block size -> native encode" route (the CUDA kernel
takes any block size).  The all-device pass 2 and the device decode of
non-strict streams are not ported yet: those streams decode on the native
runtime, which the port's decode therefore needs.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from lzw_tpu_torch.kernels import schedule as _sched
from lzw_tpu_torch.kernels.decode import (
    MAX_BLOCK, decode_pass1, decode_pass1_fixed, prepare_variable_decode,
)
from lzw_tpu_torch.kernels.encode import encode_blocks_codes, pack12
from lzw_tpu_torch.native.runtime import get_runtime
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
    """

    def __init__(self, spec: LzwSpec, block_size: int | None = None,
                 device: str | torch.device = "cuda",
                 verify: bool | None = None,
                 stage_times: dict[str, float] | None = None):
        spec.validate()
        if block_size is None:
            block_size = (
                DEFAULT_BLOCK_SIZE if spec.variable else DEFAULT_FIXED_BLOCK_SIZE
            )
        if block_size <= 0:
            raise ValueError("block_size must be positive")
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
        on the host (native runtime); raises :class:`VerificationError`."""
        i = max(range(len(payloads)), key=lambda k: len(payloads[k]))
        bs = self.block_size
        expect = data[i * bs : (i + 1) * bs]
        try:
            got = get_runtime().decode(payloads[i], self.spec)
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
                out = self._decode_variable_device(header, payloads)
            else:
                out = self._decode_fixed_device(header, payloads)
        if out is None:
            # Blocks past the descriptor bound, or non-strict streams: the
            # threaded native runtime.
            out = get_runtime().decode_blocks(
                [bytes(p) for p in payloads], self.spec, self.block_size
            )
        if len(out) != header.orig_size:
            raise framing.FramingError(
                f"decoded {len(out)} bytes, container claims "
                f"{header.orig_size}"
            )
        return out

    def _payload_matrix(self, payloads, width: int):
        mat = np.zeros((len(payloads), width), np.uint8)
        plens = np.zeros(len(payloads), np.int32)
        for i, p in enumerate(payloads):
            mat[i, : len(p)] = np.frombuffer(p, np.uint8)
            plens[i] = len(p)
        return mat, plens

    def _decode_fixed_device(self, header, payloads) -> bytes:
        n = header.n_blocks
        with self._stage("dec_host_prep"):
            width = ((max(len(p) for p in payloads) + 2) // 3) * 3
            mat, plens = self._payload_matrix(payloads, max(width, 3))
        with self._stage("dec_h2d"):
            mat_t = torch.from_numpy(mat).to(self.device)
            plens_t = torch.from_numpy(plens).to(self.device)
        with self._stage("dec_pass1"):
            words, _, _, errs, err_codes, codes = decode_pass1_fixed(
                mat_t, plens_t, self.block_size,
                little=self.spec.endianness is Endianness.LITTLE,
            )
        return self._apply(words, errs, err_codes, n, codes)

    def _decode_variable_device(self, header, payloads) -> bytes | None:
        """Strict-schedule device decode; None when any block is
        non-strict."""
        n = header.n_blocks
        with self._stage("dec_host_prep"):
            mat, plens = self._payload_matrix(
                payloads, max(len(p) for p in payloads)
            )
        with self._stage("dec_count_recovery"):
            counts, strict, sched_arr, S = prepare_variable_decode(
                mat, plens, self.spec
            )
        if not strict.all():
            return None
        with self._stage("dec_h2d"):
            mat_t = torch.from_numpy(mat).to(self.device)
            counts_t = torch.from_numpy(counts.astype(np.int32)).to(
                self.device)
            sched_t = torch.from_numpy(sched_arr).to(self.device)
        with self._stage("dec_unpack"):
            dense, data_ok = _sched.unpack_variable_device(
                mat_t, counts_t, self.spec, S
            )
        if not bool(data_ok.all()):
            return None
        with self._stage("dec_pass1"):
            words, _, errs, err_codes = decode_pass1(
                dense, counts_t, self.spec, self.block_size, sched_t
            )
        return self._apply(words, errs, err_codes, n, dense)

    def _apply(self, words, errs, err_codes, n: int, codes) -> bytes:
        """Raise on a pass-1 error, else resolve the descriptors on the host."""
        errs = errs.cpu().numpy()
        if errs.any():
            i = int(np.argmax(errs != 0))
            raise UnexpectedCodeError(int(err_codes[i]))
        with self._stage("dec_d2h_words"):
            words = words.cpu().numpy()
        with self._stage("dec_apply_words"):
            outs, tlens = get_runtime().apply_words(
                words, self.block_size, codes=codes
            )
            return b"".join(outs[i, : tlens[i]].tobytes() for i in range(n))

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
