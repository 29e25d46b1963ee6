"""Public single-stream codec facades.

Port of ``lzw_tpu/api.py``, salzweg's own surface, with its four facade
types and their byte-level contracts:

* :class:`GifCodec`      — `encoder.rs:349-440` / `decoder.rs:293-383`
* :class:`TiffCodec`     — `encoder.rs:442-524` / `decoder.rs:385-465`
* :class:`FixedCodec`    — `encoder.rs:526-659` / `decoder.rs:467-643`
* :class:`VariableCodec` — `encoder.rs:151-347` / `decoder.rs:52-291`

Each facade produces and consumes the raw single-stream wire format,
byte-identical to the reference and to the JAX package.  Block-parallel
work on the card is :class:`lzw_tpu_torch.parallel.BlockParallelCodec`.

Backends: ``"native"`` (the C++ runtime on the host, truly streaming),
``"oracle"`` (the scalar Python oracle, :mod:`lzw_tpu_torch.ops.reference`),
``"torch"`` (the port of the JAX package's ``"jax"`` backend, its XLA
codec: :func:`lzw_tpu_torch.ops.encode.encode_stream_bytes` and the two
passes of :mod:`lzw_tpu_torch.ops.decode`, on the facade's ``device``:
the CUDA kernels on a card, their plain versions on the CPU), and
``"auto"``: native when it builds, else ``"torch"`` on the facade's
``device``, as the JAX package's ``"auto"`` is native when it builds,
else its ``"jax"`` codec.  Without a card, ``"torch"`` on ``"cuda"``
(the default device) raises: there is no silent step down to the CPU.
"""

from __future__ import annotations

import itertools
from typing import BinaryIO

import numpy as np
import torch

from lzw_tpu_torch.native.runtime import get_runtime, native_available
from lzw_tpu_torch.ops import decode as _decode
from lzw_tpu_torch.ops import reference as _oracle
from lzw_tpu_torch.ops.encode import encode_stream_bytes
from lzw_tpu_torch.spec import CodeSizeStrategy, Endianness, LzwSpec
from lzw_tpu_torch.utils import spans

__all__ = ["LzwCodec", "GifCodec", "TiffCodec", "FixedCodec", "VariableCodec"]

BACKENDS = ("auto", "native", "oracle", "torch")
# The device of the "torch" backend when the caller names none.
DEFAULT_DEVICE = "cuda"


class LzwCodec:
    """Encode/decode one LZW wire format described by an :class:`LzwSpec`.

    ``device`` is where the ``"torch"`` backend runs (default
    :data:`DEFAULT_DEVICE`, ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions); the host backends ignore it.  ``"cuda"`` without a card
    raises RuntimeError.  A ``"torch"`` call is a span ``lzw.encode`` or
    ``lzw.decode`` with its steps inside (:mod:`lzw_tpu_torch.utils.spans`;
    one block, route "device").
    """

    def __init__(self, spec: LzwSpec, backend: str = "auto",
                 device: str | torch.device | None = None):
        if backend == "jax":
            raise ValueError(
                "backend 'jax' is the JAX package's XLA codec; its "
                "counterpart in lzw_tpu_torch is backend 'torch'"
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        spec.validate()
        self.spec = spec
        if backend == "auto":
            backend = "native" if native_available() else "torch"
        if backend == "native":
            self._native = get_runtime()
        self.device = None
        if backend == "torch":
            self.device = torch.device(
                DEFAULT_DEVICE if device is None else device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'torch' on device 'cuda' needs a CUDA device, "
                    "and torch.cuda.is_available() is false; pass "
                    "device='cpu' to run the plain versions")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device}")
        self.backend = backend
        # The ids of the "torch" calls' spans.
        self._calls = itertools.count()

    # ---- bytes API -----------------------------------------------------------

    def encode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Compress ``data`` to the raw reference-compatible stream."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.encode_bytes(data, self.spec)
        if self.backend == "torch":
            with self._call("encode", data):
                return encode_stream_bytes(data, self.spec,
                                           fix_eoi_width=False,
                                           device=self.device)
        return self._native.encode(data, self.spec)

    def decode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Decompress a raw stream produced by :meth:`encode` (or salzweg)."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.decode_bytes(data, self.spec)
        if self.backend == "torch":
            with self._call("decode", data):
                return self._decode_torch(data)
        return self._native.decode(data, self.spec)

    # ---- stream API (reference's Read -> Write shape) ------------------------

    def encode_stream(self, src: BinaryIO, dst: BinaryIO,
                      chunk_size: int = 1 << 20) -> int:
        """Compress all of ``src`` into ``dst``; returns bytes written.

        With the native backend this is truly streaming, O(chunk) memory for
        any stream length, as the reference pulls one byte at a time from
        ``Read`` (`encoder.rs:299,313`).  The oracle and torch backends
        buffer (they are batch codecs by design).
        """
        if self.backend == "native":
            enc = self._native.encoder_stream(self.spec)
            written = 0
            while True:
                chunk = src.read(chunk_size)
                if not chunk:
                    break
                out = enc.feed(chunk)
                dst.write(out)
                written += len(out)
            out = enc.finish()
            dst.write(out)
            return written + len(out)
        out = self.encode(src.read())
        dst.write(out)
        return len(out)

    def decode_stream(self, src: BinaryIO, dst: BinaryIO,
                      chunk_size: int = 1 << 20) -> int:
        """Decompress all of ``src`` into ``dst``; returns bytes written.

        Native backend: incremental, emitting words as they decode with
        bounded memory (`decoder.rs:270`).  The others buffer.
        """
        if self.backend == "native":
            dec = self._native.decoder_stream(self.spec)
            written = 0
            while True:
                chunk = src.read(chunk_size)
                if not chunk:
                    break
                for out in dec.feed(chunk):
                    dst.write(out)
                    written += len(out)
            dec.finish()
            return written
        out = self.decode(src.read())
        dst.write(out)
        return len(out)

    # ---- torch path ----------------------------------------------------------

    def _call(self, op: str, data: bytes):
        """The span of a ``"torch"`` call, with the facade's next call id."""
        if not spans.recording():
            return spans.OFF
        return spans.call(op, next(self._calls), 1, len(data),
                          -1 if op == "encode" else spans.ROUTES.index(
                              "device"))

    def _decode_torch(self, data: bytes) -> bytes:
        with spans.span("dec_host_prep"):
            row = np.zeros((1, max(len(data), 1)), np.uint8)
            row[0, : len(data)] = np.frombuffer(data, np.uint8)
        with spans.span("dec_h2d"):
            buf = torch.from_numpy(row).to(self.device)
            n_valid = torch.tensor([len(data)], dtype=torch.int32,
                                   device=self.device)
        with spans.span("dec_stream"):
            res = _decode.decode_block(buf, n_valid, self.spec)
        with spans.span("dec_errors"):
            err, err_code, total = (
                int(v) for v in torch.stack([
                    res["error"][0].long(), res["error_code"][0].long(),
                    res["total_len"][0]]).cpu())
            _decode.raise_decode_error(err, err_code)
        with spans.span("dec_d2h_out"):
            return res["out"][0, :total].cpu().numpy().tobytes()


class GifCodec(LzwCodec):
    """GIF-style LZW: caller code size 2..=8, LSB-first, default strategy."""

    def __init__(self, code_size: int, backend: str = "auto",
                 device: str | torch.device | None = None):
        super().__init__(LzwSpec.gif(code_size), backend, device)


class TiffCodec(LzwCodec):
    """TIFF-style LZW: code size 8, MSB-first, early-change widths."""

    def __init__(self, backend: str = "auto",
                 device: str | torch.device | None = None):
        super().__init__(LzwSpec.tiff(), backend, device)


class FixedCodec(LzwCodec):
    """Original fixed 12-bit LZW: byte alphabet, no control codes."""

    def __init__(self, endianness: Endianness = Endianness.LITTLE,
                 backend: str = "auto",
                 device: str | torch.device | None = None):
        super().__init__(LzwSpec.fixed(endianness), backend, device)


class VariableCodec(LzwCodec):
    """Generic variable-width LZW with explicit parameters."""

    def __init__(
        self,
        code_size: int,
        endianness: Endianness,
        strategy: CodeSizeStrategy = CodeSizeStrategy.DEFAULT,
        backend: str = "auto",
        device: str | torch.device | None = None,
    ):
        super().__init__(LzwSpec.variable(code_size, endianness, strategy),
                         backend, device)


def _as_bytes(data) -> bytes:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.tobytes()
    return bytes(data)
