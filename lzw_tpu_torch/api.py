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

A single stream is one sequential chain, so the facades run on the host,
as in the JAX package, whose ``"auto"`` is the native runtime too.
Backends: ``"native"`` (the C++ runtime, truly streaming), ``"oracle"``
(the scalar Python oracle, :mod:`lzw_tpu_torch.ops.reference`), and
``"auto"``: native when it builds, else the oracle.  The JAX package's
``"jax"`` backend is its XLA lax codec, which the port does not port: the
oracle takes its place as the backend that runs wherever Python does.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from lzw_tpu_torch.native.runtime import get_runtime, native_available
from lzw_tpu_torch.ops import reference as _oracle
from lzw_tpu_torch.spec import CodeSizeStrategy, Endianness, LzwSpec

__all__ = ["LzwCodec", "GifCodec", "TiffCodec", "FixedCodec", "VariableCodec"]

BACKENDS = ("auto", "native", "oracle")


class LzwCodec:
    """Encode/decode one LZW wire format described by an :class:`LzwSpec`."""

    def __init__(self, spec: LzwSpec, backend: str = "auto"):
        if backend == "jax":
            raise ValueError(
                "backend 'jax' is the JAX package's XLA lax codec, which "
                "lzw_tpu_torch does not port; use 'native' or 'oracle'"
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        spec.validate()
        self.spec = spec
        if backend == "auto":
            backend = "native" if native_available() else "oracle"
        if backend == "native":
            self._native = get_runtime()
        self.backend = backend

    # ---- bytes API -----------------------------------------------------------

    def encode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Compress ``data`` to the raw reference-compatible stream."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.encode_bytes(data, self.spec)
        return self._native.encode(data, self.spec)

    def decode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Decompress a raw stream produced by :meth:`encode` (or salzweg)."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.decode_bytes(data, self.spec)
        return self._native.decode(data, self.spec)

    # ---- stream API (reference's Read -> Write shape) ------------------------

    def encode_stream(self, src: BinaryIO, dst: BinaryIO,
                      chunk_size: int = 1 << 20) -> int:
        """Compress all of ``src`` into ``dst``; returns bytes written.

        With the native backend this is truly streaming, O(chunk) memory for
        any stream length, as the reference pulls one byte at a time from
        ``Read`` (`encoder.rs:299,313`).  The oracle buffers.
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
        bounded memory (`decoder.rs:270`).  The oracle buffers.
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


class GifCodec(LzwCodec):
    """GIF-style LZW: caller code size 2..=8, LSB-first, default strategy."""

    def __init__(self, code_size: int, backend: str = "auto"):
        super().__init__(LzwSpec.gif(code_size), backend)


class TiffCodec(LzwCodec):
    """TIFF-style LZW: code size 8, MSB-first, early-change widths."""

    def __init__(self, backend: str = "auto"):
        super().__init__(LzwSpec.tiff(), backend)


class FixedCodec(LzwCodec):
    """Original fixed 12-bit LZW: byte alphabet, no control codes."""

    def __init__(self, endianness: Endianness = Endianness.LITTLE,
                 backend: str = "auto"):
        super().__init__(LzwSpec.fixed(endianness), backend)


class VariableCodec(LzwCodec):
    """Generic variable-width LZW with explicit parameters."""

    def __init__(
        self,
        code_size: int,
        endianness: Endianness,
        strategy: CodeSizeStrategy = CodeSizeStrategy.DEFAULT,
        backend: str = "auto",
    ):
        super().__init__(LzwSpec.variable(code_size, endianness, strategy),
                         backend)


def _as_bytes(data) -> bytes:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.tobytes()
    return bytes(data)
