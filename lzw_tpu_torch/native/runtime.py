"""ctypes bindings over the native host runtime, built from the port's source.

The C++ source is ``lzw_tpu_torch/native/lzw_native.cpp``, a byte-for-byte
copy of the JAX package's ``lzw_tpu/native/lzw_native.cpp`` (whose Python
bindings import jax, so they are not reused), compiled into
``lzw_tpu_torch/native/build/``.  Bound: the single-stream encode and
decode and their incremental stream handles (the facades of
:mod:`lzw_tpu_torch.api`), the threaded block encode and decode, and
``apply_words``, the host pass 2 that resolves the pass-1 kernel's copy
descriptors.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from lzw_tpu_torch.ops.encode import packed_bound
from lzw_tpu_torch.spec import (
    CodeSizeError,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__all__ = ["NativeRuntime", "get_runtime", "native_available", "SOURCE"]

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "lzw_native.cpp"
_BUILD_DIR = _HERE / "build"
_LIB = _BUILD_DIR / "liblzw_native.so"

_OK = 0
_ERR_BUF = -1
_ERR_CODE_SIZE = -2
_ERR_UNEXPECTED_ENC = -3
_ERR_UNEXPECTED_DEC = -4
_ERR_MISSING_CLEAR = -5
_ERR_TRUNCATED = -6

_lock = threading.Lock()
_runtime: "NativeRuntime | None" = None
_build_error: "Exception | None" = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_szp = ctypes.POINTER(ctypes.c_size_t)
_ip = ctypes.POINTER(ctypes.c_int)


def build() -> pathlib.Path:
    """Compile the shared library if missing or older than its source.

    The library is written under a temporary name and renamed into place,
    so concurrent first uses (test workers) never load a half-written file.
    """
    if not SOURCE.exists():
        raise FileNotFoundError(f"native runtime source missing: {SOURCE}")
    _BUILD_DIR.mkdir(exist_ok=True)
    if _LIB.exists() and _LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return _LIB
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread",
        str(SOURCE), "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _u32(arr: np.ndarray):
    return arr.ctypes.data_as(_u32p)


def _threads(n: int | None) -> int:
    return n or min(os.cpu_count() or 1, 32)


class NativeRuntime:
    """Host-side codec over the native library."""

    def __init__(self, lib_path: pathlib.Path | None = None):
        lib = ctypes.CDLL(str(lib_path or build()))
        lib.lzw_encode.restype = ctypes.c_int
        lib.lzw_encode.argtypes = [
            _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _szp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _ip,
        ]
        lib.lzw_decode.restype = ctypes.c_int
        lib.lzw_decode.argtypes = [
            _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _szp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _ip,
        ]
        lib.lzw_encode_blocks.restype = ctypes.c_int
        lib.lzw_encode_blocks.argtypes = [
            _u8p, ctypes.c_size_t, ctypes.c_size_t, _u8p, ctypes.c_size_t,
            _u32p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _ip,
        ]
        lib.lzw_decode_blocks.restype = ctypes.c_int
        lib.lzw_decode_blocks.argtypes = [
            _u8p, _u32p, _u32p, ctypes.c_size_t, _u8p, ctypes.c_size_t, _u32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _ip,
        ]
        lib.lzw_apply_words_blocks.restype = ctypes.c_int
        lib.lzw_apply_words_blocks.argtypes = [
            _i32p, ctypes.c_size_t, ctypes.c_size_t, _u8p, ctypes.c_size_t,
            _u32p, ctypes.c_int, _u32p, _u32p,
        ]
        # Incremental stream codec (the reference's Read -> Write shape,
        # `encoder.rs:299` / `decoder.rs:270`).
        lib.lzw_enc_stream_new.restype = ctypes.c_void_p
        lib.lzw_enc_stream_new.argtypes = [ctypes.c_int] * 5
        lib.lzw_enc_stream_feed.restype = ctypes.c_int
        lib.lzw_enc_stream_feed.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
            _szp, _ip,
        ]
        lib.lzw_enc_stream_finish.restype = ctypes.c_int
        lib.lzw_enc_stream_finish.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_size_t, _szp,
        ]
        lib.lzw_enc_stream_free.restype = None
        lib.lzw_enc_stream_free.argtypes = [ctypes.c_void_p]
        lib.lzw_dec_stream_new.restype = ctypes.c_void_p
        lib.lzw_dec_stream_new.argtypes = [ctypes.c_int] * 4
        lib.lzw_dec_stream_feed.restype = ctypes.c_int
        lib.lzw_dec_stream_feed.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
            _szp, _szp, _ip,
        ]
        lib.lzw_dec_stream_finish.restype = ctypes.c_int
        lib.lzw_dec_stream_finish.argtypes = [ctypes.c_void_p]
        lib.lzw_dec_stream_free.restype = None
        lib.lzw_dec_stream_free.argtypes = [ctypes.c_void_p]
        self._lib = lib

    @staticmethod
    def _spec_args(spec: LzwSpec):
        return (
            spec.code_size,
            0 if spec.endianness is Endianness.LITTLE else 1,
            spec.strategy.increment,
            1 if spec.variable else 0,
        )

    @staticmethod
    def _raise(rc: int, err_code: int, spec: LzwSpec):
        """The error of a native return code, as the JAX package maps it:
        the code tells an encoder's unexpected byte (with the code size in
        its message) from a decoder's unexpected code."""
        if rc == _ERR_CODE_SIZE:
            raise CodeSizeError(spec.code_size)
        if rc == _ERR_UNEXPECTED_ENC:
            raise UnexpectedCodeError(err_code, spec.code_size)
        if rc == _ERR_UNEXPECTED_DEC:
            raise UnexpectedCodeError(err_code)
        if rc == _ERR_MISSING_CLEAR:
            raise MissingClearCodeError()
        if rc == _ERR_TRUNCATED:
            raise TruncatedStreamError()
        if rc == _ERR_BUF:
            raise AssertionError("native output buffer undersized (bug)")
        raise AssertionError(f"unknown native rc {rc}")

    def encode(self, data: bytes, spec: LzwSpec,
               fix_eoi: bool = False) -> bytes:
        """Single-stream encode; ``fix_eoi`` writes the final EOI at the
        width a salzweg decoder reads it (the container's payloads)."""
        spec.validate()
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        cap = 2 * len(data) + (len(data) // 2048 + 8) * 2 + 16
        out = np.zeros(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_encode(
            _u8(src), len(data), _u8(out), cap, ctypes.byref(out_len),
            *self._spec_args(spec), 1 if fix_eoi else 0, ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec)
        return out[: out_len.value].tobytes()

    def decode(self, data: bytes, spec: LzwSpec) -> bytes:
        """Single-stream decode."""
        spec.validate()
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        cap = max(64, 16 * len(data))
        while True:
            out = np.zeros(cap, np.uint8)
            out_len = ctypes.c_size_t(0)
            err = ctypes.c_int(0)
            rc = self._lib.lzw_decode(
                _u8(src), len(data), _u8(out), cap, ctypes.byref(out_len),
                *self._spec_args(spec), ctypes.byref(err),
            )
            if rc == _ERR_BUF:
                cap *= 4
                continue
            if rc != _OK:
                self._raise(rc, err.value, spec)
            return out[: out_len.value].tobytes()

    def encode_blocks(self, data: bytes, spec: LzwSpec, block_size: int,
                      n_threads: int | None = None) -> list[bytes]:
        """Threaded block-parallel encode; payloads in submission order."""
        spec.validate()
        n_blocks = (len(data) + block_size - 1) // block_size
        if n_blocks == 0:
            return []
        stride = packed_bound(block_size, spec)
        src = np.frombuffer(data, np.uint8)
        out = np.zeros(n_blocks * stride, np.uint8)
        lengths = np.zeros(n_blocks, np.uint32)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_encode_blocks(
            _u8(src), len(data), block_size, _u8(out), stride, _u32(lengths),
            n_blocks, *self._spec_args(spec), _threads(n_threads),
            ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec)
        return [
            out[b * stride : b * stride + lengths[b]].tobytes()
            for b in range(n_blocks)
        ]

    def decode_blocks(self, payloads: list[bytes], spec: LzwSpec,
                      block_size: int, n_threads: int | None = None) -> bytes:
        """Threaded block-parallel decode of container payloads."""
        spec.validate()
        n_blocks = len(payloads)
        if n_blocks == 0:
            return b""
        comp = np.frombuffer(b"".join(payloads), np.uint8)
        if comp.size == 0:
            comp = np.zeros(1, np.uint8)
        lens = np.array([len(p) for p in payloads], np.uint32)
        offs = np.zeros(n_blocks, np.uint32)
        np.cumsum(lens[:-1], out=offs[1:])
        out = np.zeros(n_blocks * block_size, np.uint8)
        out_lens = np.zeros(n_blocks, np.uint32)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_decode_blocks(
            _u8(comp), _u32(offs), _u32(lens), n_blocks, _u8(out),
            block_size, _u32(out_lens), *self._spec_args(spec),
            _threads(n_threads), ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec)
        return b"".join(
            out[b * block_size : b * block_size + out_lens[b]].tobytes()
            for b in range(n_blocks)
        )

    def apply_words(self, words: np.ndarray, block_size: int,
                    n_threads: int | None = None,
                    codes: np.ndarray | None = None,
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Resolve pass-1 copy descriptors: words i32[N, S] -> bytes, lengths.

        ``codes`` (optional i32[N, S] wire codes aligned with ``words``) maps
        a corrupt descriptor back to the offending code.  Returns
        (out u8[N, block_size], lengths u32[N]).
        """
        words = np.ascontiguousarray(words, np.int32)
        n_blocks, stride = words.shape
        out = np.zeros(n_blocks * block_size, np.uint8)
        lengths = np.zeros(n_blocks, np.uint32)
        err_block = ctypes.c_uint32(0)
        err_word = ctypes.c_uint32(0)
        rc = self._lib.lzw_apply_words_blocks(
            words.ctypes.data_as(_i32p), stride, n_blocks, _u8(out),
            block_size, _u32(lengths), _threads(n_threads),
            ctypes.byref(err_block), ctypes.byref(err_word),
        )
        if rc != _OK:
            code = -1
            if codes is not None:
                code = int(codes[err_block.value, err_word.value])
            raise UnexpectedCodeError(code)  # corrupt copy list
        return out.reshape(n_blocks, block_size), lengths

    def encoder_stream(self, spec: LzwSpec, fix_eoi: bool = False):
        """Incremental encoder handle; see :class:`_EncoderStream`."""
        spec.validate()
        return _EncoderStream(self._lib, spec, fix_eoi)

    def decoder_stream(self, spec: LzwSpec):
        """Incremental decoder handle; see :class:`_DecoderStream`."""
        spec.validate()
        return _DecoderStream(self._lib, spec)


class _EncoderStream:
    """Stateful chunk-at-a-time encoder over the native stream codec: the
    reference's Read -> Write streaming encode (`encoder.rs:299,313`), in
    O(chunk) memory."""

    def __init__(self, lib, spec: LzwSpec, fix_eoi: bool):
        self._lib = lib
        self.spec = spec
        self._h = lib.lzw_enc_stream_new(*NativeRuntime._spec_args(spec),
                                         1 if fix_eoi else 0)
        if not self._h:
            raise CodeSizeError(spec.code_size)

    def feed(self, chunk: bytes) -> bytes:
        """Encode one chunk; returns the bytes completed so far."""
        if self._h is None:
            raise ValueError("encoder stream already finished")
        src = (np.frombuffer(chunk, np.uint8) if chunk
               else np.zeros(1, np.uint8))
        cap = 2 * len(chunk) + 64
        out = np.zeros(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_enc_stream_feed(
            self._h, _u8(src), len(chunk), _u8(out), cap,
            ctypes.byref(out_len), ctypes.byref(err),
        )
        if rc != _OK:
            NativeRuntime._raise(rc, err.value, self.spec)
        return out[: out_len.value].tobytes()

    def finish(self) -> bytes:
        """The stream's last bytes (the final code and EOI); frees it."""
        if self._h is None:
            raise ValueError("encoder stream already finished")
        out = np.zeros(16, np.uint8)
        out_len = ctypes.c_size_t(0)
        rc = self._lib.lzw_enc_stream_finish(self._h, _u8(out), 16,
                                             ctypes.byref(out_len))
        self.close()
        if rc != _OK:
            NativeRuntime._raise(rc, 0, self.spec)
        return out[: out_len.value].tobytes()

    def close(self) -> None:
        if self._h is not None:
            self._lib.lzw_enc_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


class _DecoderStream:
    """Stateful chunk-at-a-time decoder (the reference's streaming decode,
    `decoder.rs:270`)."""

    def __init__(self, lib, spec: LzwSpec):
        self._lib = lib
        self.spec = spec
        self._h = lib.lzw_dec_stream_new(*NativeRuntime._spec_args(spec))
        if not self._h:
            raise CodeSizeError(spec.code_size)
        self._pending = b""

    def feed(self, chunk: bytes, out_cap: int = 1 << 20):
        """Decode one compressed chunk; yields decoded byte chunks.

        Bounded memory: at most ``out_cap`` decoded bytes (8192 at least)
        are materialised at a time; input the codec did not consume yet is
        fed again, and a code cut at the chunk's end waits for the next
        feed.
        """
        if self._h is None:
            raise ValueError("decoder stream already finished")
        data = self._pending + bytes(chunk)
        self._pending = b""
        # A single word is at most MAX_WORD_LEN (4091) bytes; capping below
        # that could make zero progress on a full buffer.
        out_cap = max(out_cap, 8192)
        out = np.zeros(out_cap, np.uint8)
        while data:
            src = np.frombuffer(data, np.uint8)
            out_len = ctypes.c_size_t(0)
            consumed = ctypes.c_size_t(0)
            err = ctypes.c_int(0)
            rc = self._lib.lzw_dec_stream_feed(
                self._h, _u8(src), len(data), _u8(out), out_cap,
                ctypes.byref(out_len), ctypes.byref(consumed),
                ctypes.byref(err),
            )
            if rc != _OK:
                NativeRuntime._raise(rc, err.value, self.spec)
            if out_len.value:
                yield out[: out_len.value].tobytes()
            if consumed.value >= len(data):
                return
            if out_len.value == 0:
                # No progress and input left: a code cut at the end; keep
                # the remainder for the next feed.
                self._pending = data[consumed.value :]
                return
            data = data[consumed.value :]

    def finish(self) -> None:
        """Check the stream ended (EOI seen, for the variable flavors);
        frees it."""
        if self._h is None:
            raise ValueError("decoder stream already finished")
        rc = self._lib.lzw_dec_stream_finish(self._h)
        self.close()
        if rc != _OK:
            NativeRuntime._raise(rc, 0, self.spec)

    def close(self) -> None:
        if self._h is not None:
            self._lib.lzw_dec_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


def native_available() -> bool:
    """True when the native runtime builds and loads here."""
    try:
        get_runtime()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def get_runtime() -> NativeRuntime:
    """Build-once, process-wide native runtime; raises when it cannot build,
    and raises the same error again on every later call without retrying
    the compiler."""
    global _runtime, _build_error
    with _lock:
        if _build_error is not None:
            raise _build_error
        if _runtime is None:
            try:
                _runtime = NativeRuntime()
            except (OSError, subprocess.CalledProcessError) as exc:
                _build_error = exc
                raise
        return _runtime
