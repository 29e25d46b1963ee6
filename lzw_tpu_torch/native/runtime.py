"""ctypes bindings over the native host runtime, built from the shared source.

The C++ source is ``lzw_tpu/native/lzw_native.cpp``, compiled by path (the
JAX package's Python bindings import jax, so they are not reused) into
``lzw_tpu_torch/native/build/``.  Only the calls the container needs are
bound: the threaded block encode and decode, the single-stream decode of the
verify sample, and ``apply_words``, the host pass 2 that resolves the
pass-1 kernel's copy descriptors.
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

__all__ = ["NativeRuntime", "get_runtime", "SOURCE"]

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "lzw_tpu" / "native" / "lzw_native.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
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
    """Host-side block codec over the native library."""

    def __init__(self, lib_path: pathlib.Path | None = None):
        lib = ctypes.CDLL(str(lib_path or build()))
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
        raise RuntimeError(f"native runtime returned {rc}")

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


def get_runtime() -> NativeRuntime:
    """Build-once, process-wide native runtime; raises when it cannot build."""
    global _runtime
    with _lock:
        if _runtime is None:
            _runtime = NativeRuntime()
        return _runtime
