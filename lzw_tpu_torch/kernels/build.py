"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C launch function
(no PyTorch headers, so ``nvcc`` takes seconds); ``csrc/*.cuh`` hold device
helpers that several kernels include.  On first CUDA use a kernel is
compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<key>.so csrc/<name>.cu

into ``lzw_tpu_torch/kernels/build/`` and loaded with ctypes.  The key
(:mod:`lzw_tpu_torch.utils.cache`) covers the ``.cu``, every ``.cuh``, the
command line and ``nvcc --version``: a library is reused only when its key
matches.  Nothing here runs at import time.  A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain versions for CUDA
tensors.

Every C function of the kernels has its prototype in :data:`PROTOTYPES`
(library, symbol, parameters; each returns an ``int``).  :func:`load`
binds them once, when the library loads, under the kernel's lock, and
:func:`bound` hands a wrapper the bound function: no wrapper sets
``argtypes`` (without which ctypes cuts a pointer to 32 bits) on a call.
A wrapper's launch path is then: its checks, :func:`bound`,
:func:`on_device` (no switch when the tensor's device is current), the
outputs, the call with :func:`stream`'s raw handle, :func:`check_launch`.

Every wrapper adds one to its kernel's count in :data:`LAUNCHES` where it
launches the kernel, so a run can show that its main path went through the
kernels.  A source with several launch functions (``probe_gather.cu``)
counts them under its one name.  The counts are kept under a lock: the
container launches from one thread per device.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from contextlib import nullcontext

import torch

from lzw_tpu_torch.utils import cache

__all__ = ["KERNELS", "LAUNCHES", "PROTOTYPES", "BuildError", "find_nvcc",
           "load", "bound", "argtypes", "library_path", "on_device", "stream",
           "reset_counts", "check_launch", "require_tensor"]

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
KERNELS = ("encode_parse", "decode_pass1", "word_ends", "decode_pass2",
           "decode_pass2_stride1",
           # The single-stream codec of lzw_tpu_torch.ops.
           "stream_encode", "stream_pass1", "stream_pass2",
           # The probes and ablations of the JAX package's scripts, and
           # the chain-step probe of the encode kernels.
           "ablate_parse", "ablate_ring", "probe_scan", "probe_gather",
           "chain_probe")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Every C function of every kernel library: {kernel: {symbol: parameters}},
# one letter a parameter: P a pointer or the stream (c_void_p), I an int,
# L an int64_t, U an unsigned; each returns an int, the CUDA error (0 on
# success).  tests/test_torch_bind.py holds it against the sources'
# extern "C" signatures.
PROTOTYPES = {
    "encode_parse": {"encode_parse_launch": "PPIIIIIPPPPPIIIP",
                     "encode_parse_occupancy": "IIP"},
    "decode_pass1": {"decode_pass1_launch": "PPIIIIIPIIPPIPPPIIP"},
    "word_ends": {"word_ends_launch": "PPIIIPP"},
    "decode_pass2": {"decode_pass2_launch": "PPPPPPPIIIIIPP"},
    "decode_pass2_stride1": {"decode_pass2_stride1_launch": "PPPPPPPIIIIIPP"},
    "stream_encode": {"stream_encode_launch": "PLPIIIIIPPPPPIIIP"},
    "stream_pass1": {"stream_pass1_launch": "PPP" + "I" * 13 + "P" * 14},
    "stream_pass2": {"stream_pass2_launch": "PPPPPPPIIIIIIIIPPP"},
    "ablate_parse": {"ablate_parse_launch": "PPIIIIIIIP"},
    "ablate_ring": {"ablate_ring_launch": "PPIIIIIIIP"},
    "probe_scan": {"probe_scan_launch": "PPIIIIUP"},
    "probe_gather": {"affine_launch": "PPIP",
                     "gather_lanes_launch": "PPPIIIP",
                     "gather_loop_launch": "PPPIIIIP"},
    "chain_probe": {"chain_probe_launch": "PUIIIPPPP"},
}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "L": ctypes.c_int64,
           "U": ctypes.c_uint}

LAUNCHES = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# (kernel, symbol) -> the library's function, its prototype set.
_bound: dict[tuple[str, str], object] = {}
# One lock per kernel: different kernels may build at the same time.
_locks = {name: threading.Lock() for name in KERNELS}


class BuildError(RuntimeError):
    """A kernel could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises :class:`BuildError` when absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(pathlib.Path(which))
    cands.append(pathlib.Path(DEFAULT_NVCC))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels of lzw_tpu_torch need the CUDA toolkit"
    )


def _compile(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    command = [find_nvcc(), *NVCC_FLAGS, "-o", cache.OUT, str(src)]
    try:
        return cache.keyed_build(BUILD_DIR, name,
                                 [src, *CSRC.glob("*.cuh")], command)
    except subprocess.CalledProcessError as exc:
        raise BuildError(
            f"nvcc failed for {src.name} (rc {exc.returncode}):\n"
            f"{exc.stdout}{exc.stderr}"
        ) from exc


def argtypes(kernel: str, symbol: str) -> list:
    """The ctypes parameter types of ``symbol`` in :data:`PROTOTYPES`."""
    return [_CTYPES[c] for c in PROTOTYPES[kernel][symbol]]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled on first use, its
    functions bound to their :data:`PROTOTYPES`."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}")
    with _locks[name]:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(str(_compile(name)))
            except OSError as exc:
                raise BuildError(f"cannot load kernel {name}: {exc}") from exc
            for symbol in PROTOTYPES[name]:
                try:
                    fn = getattr(lib, symbol)
                except AttributeError as exc:
                    raise BuildError(f"kernel {name} has no {symbol}") from exc
                fn.argtypes = argtypes(name, symbol)
                fn.restype = ctypes.c_int
                _bound[name, symbol] = fn
            _libs[name] = lib
        return _libs[name]


def bound(kernel: str, symbol: str):
    """Function ``symbol`` of kernel ``kernel``'s library, bound to its
    prototype when the library loaded (compiled on first use)."""
    fn = _bound.get((kernel, symbol))
    if fn is None:
        load(kernel)
        fn = _bound[kernel, symbol]
    return fn


_CURRENT = nullcontext()


def on_device(dev: torch.device):
    """A context that makes CUDA device ``dev`` current; it does nothing
    when ``dev`` is current already."""
    if dev.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(dev)


def stream(dev: torch.device) -> int:
    """The raw handle of CUDA device ``dev``'s current stream, as a launch
    function takes it."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def library_path(name: str) -> pathlib.Path:
    """The path of kernel ``name``'s library, compiled on first use."""
    load(name)
    return _compile(name)


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch, else count it."""
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")
    with _count_lock:
        LAUNCHES[name] += 1


def require_tensor(t, what: str, dtype, ndim: int, device) -> None:
    """Validate a kernel input: device, dtype, rank and contiguity."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
