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

from lzw_tpu_torch.utils import cache

__all__ = ["KERNELS", "LAUNCHES", "BuildError", "find_nvcc", "load",
           "library_path", "reset_counts", "check_launch", "require_tensor"]

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

LAUNCHES = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, compiled on first use."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}")
    with _locks[name]:
        if name not in _libs:
            try:
                _libs[name] = ctypes.CDLL(str(_compile(name)))
            except OSError as exc:
                raise BuildError(f"cannot load kernel {name}: {exc}") from exc
        return _libs[name]


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
