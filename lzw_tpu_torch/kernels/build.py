"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C launch function
(no PyTorch headers, so ``nvcc`` takes seconds); ``csrc/*.cuh`` hold device
helpers that several kernels include.  On first CUDA use a kernel is
compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

into ``lzw_tpu_torch/kernels/build/`` and loaded with ctypes.  Nothing here
runs at import time.  A missing ``nvcc`` or a failed build raises: there is
no fallback to the plain versions for CUDA tensors.

Every wrapper adds one to its kernel's count in :data:`LAUNCHES` where it
launches the kernel, so a run can show that its main path went through the
kernels.  A source with several launch functions (``probe_gather.cu``)
counts them under its one name.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["KERNELS", "LAUNCHES", "BuildError", "find_nvcc", "load",
           "reset_counts", "check_launch", "require_tensor"]

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
KERNELS = ("encode_parse", "decode_pass1", "word_ends", "decode_pass2",
           "decode_pass2_stride1",
           # The probes and ablations of the JAX package's scripts.
           "ablate_parse", "ablate_ring", "probe_scan", "probe_gather")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {name: 0 for name in KERNELS}
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
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(f.stat().st_mtime for f in (src, *CSRC.glob("*.cuh")))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise BuildError(
                f"nvcc failed for {src.name} (rc {res.returncode}):\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


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


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch, else count it."""
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")
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
