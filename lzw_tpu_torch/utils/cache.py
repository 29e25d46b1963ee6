"""Builds keyed by content: the port's compiled libraries and when to reuse
them.

The counterpart of the JAX package's ``lzw_tpu/utils/cache.py``.  JAX's
persistent compilation cache reuses a compiled program only when the
program is the same.  The port compiles shared libraries instead, its CUDA
kernels (:mod:`lzw_tpu_torch.kernels.build`) and its native runtime
(:mod:`lzw_tpu_torch.native.runtime`), and reuses one on the same terms:
a library is named ``lib<name>-<key>.so``, where the key is a digest of
everything that shapes it:

* the bytes of its sources (a kernel's ``.cu`` and every ``.cuh`` it may
  include; ``lzw_native.cpp``);
* the compiler's full command line;
* the compiler's ``--version`` output;
* for a library built with ``-march=native``, the host CPU (its model name
  and feature flags from ``/proc/cpuinfo``).

A library is reused only when a file of its key exists; file times play no
part, so a tree unpacked from ``git archive`` (which carries the commit's
times) or copied to another host cannot load a library built from other
sources, flags, compiler or CPU.  Libraries of other keys stay in the
build directory and are never loaded.  The JAX package's switch
``LZW_TPU_NO_COMPILE_CACHE`` has no counterpart: a keyed build is never
stale, so there is nothing to turn off.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile
from collections.abc import Sequence

__all__ = ["OUT", "build_key", "compiler_version", "cpu_identity",
           "keyed_build"]

# Stands for the output file in a command given to :func:`keyed_build`.
OUT = "{out}"


def build_key(sources: Sequence[os.PathLike], command: Sequence[str],
              version: str, cpu: str | None = None) -> str:
    """16 hex digits of a SHA-256 over the sources' names and bytes, the
    command line, the compiler's version text and, when given, the CPU
    identity."""
    h = hashlib.sha256()
    for src in sorted(map(pathlib.Path, sources)):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(command).encode() + b"\0")
    h.update(version.encode() + b"\0")
    if cpu is not None:
        h.update(cpu.encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``<compiler> --version``'s output, once a process per compiler.
    Raises OSError when the compiler does not run and CalledProcessError
    when it fails."""
    res = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True, check=True)
    return res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def cpu_identity() -> str:
    """The host CPU's model name and feature flags (the first processor of
    ``/proc/cpuinfo``); the machine and processor names where that file
    cannot be read."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    fields = {}
    for line in lines:
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags", "Features") and key not in fields:
            fields[key] = value.strip()
    return "\n".join(f"{k}: {v}" for k, v in sorted(fields.items()))


def keyed_build(build_dir: pathlib.Path, name: str,
                sources: Sequence[os.PathLike], command: Sequence[str],
                native_cpu: bool = False) -> pathlib.Path:
    """The library ``build_dir/lib<name>-<key>.so``, compiled now unless a
    file of that key exists.

    ``command`` is the compiler's argument list, ``command[0]`` the
    compiler, with :data:`OUT` where the output file goes; ``native_cpu``
    adds the host CPU to the key (``-march=native``).  The library is
    written under a temporary name and renamed into place, so concurrent
    first uses never load a half-written file.  A failed compile raises
    ``subprocess.CalledProcessError`` with the compiler's output.
    """
    command = list(command)
    key = build_key(sources, command, compiler_version(command[0]),
                    cpu_identity() if native_cpu else None)
    lib = build_dir / f"lib{name}-{key}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run([tmp if arg == OUT else arg for arg in command],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib
