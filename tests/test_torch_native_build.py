"""One build of the native runtime's library per checkout, across test workers.

The JAX package compiles ``lzw_tpu/native/lzw_native.cpp`` straight into
``lzw_tpu/native/build/liblzw_native.so`` on first use, with no lock and no
temporary name.  When several pytest-xdist workers start on a fresh
checkout, two can compile that file at once, and a worker that loads a
half-written library keeps the error for the rest of its run, skipping
every native test in its files.  Every worker imports every test module
while it collects, before it runs any test, so this module builds the
library at import time under an inter-process lock: at most one compile
runs here, and the others find the finished file.

Modules collected before this one (``tests/test_native.py`` calls
``native_available()`` in a module-level ``skipif``) still build without
the lock.  So the prebuild then loads the library, rebuilds it under a
temporary name and renames it into place when it does not load, and clears
an error that this worker's runtime recorded, so that the ``get_runtime()``
calls of its tests retry against the whole library.  A ``skipif`` already
evaluated at collection cannot be rescued from here.  The JAX package
itself is left as it is.

The prebuild never raises: without a compiler the JAX runtime's own error
reports it when a test asks for the runtime.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile

import numpy as np
import pytest

from lzw_tpu.native import runtime as jax_runtime


def _loads(lib) -> bool:
    try:
        ctypes.CDLL(str(lib))
    except OSError:
        return False
    return True


def _rebuild(lib) -> None:
    """Compile the library as ``_build`` does, to a temporary name in its
    directory, and rename it onto ``lib``."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-march=native",
             "-std=c++17", "-fPIC", "-shared", "-pthread",
             str(jax_runtime._SRC), "-o", tmp],
            check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _prebuild_jax_native() -> None:
    try:
        jax_runtime._BUILD_DIR.mkdir(exist_ok=True)
        with open(jax_runtime._BUILD_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                lib = jax_runtime._build()
                if not _loads(lib):
                    _rebuild(lib)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except (OSError, subprocess.CalledProcessError):
        return
    with jax_runtime._lock:
        if jax_runtime._build_error is not None:
            jax_runtime._build_error = None
            jax_runtime._runtime = None


_prebuild_jax_native()


def test_both_native_libraries_build_and_load(lorem_ipsum):
    from lzw_tpu.spec import LzwSpec as JSpec

    from lzw_tpu_torch import LzwSpec
    from lzw_tpu_torch.native import runtime as torch_runtime

    jax_rt = jax_runtime.get_runtime()
    torch_rt = torch_runtime.get_runtime()
    assert jax_runtime._LIB.is_file()
    # The port names its library by its build key (lzw_tpu_torch.utils.cache).
    assert torch_runtime._LIB.is_file()
    assert torch_runtime._LIB.parent == torch_runtime._BUILD_DIR
    assert torch_runtime._LIB.name.startswith("liblzw_native-")
    data = lorem_ipsum[:4000]
    payload = jax_rt.encode(data, JSpec.gif(7))
    assert torch_rt.decode(payload, LzwSpec.gif(7)) == data
    assert jax_rt.decode(payload, JSpec.gif(7)) == data
    blocks = torch_rt.encode_blocks(data, LzwSpec.gif(7), 1024)
    assert torch_rt.decode_blocks(blocks, LzwSpec.gif(7), 1024) == data
    words = np.zeros((1, 1), np.int32)
    out, lengths = torch_rt.apply_words(words, 16)
    assert out.shape == (1, 16) and lengths.tolist() == [0]


def test_prebuild_clears_a_recorded_build_error(monkeypatch, lorem_ipsum):
    # A worker whose first get_runtime() met a half-written library keeps
    # that error; the prebuild clears it, and later calls load the library.
    from lzw_tpu.spec import LzwSpec as JSpec

    monkeypatch.setattr(jax_runtime, "_runtime", None)
    monkeypatch.setattr(jax_runtime, "_build_error",
                        OSError("liblzw_native.so: file too short"))
    with pytest.raises(OSError, match="too short"):
        jax_runtime.get_runtime()
    _prebuild_jax_native()
    assert jax_runtime._build_error is None
    rt = jax_runtime.get_runtime()
    data = lorem_ipsum[:3000]
    assert rt.decode(rt.encode(data, JSpec.gif(7)), JSpec.gif(7)) == data
    assert jax_runtime.native_available()


def test_prebuild_replaces_a_library_that_does_not_load(monkeypatch,
                                                        tmp_path):
    # A half-written library newer than its source: _build keeps it, the
    # prebuild finds that it does not load and renames a whole one onto it.
    lib = tmp_path / "liblzw_native.so"
    lib.write_bytes(b"\x7fELF half")
    monkeypatch.setattr(jax_runtime, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(jax_runtime, "_LIB", lib)
    monkeypatch.setattr(jax_runtime, "_runtime", None)
    monkeypatch.setattr(jax_runtime, "_build_error", None)
    assert not _loads(lib)
    _prebuild_jax_native()
    assert _loads(lib)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".build.lock", "liblzw_native.so"]
