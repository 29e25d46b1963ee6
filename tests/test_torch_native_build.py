"""One build of the native runtime's library per checkout, across test workers.

The JAX package compiles ``lzw_tpu/native/lzw_native.cpp`` straight into
``lzw_tpu/native/build/liblzw_native.so`` on first use, with no lock and no
temporary name.  When several pytest-xdist workers start on a fresh
checkout, two can compile that file at once, and a worker that loads a
half-written library keeps the error for the rest of its run, failing every
native test in its files.  Every worker imports every test module while it
collects, before it runs any test, so this module builds the library at
import time under an inter-process lock: at most one compile runs, and the
others find the finished file.  The JAX package itself is left as it is.

The prebuild never raises: without a compiler the JAX runtime's own error
reports it when a test asks for the runtime.
"""

import fcntl
import pathlib
import subprocess

import numpy as np

from lzw_tpu.native import runtime as jax_runtime


def _prebuild_jax_native() -> None:
    build_dir = pathlib.Path(jax_runtime.__file__).resolve().parent / "build"
    try:
        build_dir.mkdir(exist_ok=True)
        with open(build_dir / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                jax_runtime._build()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except (OSError, subprocess.CalledProcessError):
        pass


_prebuild_jax_native()


def test_both_native_libraries_build_and_load(lorem_ipsum):
    from lzw_tpu.spec import LzwSpec as JSpec

    from lzw_tpu_torch import LzwSpec
    from lzw_tpu_torch.native import runtime as torch_runtime

    jax_rt = jax_runtime.get_runtime()
    torch_rt = torch_runtime.get_runtime()
    assert jax_runtime._LIB.is_file()
    assert torch_runtime._LIB.is_file()
    data = lorem_ipsum[:4000]
    payload = jax_rt.encode(data, JSpec.gif(7))
    assert torch_rt.decode(payload, LzwSpec.gif(7)) == data
    assert jax_rt.decode(payload, JSpec.gif(7)) == data
    blocks = torch_rt.encode_blocks(data, LzwSpec.gif(7), 1024)
    assert torch_rt.decode_blocks(blocks, LzwSpec.gif(7), 1024) == data
    words = np.zeros((1, 1), np.int32)
    out, lengths = torch_rt.apply_words(words, 16)
    assert out.shape == (1, 16) and lengths.tolist() == [0]
