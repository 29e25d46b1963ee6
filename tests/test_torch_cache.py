"""Builds keyed by content (``lzw_tpu_torch.utils.cache``).

The key of a kernel library changes with one byte of its ``.cu`` or of a
``.cuh``, with a flag and with the compiler's version; the native
library's also with the host CPU.  A library whose key matches is loaded
without a compile; one whose flags differ is rebuilt even when its file is
newer than its sources, which a build that compared file times reused.
No compiler runs here: ``subprocess.run`` is replaced by a stub that
answers ``--version`` and writes the output file of a compile.
"""

import os
import pathlib
import shutil
import subprocess
import time

import pytest

from lzw_tpu_torch import LzwSpec
from lzw_tpu_torch.kernels import build
from lzw_tpu_torch.native import runtime
from lzw_tpu_torch.utils import cache

FAKE_NVCC = "fake-cuda/bin/nvcc"


class FakeCompiler:
    """``subprocess.run`` for the builds: ``<compiler> --version`` prints
    ``version``; a compile writes ``payload`` to the file after ``-o`` and
    is recorded; with ``forbid`` a compile fails the test."""

    def __init__(self, version="fake nvcc 12.8", payload=b"\x7fELF fake"):
        self.version = version
        self.payload = payload
        self.compiles = []
        self.forbid = False

    def __call__(self, argv, **kwargs):
        if argv[1:] == ["--version"]:
            return subprocess.CompletedProcess(argv, 0, self.version, "")
        if self.forbid:
            raise AssertionError(f"compiled again: {argv}")
        self.compiles.append(list(argv))
        out = argv[argv.index("-o") + 1]
        pathlib.Path(out).write_bytes(self.payload)
        return subprocess.CompletedProcess(argv, 0, "", "")


@pytest.fixture
def fake(monkeypatch, tmp_path):
    """Kernel builds into ``tmp_path/build`` from a copy of ``csrc`` with
    a fake ``nvcc``; the version and CPU caches cleared around the test."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    compiler = FakeCompiler()
    monkeypatch.setattr(subprocess, "run", compiler)
    monkeypatch.setattr(build, "find_nvcc", lambda: FAKE_NVCC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_bound", {})
    cache.compiler_version.cache_clear()
    cache.cpu_identity.cache_clear()
    yield compiler
    cache.compiler_version.cache_clear()
    cache.cpu_identity.cache_clear()


def _kernel_key(name):
    src = build.CSRC / f"{name}.cu"
    command = [FAKE_NVCC, *build.NVCC_FLAGS, "-o", cache.OUT, str(src)]
    return cache.build_key([src, *build.CSRC.glob("*.cuh")], command,
                           cache.compiler_version(FAKE_NVCC))


@pytest.mark.parametrize("what", ["cu", "cuh", "flag", "version"])
def test_kernel_key_changes_with_its_inputs(fake, monkeypatch, what):
    before = _kernel_key("decode_pass2")
    if what == "cu":
        src = build.CSRC / "decode_pass2.cu"
        src.write_bytes(src.read_bytes() + b" ")
    elif what == "cuh":
        hdr = build.CSRC / "pass2_slot.cuh"
        data = bytearray(hdr.read_bytes())
        data[-2] ^= 1
        hdr.write_bytes(bytes(data))
    elif what == "flag":
        monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS,
                                                  "-lineinfo"])
    else:
        fake.version = "fake nvcc 12.9"
        cache.compiler_version.cache_clear()
    after = _kernel_key("decode_pass2")
    assert len(before) == len(after) == 16
    assert before != after


def test_kernel_key_is_stable(fake):
    assert _kernel_key("word_ends") == _kernel_key("word_ends")
    assert _kernel_key("word_ends") != _kernel_key("decode_pass2")


def test_native_key_changes_with_the_cpu(monkeypatch, tmp_path):
    src = tmp_path / "lzw_native.cpp"
    src.write_bytes(b"int f() { return 1; }\n")
    cmd = ["g++", "-O3", "-march=native", str(src), "-o", cache.OUT]
    a = cache.build_key([src], cmd, "g++ 13", "model name: A\nflags: sse")
    b = cache.build_key([src], cmd, "g++ 13", "model name: A\nflags: avx")
    c = cache.build_key([src], cmd, "g++ 13", "model name: B\nflags: sse")
    assert len({a, b, c}) == 3
    assert a == cache.build_key([src], cmd, "g++ 13",
                                "model name: A\nflags: sse")
    assert a != cache.build_key([src], cmd, "g++ 13")


def test_cpu_identity_names_model_and_flags():
    ident = cache.cpu_identity()
    assert ident
    if os.path.exists("/proc/cpuinfo") and "flags" in open(
            "/proc/cpuinfo").read():
        assert "flags: " in ident


def test_kernel_library_is_named_by_its_key(fake):
    lib = build._compile("word_ends")
    key = _kernel_key("word_ends")
    assert lib == build.BUILD_DIR / f"libword_ends-{key}.so"
    assert lib.read_bytes() == fake.payload
    assert len(fake.compiles) == 1
    # Built under a temporary name, then renamed: nothing else is left.
    assert [p.name for p in build.BUILD_DIR.iterdir()] == [lib.name]


@pytest.fixture(scope="module")
def real_library():
    """A library that loads: the native runtime's, built by the compiler."""
    return runtime.build()


@pytest.fixture(scope="module")
def stand_in_library(tmp_path_factory):
    """A library that loads and exports ``encode_parse.cu``'s functions
    (each returns 0), built by the host's C++ compiler: a stand-in for
    the kernel's library, whose prototypes ``build.load`` binds."""
    out = tmp_path_factory.mktemp("stand_in")
    src = out / "stand_in.cpp"
    src.write_text("".join(
        f'extern "C" int {symbol}() {{ return 0; }}\n'
        for symbol in build.PROTOTYPES["encode_parse"]))
    lib = out / "libstand_in.so"
    subprocess.run([os.environ.get("CXX", "g++"), "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    return lib


def test_matching_key_is_loaded_without_a_compile(stand_in_library, fake):
    key = _kernel_key("encode_parse")
    lib = build.BUILD_DIR / f"libencode_parse-{key}.so"
    build.BUILD_DIR.mkdir()
    shutil.copy(stand_in_library, lib)
    fake.forbid = True
    assert build._compile("encode_parse") == lib
    assert build.load("encode_parse") is build.load("encode_parse")
    assert fake.compiles == []


def test_a_library_without_a_prototype_is_refused(real_library, fake):
    # The native runtime's library loads but exports none of the kernel's
    # functions: load raises instead of handing out unbound ones.
    key = _kernel_key("encode_parse")
    build.BUILD_DIR.mkdir()
    shutil.copy(real_library, build.BUILD_DIR / f"libencode_parse-{key}.so")
    fake.forbid = True
    with pytest.raises(build.BuildError, match="has no encode_parse_launch"):
        build.load("encode_parse")
    with pytest.raises(build.BuildError):
        build.bound("encode_parse", "encode_parse_launch")


def test_newer_library_with_other_flags_is_rebuilt(fake, monkeypatch):
    # The fault of a build that compared file times: a library newer than
    # its sources was reused whatever flags built it.
    first = build._compile("decode_pass1")
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-G"])
    future = time.time() + 3600
    for lib in build.BUILD_DIR.iterdir():
        os.utime(lib, (future, future))
    second = build._compile("decode_pass1")
    assert len(fake.compiles) == 2
    assert "-G" in fake.compiles[1] and "-G" not in fake.compiles[0]
    assert second != first
    # The library of the other key stays and is not loaded.
    assert first.exists()


def test_failed_compile_raises_build_error(fake, monkeypatch):
    def fail(argv, **kwargs):
        if argv[1:] == ["--version"]:
            return subprocess.CompletedProcess(argv, 0, "fake", "")
        raise subprocess.CalledProcessError(2, argv, "", "error: bad.cu")

    monkeypatch.setattr(subprocess, "run", fail)
    with pytest.raises(build.BuildError, match="bad.cu"):
        build._compile("word_ends")
    assert not build.BUILD_DIR.exists() or not any(build.BUILD_DIR.iterdir())


def test_native_library_is_reused_only_for_its_key(monkeypatch, tmp_path):
    # The real compiler builds once; a second build with the compiler
    # forbidden finds the library of the same key; another CPU rebuilds.
    monkeypatch.setattr(runtime, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_LIB", runtime._LIB)
    lib = runtime.build()
    assert lib.parent == tmp_path and lib.name.startswith("liblzw_native-")
    assert runtime._LIB == lib
    real_run = subprocess.run
    compiles = []

    def counting(argv, **kwargs):
        if argv[1:] != ["--version"]:
            compiles.append(argv)
        return real_run(argv, **kwargs)

    monkeypatch.setattr(subprocess, "run", counting)
    assert runtime.build() == lib
    assert compiles == []
    monkeypatch.setattr(cache, "cpu_identity", lambda: "model name: other")
    other = runtime.build()
    assert other != lib and len(compiles) == 1
    rt = runtime.NativeRuntime(other)
    data = b"TOBEORNOTTOBEORTOBEORNOT" * 40
    assert rt.decode(rt.encode(data, LzwSpec.gif(7)), LzwSpec.gif(7)) == data
