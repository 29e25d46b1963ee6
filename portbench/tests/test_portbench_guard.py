"""What the benchmark may import, and how it ends without a card.

Module names are compared whole: ``lzw_tpu_torch``, the program, begins
with ``lzw_tpu``, the JAX package, and is not it.
"""

from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imports(path: pathlib.Path) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "lzw_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "dataclasses", "struct", "numpy",
                              "portbench"}


def test_the_import_check_compares_whole_names():
    assert _imports_of("import lzw_tpu_torch.spec") == {"lzw_tpu_torch"}
    assert "lzw_tpu_torch" not in harness.FORBIDDEN
    sys.modules["lzw_tpu_torch_probe"] = object()
    try:
        assert "lzw_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["lzw_tpu_torch_probe"]
    sys.modules["lzw_tpu.probe"] = object()
    try:
        assert harness.forbidden_modules() == ["lzw_tpu"]
    finally:
        del sys.modules["lzw_tpu.probe"]


def _imports_of(source: str) -> set[str]:
    path = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / "pb_probe.py"
    path.write_text(source)
    try:
        return _imports(path)
    finally:
        path.unlink()


def _run(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "gif7-image-one",
         "--seed", "2147483701", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_and_prints_no_result():
    res = _run(ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_without_the_program_it_exits_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "lzw_tpu_torch" in res.stderr


_POOL_THEN_END = """
import subprocess, sys
from portbench import harness
from portbench.reference.lzw import Wire
from portbench.generator import Input
wire = Wire.from_dict({"flavor": "variable", "code_size": 7})
inputs = [Input(bytes(range(128)) * 64), Input(bytes(4096))]
harness._expected(inputs, wire, 4096, 2)
stray = subprocess.Popen(["sleep", "600"])
harness.end_children()
print(stray.poll() is not None, harness._children() == [])
"""


def _session(sid: int) -> list[str]:
    """The command lines of the processes still in session ``sid``."""
    left = []
    for entry in pathlib.Path("/proc").iterdir():
        try:
            stat = (entry / "stat").read_text()
            fields = stat[stat.rfind(")") + 2:].split()
            if entry.name.isdigit() and int(fields[3]) == sid:
                left.append((entry / "cmdline").read_text())
        except OSError:
            continue
    return left


@pytest.mark.skipif(not pathlib.Path("/proc/self/stat").exists(),
                    reason="reads processes from /proc")
def test_a_run_leaves_no_process_behind():
    proc = subprocess.Popen(
        [sys.executable, "-c", _POOL_THEN_END], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert out.split() == ["True", "True"]
    assert err.count("still running; killed") == 1  # the stray alone
    assert "leaked" not in err
    assert _session(proc.pid) == []
