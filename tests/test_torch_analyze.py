"""``lzw_tpu_torch.scripts.analyze_dictionary`` against the JAX package's
``scripts/analyze_dictionary.py`` (imported by path), on ``lorem_ipsum.txt``
and a 64 KiB slice of the image plane, the port on the CPU (the plain
encoder's slots).  Printed lines compared whole.

For fixed-12 the lines equal the JAX script's.  For a variable flavor the
JAX script clears its table right after the insert that fills it, one miss
before the encoder does (the encoder's reset comes at the next miss, which
inserts nothing), so past a reset its histogram of the last epoch is not the
encoder's.  Run with its threshold one code later, the JAX script's own loop
walks the encoder's dictionary, and the port's lines equal it.
"""

import importlib.util
import pathlib
import types

import pytest

from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.scripts import analyze_dictionary
from lzw_tpu_torch.utils.corpus import load_tokyo_pixels

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSETS = ROOT / "test-assets"
SPECS = {"gif7": JSpec.gif(7), "tiff": JSpec.tiff(),
         "fixed-12": JSpec.fixed(JEndianness.LITTLE)}


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_dictionary", ROOT / "scripts" / "analyze_dictionary.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs():
    return {"lorem": (ASSETS / "lorem_ipsum.txt").read_bytes(),
            "image 64 KiB": load_tokyo_pixels(
                ASSETS / "tokyo_128_colors.png")[: 1 << 16]}


def _encoder_reset(jspec):
    """The spec as the JAX script reads it, with its reset threshold one
    code later: the step at which the encoder resets."""
    return types.SimpleNamespace(
        variable=jspec.variable, first_free_code=jspec.first_free_code,
        strategy=types.SimpleNamespace(
            increment=jspec.strategy.increment - 1))


@pytest.mark.parametrize("corpus", ["lorem", "image 64 KiB"])
@pytest.mark.parametrize("name", list(SPECS))
def test_analyze_matches_jax_script(name, corpus, capsys):
    jspec = SPECS[name]
    data = _inputs()[corpus]
    script = _jax_script()
    label = f"{corpus} / {name}"
    script.analyze(data, jspec, label)
    jax_lines = capsys.readouterr().out.splitlines()
    script.analyze(data, _encoder_reset(jspec), label)
    encoder_lines = capsys.readouterr().out.splitlines()
    analyze_dictionary.analyze(data, from_reference_spec(jspec), label,
                               device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0] == f"{label}:"
    assert lines == encoder_lines
    if not jspec.variable:
        assert lines == jax_lines


def test_main_prints_both_flavors_per_corpus(monkeypatch, capsys):
    """``main`` walks load_corpus with gif7 and fixed-12 on ``--device``."""
    monkeypatch.setattr(analyze_dictionary, "load_corpus",
                        lambda _: {"a": b"abcabcabcd" * 20, "b": b"xyz"})
    analyze_dictionary.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if not line.startswith(" ")] == [
        "a / gif cs=7:", "a / fixed-12:", "b / gif cs=7:", "b / fixed-12:"]
    assert len(out) == 12
