"""The port's bound launch path, on the CPU: the prototype table of
``lzw_tpu_torch.kernels.build`` against the kernels' sources.

Every ``extern "C"`` function of ``lzw_tpu_torch/kernels/csrc/*.cu`` must
stand in ``build.PROTOTYPES`` under its library with the same parameters,
one ctypes type each (a pointer ``c_void_p``, ``int`` ``c_int``,
``int64_t`` ``c_int64``, ``unsigned`` ``c_uint``) and an ``int`` return:
ctypes without ``argtypes`` passes a Python int as a C int and cuts a
pointer to 32 bits.  No wrapper sets ``argtypes`` on a call any more.  And
P1's and P2's launch geometries (``kernels.ablate.PARSE_LAYOUT`` and
``RING_LAYOUT``) match their sources and fit one CTA's shared memory.
"""

import ctypes
import math
import pathlib
import re

import pytest

from lzw_tpu_torch.kernels import ablate, build

PACKAGE = pathlib.Path(build.__file__).resolve().parent.parent
CSRC = PACKAGE / "kernels" / "csrc"
# Shared memory a CTA can use on the H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin).
MAX_SHARED_BYTES = 232448

_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "unsigned": ctypes.c_uint, "uint32_t": ctypes.c_uint}


def _c_type(param: str):
    """The ctypes type of one C parameter declaration."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()[:-1]  # drop the name
    words = [w for w in words if w != "const"]
    return _C_TYPES[" ".join(words)]


def _extern_c(path: pathlib.Path) -> dict[str, tuple[str, list]]:
    """{symbol: (return type, [ctypes type of each parameter])} of the
    ``extern "C"`` functions of one source."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    out = {}
    for ret, name, params in re.findall(
            r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', text):
        params = " ".join(params.split())
        out[name] = (ret, [_c_type(p.strip()) for p in params.split(",")])
    return out


SOURCES = sorted(p.stem for p in CSRC.glob("*.cu"))


def test_every_source_is_a_kernel():
    assert SOURCES == sorted(build.KERNELS)
    assert sorted(build.PROTOTYPES) == sorted(build.KERNELS)


@pytest.mark.parametrize("kernel", SOURCES)
def test_prototypes_match_the_source(kernel):
    functions = _extern_c(CSRC / f"{kernel}.cu")
    assert functions, kernel
    assert sorted(functions) == sorted(build.PROTOTYPES[kernel])
    for symbol, (ret, params) in functions.items():
        assert ret == "int", symbol
        assert build.argtypes(kernel, symbol) == params, symbol


def test_the_stream_is_the_last_pointer():
    # Each launch function takes the stream last; the occupancy queries
    # end in an out pointer.
    for kernel, functions in build.PROTOTYPES.items():
        for symbol, letters in functions.items():
            assert set(letters) <= set("PILU"), symbol
            assert letters.endswith("P"), symbol


def test_no_wrapper_sets_argtypes():
    # build.py binds the kernels' prototypes once, when a library loads;
    # native/runtime.py binds the host runtime's the same way.
    binders = {PACKAGE / "kernels" / "build.py",
               PACKAGE / "native" / "runtime.py"}
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path in binders:
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\.(argtypes|restype)\s*=", line):
                offenders.append(f"{path.relative_to(PACKAGE)}:{n}")
    assert offenders == []


def test_no_wrapper_loads_a_library_itself():
    # A wrapper takes its function from build.bound, never from the
    # library's attributes.
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.name == "build.py":
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"build\.load\([^)]*\)\.", line) or \
                    "getattr(build.load" in line:
                offenders.append(f"{path.relative_to(PACKAGE)}:{n}")
    assert offenders == []


def _constants(source: str) -> dict[str, int]:
    """The integer ``constexpr int`` and ``constexpr uint32_t`` constants of
    a kernel source, each expression evaluated over the ones before it."""
    text = (CSRC / source).read_text()
    out: dict[str, int] = {}
    for name, expr in re.findall(
            r"constexpr (?:int|uint32_t) (k\w+) =\s*([^;]+);", text):
        expr = re.sub(r"(\d+)u\b", r"\1", " ".join(expr.split()))
        out[name] = int(eval(expr, {}, dict(out)))
    return out


def test_parse_layout_matches_the_source_and_fits():
    k = _constants("ablate_parse.cu")
    layout = ablate.PARSE_LAYOUT
    assert layout == (k["kLanesPerCta"], k["kThreads"], k["kMaxCluster"],
                      k["kSharedBytes"])
    assert layout.threads == 32 * layout.lanes_per_cta <= 1024
    assert layout.shared_bytes <= MAX_SHARED_BYTES
    # The scripts' 128 lanes a group fit one cluster, at most 16 CTAs.
    assert layout.max_cluster * layout.lanes_per_cta >= 128
    assert layout.max_cluster <= 16
    # A lane's table holds every row the parse can write (256..4095) at
    # under 5/8 of its slots, so a probe ends.
    assert k["kRows"] == 4096 - 256 and 8 * k["kRows"] <= 5 * k["kSlots"]


def test_ring_layout_matches_the_source_and_fits():
    k = _constants("ablate_ring.cu")
    layout = ablate.RING_LAYOUT
    assert layout == (k["kMaxLanesPerCta"], k["kChunk"], k["kLaneBytes"],
                      k["kMaxRing"], k["kMaxSharedBytes"])
    assert layout.max_shared_bytes == MAX_SHARED_BYTES
    # The index's row field holds row + 1 in kRowBits bits.
    assert layout.max_ring == (1 << k["kRowBits"]) - 1
    # At most 3840 inserts keep the slots under 5/8 full, so a walk ends;
    # a slot index fits the u16 each ring row keeps.
    assert 8 * (4096 - 256) <= 5 * k["kSlots"] < 5 * (1 << 16)
    for ring in (1, 4, 512, 1024, layout.max_ring):
        per_cta = layout.lanes_per_cta(ring)
        assert 1 <= per_cta <= layout.max_lanes_per_cta
        assert 32 * per_cta <= 1024
        assert layout.shared_bytes(ring) <= MAX_SHARED_BYTES
        assert layout.shared_bytes(ring) == per_cta * (
            k["kLaneBytes"] + 6 * ring)
    # The script's ring of 512 keeps 8 lanes a CTA: 1024 lanes on 128 SMs.
    assert layout.lanes_per_cta(512) == 8
    assert layout.lanes_per_cta(layout.max_ring) == 4


@pytest.mark.parametrize("variant", list(ablate.PARSE_VARIANTS))
@pytest.mark.parametrize("lanes", [1, 8, 96, 128, 129, 1024])
def test_parse_grid(variant, lanes):
    lockstep = variant in ("scan_wininsert", "seg2")
    ctas = math.ceil(lanes / 8)
    if lockstep and lanes > 128:
        with pytest.raises(ValueError, match="at most 128 lanes"):
            ablate.parse_grid(2, lanes, variant)
        return
    assert ablate.parse_grid(2, lanes, variant) == (
        ctas, 2, ctas if lockstep else 1)
