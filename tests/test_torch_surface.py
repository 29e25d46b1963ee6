"""The port's public surface against the JAX package's.

Every name that a module of ``lzw_tpu`` exports (its ``__all__``, or its
public top-level functions and classes where it has none) exists in the
counterpart module of ``lzw_tpu_torch``, under the same name or under the
one that :data:`RENAMED` gives it, or :data:`RENAMED` says why it needs no
port.  Then ``kernels.schedule.unpack_variable`` against the JAX function
on the streams of ``tests/test_schedule.py``, and the framing names that
``lzw_tpu_torch.parallel`` re-exports.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import lzw_tpu
from lzw_tpu.kernels import schedule as jschedule
from lzw_tpu.ops import reference as joracle
from lzw_tpu.spec import CodeSizeStrategy as JStrategy
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec

import lzw_tpu_torch.parallel as tparallel
from lzw_tpu_torch import from_reference_spec
from lzw_tpu_torch.kernels import schedule as tschedule
from lzw_tpu_torch.parallel import framing

# The port's module of each JAX module, where the name differs; None: the
# module needs no port.
MODULES = {
    "lzw_tpu.kernels.decode_pallas": "lzw_tpu_torch.kernels.decode",
    "lzw_tpu.kernels.encode_pallas": "lzw_tpu_torch.kernels.encode",
    "lzw_tpu.kernels.common": None,
}
# (JAX module, name) -> the port's name in the counterpart module, or a
# string starting "no port:" with the reason.  TPU mechanics are dropped by
# design (ROADMAP.md, North star and Queue 1).
NO_TPU = "no port: a TPU tile or grid size; one Hopper kernel serves every"
RENAMED = {
    ("lzw_tpu.ops.bitpack", "pack_codes_jax"): "pack_codes_torch",
    ("lzw_tpu.ops.bitpack", "unpack_fixed_jax"): "unpack_fixed_torch",
    ("lzw_tpu.kernels.schedule", "pack_variable_device"): "pack_variable",
    ("lzw_tpu.parallel.block", "default_mesh"): "default_devices",
    ("lzw_tpu.parallel.block", "local_mesh"): "local_devices",
    ("lzw_tpu.kernels.encode_pallas", "encode_blocks_fixed_tpu"):
        "encode_blocks_fixed",
    ("lzw_tpu.kernels.encode_pallas", "encode_blocks_variable_codes_tpu"):
        "encode_blocks_codes",
    # Encode and bit-pack as two XLA programs (a miscompile containment);
    # the port's container calls the parse, then schedule.pack_variable.
    ("lzw_tpu.kernels.encode_pallas", "encode_pack_variable_tpu"):
        "encode_blocks_codes",
    ("lzw_tpu.kernels.encode_pallas", "BLOCK_SIZE"): NO_TPU + " block size",
    ("lzw_tpu.kernels.encode_pallas", "GROUP"): NO_TPU + " block size",
    ("lzw_tpu.kernels.encode_pallas", "GROUP_CHUNKED"): NO_TPU + " block size",
    ("lzw_tpu.kernels.encode_pallas", "CHUNK"): NO_TPU + " block size",
    ("lzw_tpu.kernels.encode_pallas", "group_for"): NO_TPU + " block size",
    ("lzw_tpu.kernels.decode_pallas", "decode_pass1_fixed_tpu"):
        "decode_pass1_fixed",
    ("lzw_tpu.kernels.decode_pallas", "decode_pass1_variable_tpu"):
        "decode_pass1_variable",
    # The TPU's strict all-device decodes (whole blocks, epoch-split, and
    # sorted-pool epoch-split): one all-device decode on Hopper.
    ("lzw_tpu.kernels.decode_pallas", "decode_variable_device_run"):
        "decode_variable_all_device",
    ("lzw_tpu.kernels.decode_pallas", "decode_variable_epochs_run"):
        "decode_variable_all_device",
    ("lzw_tpu.kernels.decode_pallas", "decode_variable_epochs_pooled"):
        "decode_variable_all_device",
    ("lzw_tpu.kernels.decode_pallas", "epoch_bounds"):
        "no port: the epoch spans of the TPU's epoch-split pass 2; the "
        "Hopper walk takes whole blocks",
    ("lzw_tpu.kernels.decode_pallas", "GROUP"): NO_TPU + " block size",
    ("lzw_tpu.kernels.decode_pallas", "GROUP_VAR"): NO_TPU + " block size",
    ("lzw_tpu.kernels.decode_pallas", "NARROW_BLOCK"):
        "no port: the TPU's single-plane table bound; decode_pass1.cu "
        "takes every block size",
    ("lzw_tpu.kernels.common", "compact_columns_jax"):
        "no port: Mosaic's roll-based compaction; the kernels write dense "
        "rows through a cursor",
    ("lzw_tpu.kernels.common", "shift_columns_jax"):
        "no port: Mosaic's roll-based compaction",
    ("lzw_tpu.kernels.common", "_tpu_roll"):
        "no port: Mosaic's roll-based compaction",
    ("lzw_tpu.utils.cache", "enable_compilation_cache"):
        "no port: JAX's compilation cache; the port keys its builds "
        "(lzw_tpu_torch.utils.cache.keyed_build)",
}


def _jax_modules():
    names = ["lzw_tpu"] + [m.name for m in pkgutil.walk_packages(
        lzw_tpu.__path__, "lzw_tpu.")]
    return sorted(names)


def _exported(module) -> list[str]:
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return sorted(
        name for name, obj in vars(module).items()
        if not name.startswith("_")
        and (inspect.isfunction(obj) or inspect.isclass(obj))
        and obj.__module__ == module.__name__)


@pytest.mark.parametrize("jax_name", _jax_modules())
def test_every_public_name_is_ported(jax_name):
    jax_mod = importlib.import_module(jax_name)
    port_name = MODULES.get(jax_name,
                            "lzw_tpu_torch" + jax_name[len("lzw_tpu"):])
    port = None if port_name is None else importlib.import_module(port_name)
    missing = []
    for name in _exported(jax_mod):
        target = RENAMED.get((jax_name, name), name)
        if target.startswith("no port:"):
            continue
        if port is None or not hasattr(port, target):
            missing.append(f"{name} -> {port_name}.{target}")
    assert not missing, missing


def test_rename_table_names_real_exports():
    """Every row of the table is a name the JAX module exports, and every
    counterpart it names exists in the port."""
    for (jax_name, name), target in RENAMED.items():
        assert name in _exported(importlib.import_module(jax_name)), name
        if not target.startswith("no port:"):
            port = importlib.import_module(
                MODULES.get(jax_name,
                            "lzw_tpu_torch" + jax_name[len("lzw_tpu"):]))
            assert hasattr(port, target), (jax_name, target)


def test_parallel_reexports_framing():
    assert tparallel.FrameHeader is framing.FrameHeader
    assert tparallel.pack_frame is framing.pack_frame
    assert tparallel.parse_frame is framing.parse_frame
    assert {"FrameHeader", "pack_frame", "parse_frame"} <= set(
        tparallel.__all__)
    assert "unpack_variable" in tschedule.__all__


SPECS = {
    "gif2": JSpec.gif(2),
    "gif7": JSpec.gif(7),
    "tiff": JSpec.tiff(),
    "var4": JSpec.variable(4, JEndianness.BIG, JStrategy.TIFF),
    "var8": JSpec.variable(8, JEndianness.LITTLE),
}


def _same_unpack(payloads, plens, jspec):
    want = jschedule.unpack_variable(payloads, plens, jspec)
    got = tschedule.unpack_variable(payloads, plens,
                                    from_reference_spec(jspec))
    for g, w, dtype in zip(got, want, (np.int32, np.int32, np.bool_)):
        assert isinstance(g, np.ndarray) and g.dtype == dtype
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("name", list(SPECS))
def test_unpack_variable_matches_jax(name):
    """The streams of tests/test_schedule.py::test_unpack_round_trip."""
    jspec = SPECS[name]
    rng = np.random.default_rng(3)
    datas = [rng.integers(0, 1 << jspec.code_size, size=k).astype(
        np.uint8).tobytes() for k in (0, 1, 40, 900, 6000)]
    payload_list = [joracle.encode_bytes(d, jspec) for d in datas]
    pb = ((max(len(p) for p in payload_list) + 3) // 4) * 4
    payloads = np.zeros((len(datas), pb), np.uint8)
    plens = np.zeros(len(datas), np.int64)
    for i, p in enumerate(payload_list):
        payloads[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    dense, counts, strict = _same_unpack(payloads, plens, jspec)
    assert strict[2:].all() and counts[0] == 0


def test_unpack_variable_flags_an_early_clear():
    """tests/test_schedule.py::test_nonstrict_detected: CLEAR, 0, CLEAR, 0,
    EOI at cs=2 is legal but not schedule-strict."""
    jspec = JSpec.gif(2)
    cw = [(4, 3), (0, 3), (4, 3), (0, 3), (5, 3)]
    enc = joracle.pack_codes(cw, jspec.endianness)
    payloads = np.zeros((1, 8), np.uint8)
    payloads[0, : len(enc)] = np.frombuffer(enc, np.uint8)
    _, _, strict = _same_unpack(payloads, np.array([len(enc)], np.int64),
                                jspec)
    assert not strict[0]


def test_unpack_variable_matches_the_device_unpack():
    """On the CPU it is recover_counts, then unpack_variable_device."""
    jspec = JSpec.gif(7)
    spec = from_reference_spec(jspec)
    enc = joracle.encode_bytes(bytes(range(100)) * 30, jspec)
    payloads = np.zeros((2, len(enc) + 5), np.uint8)
    payloads[0, : len(enc)] = np.frombuffer(enc, np.uint8)
    plens = np.array([len(enc), 0], np.int64)
    counts, strict, S = tschedule.recover_counts(payloads, plens, spec)
    dense, data_ok = tschedule.unpack_variable_device(
        torch.from_numpy(payloads), torch.from_numpy(counts), spec, S)
    got = tschedule.unpack_variable(payloads, plens, spec)
    np.testing.assert_array_equal(got[0], dense.numpy())
    np.testing.assert_array_equal(got[1], counts)
    np.testing.assert_array_equal(got[2], strict & data_ok.numpy())


# ---- the port's device defaults -------------------------------------------

import lzw_tpu_torch  # noqa: E402
from lzw_tpu_torch import api as tapi  # noqa: E402

# Fixture makers whose users are the CPU tests keep a CPU default.
CPU_FIXTURES = ("lzw_tpu_torch.utils.testdata",)


def _device_parameters() -> dict[str, object]:
    """{module:qualname: the default of its ``device`` parameter} of every
    public function and public method (``__init__`` included) that a
    module of ``lzw_tpu_torch`` exports, but the CPU fixture makers."""
    found = {}
    for info in pkgutil.walk_packages(lzw_tpu_torch.__path__,
                                      "lzw_tpu_torch."):
        if info.name in CPU_FIXTURES:
            continue
        module = importlib.import_module(info.name)
        for name in _exported(module):
            obj = getattr(module, name)
            if inspect.isclass(obj):
                funcs = [f for key, f in vars(obj).items()
                         if inspect.isfunction(f)
                         and (key == "__init__" or not key.startswith("_"))]
            else:
                funcs = [obj] if inspect.isfunction(obj) else []
            for f in funcs:
                param = inspect.signature(f).parameters.get("device")
                if param is not None:
                    found[f"{f.__module__}:{f.__qualname__}"] = param.default
    return found


@pytest.mark.parametrize("name", sorted(_device_parameters()))
def test_no_entry_point_defaults_to_the_cpu(name):
    """An entry point runs on the card unless the caller asks for the CPU:
    its ``device`` defaults to "cuda", to None (the input's device, or the
    facade's DEFAULT_DEVICE), or has no default."""
    default = _device_parameters()[name]
    allowed = ("cuda", tapi.DEFAULT_DEVICE)
    assert (default is None or default is inspect.Parameter.empty
            or str(default) in allowed), f"{name} defaults to {default!r}"


def test_device_defaults_cover_the_decode_entry_points():
    names = _device_parameters()
    for want in ("lzw_tpu_torch.kernels.decode:variable_pass1",
                 "lzw_tpu_torch.kernels.decode:decode_pass1_variable",
                 "lzw_tpu_torch.kernels.decode:decode_variable_all_device",
                 "lzw_tpu_torch.kernels.nonstrict:"
                 "decode_variable_nonstrict_device"):
        assert names[want] == "cuda", want
