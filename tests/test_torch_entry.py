"""The port's entry module against the JAX package's ``__graft_entry__``.

``entry()``'s payloads are bytes and are compared exactly; the dry run
checks its own round trips.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft

from lzw_tpu_torch import Endianness, LzwSpec
from lzw_tpu_torch.entry import dryrun_multichip, entry
from lzw_tpu_torch.native.runtime import get_runtime


def test_entry_payloads_equal_the_jax_entry():
    fn, (blocks, lens) = entry(device="cpu")
    assert blocks.device.type == "cpu" and tuple(blocks.shape) == (4, 4096)
    buf, n_bytes, err = fn(blocks, lens)
    jfn, jargs = graft.entry()
    jbuf, jn, jerr = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jargs[0]))
    assert not err.any() and not jerr.any()
    for i in range(4):
        assert buf[i, : n_bytes[i]].numpy().tobytes() == (
            jbuf[i, : jn[i]].tobytes())
    native = get_runtime().encode_blocks(
        blocks.numpy().tobytes(), LzwSpec.fixed(Endianness.LITTLE), 4096)
    assert [buf[i, : n_bytes[i]].numpy().tobytes() for i in range(4)] == (
        native)


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_dryrun_multichip_on_cpu_devices(n_devices, capsys):
    dryrun_multichip(n_devices, device_type="cpu")
    assert f"dryrun_multichip({n_devices})" in capsys.readouterr().out


def test_dryrun_multichip_needs_the_devices():
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="need"):
            dryrun_multichip(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(1)
