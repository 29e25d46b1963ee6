"""The port's device decode of foreign early-CLEAR streams, on the CPU.

``parse_epochs`` is numpy in both packages and must agree exactly;
``decode_variable_nonstrict_device`` runs the port's plain pass 1 and
pass 2 against the JAX package's (Pallas in interpret mode) and the scalar
oracle; ``spliced_nonstrict_stream`` made by the port's encoder must equal
the JAX package's byte for byte.  Everything compared is bytes or integers:
tolerance 0.
"""

import numpy as np
import pytest

from lzw_tpu.kernels import nonstrict as jns
from lzw_tpu.kernels import schedule as jsched
from lzw_tpu.ops import reference as oracle
from lzw_tpu.parallel import BlockParallelCodec as JaxCodec
from lzw_tpu.spec import Endianness as JEndianness
from lzw_tpu.spec import LzwSpec as JSpec
from lzw_tpu.spec import MissingClearCodeError as JMissingClear
from lzw_tpu.utils.testdata import spliced_nonstrict_stream as jax_spliced

from lzw_tpu_torch import (
    BlockParallelCodec, MissingClearCodeError, TruncatedStreamError,
    from_reference_spec,
)
from lzw_tpu_torch.kernels import nonstrict as tns
from lzw_tpu_torch.kernels import schedule as tsched
from lzw_tpu_torch.native.runtime import NativeRuntime
from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.utils.testdata import spliced_nonstrict_stream

SPECS = {"gif7": JSpec.gif(7), "gif2": JSpec.gif(2), "tiff": JSpec.tiff(),
         "cs8_be": JSpec.variable(8, JEndianness.BIG)}
PIECES = {"gif7": 900, "gif2": 500, "tiff": 1300, "cs8_be": 2999}


def _src(spec, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, spec.max_code_value + 1, n).astype(
        np.uint8).tobytes()


def _matrix(streams):
    pb = max(max(len(s) for s in streams), 1)
    pay = np.zeros((len(streams), pb), np.uint8)
    plens = np.zeros(len(streams), np.int64)
    for i, s in enumerate(streams):
        pay[i, : len(s)] = np.frombuffer(s, np.uint8)
        plens[i] = len(s)
    return pay, plens


def _streams(name, seed):
    """Spliced streams, a strict one (the resegmenter decodes a superset)
    and an empty one."""
    spec = SPECS[name]
    srcs = [_src(spec, n, seed + k) for k, n in enumerate((3000, 100, 5000))]
    streams = [jax_spliced(s, spec, PIECES[name]) for s in srcs]
    srcs.append(_src(spec, 9000, seed + 7))
    streams.append(oracle.encode_bytes(srcs[-1], spec))
    return srcs + [b""], streams + [b""]


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("n", [1, 7, 2500, 7000])
def test_spliced_stream_matches_jax(name, n):
    spec = SPECS[name]
    src = _src(spec, n, seed=n)
    want = jax_spliced(src, spec, PIECES[name])
    assert spliced_nonstrict_stream(src, from_reference_spec(spec),
                                    PIECES[name]) == want


@pytest.mark.parametrize("name", list(SPECS))
def test_parse_epochs_matches_jax(name):
    spec = SPECS[name]
    _, streams = _streams(name, seed=10)
    pay, plens = _matrix(streams)
    want = jns.parse_epochs(pay, plens, spec)
    got = tns.parse_epochs(pay, plens, from_reference_spec(spec))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", list(SPECS))
def test_nonstrict_device_decode_matches_jax(name):
    spec = SPECS[name]
    srcs, streams = _streams(name, seed=20)
    pay, plens = _matrix(streams)
    want = jns.decode_variable_nonstrict_device(pay, plens, spec, 1 << 14,
                                                interpret=True)
    got = tns.decode_variable_nonstrict_device(
        pay, plens, from_reference_spec(spec), 1 << 14, device="cpu")
    assert got == want
    assert got[-1] == b""  # an empty payload
    for i, src in enumerate(srcs[:-1]):
        assert got[i] == oracle.decode_bytes(streams[i], spec) == src


def _truncated_strict_stream(spec, n_data, tail=()):
    """A valid stream of exactly ``n_data`` data codes (an oracle encode
    cut short) with ``tail`` (code, width) symbols appended."""
    src = _src(spec, 4 * n_data + 4096, seed=42)
    cw = oracle.encode_codes(src, spec)
    body = [(c, w) for c, w in cw if c not in (spec.clear_code,
                                               spec.end_code)]
    return oracle.pack_codes([cw[0]] + body[:n_data] + list(tail),
                             spec.endianness)


def test_nonstrict_table_full_edges_match_jax():
    # EOI on the last slot of a would-be-full epoch, and EOI where the
    # table-full CLEAR would sit: both end the stream.
    spec = JSpec.gif(7)
    S_e = jns._full_epoch_len(spec)
    assert tsched.epoch_steps(from_reference_spec(spec)) == S_e
    sched = jsched.emission_schedule(spec, S_e + 2)
    streams = [
        _truncated_strict_stream(
            spec, n, [(spec.end_code, sched.eoi_width(n, True))])
        for n in (S_e - 1, S_e)
    ]
    pay, plens = _matrix(streams)
    got = tns.decode_variable_nonstrict_device(
        pay, plens, from_reference_spec(spec), 1 << 14, device="cpu")
    assert got == [oracle.decode_bytes(s, spec) for s in streams]


def test_nonstrict_errors_match_jax():
    spec = JSpec.gif(7)
    tspec = from_reference_spec(spec)
    # A data code where the table-full CLEAR must sit.
    S_e = jns._full_epoch_len(spec)
    bad = _truncated_strict_stream(spec, S_e, [(300, 12), (spec.end_code, 12)])
    pay, plens = _matrix([bad])
    with pytest.raises(JMissingClear):
        jns.decode_variable_nonstrict_device(pay, plens, spec, 1 << 14,
                                             interpret=True)
    with pytest.raises(MissingClearCodeError):
        tns.decode_variable_nonstrict_device(pay, plens, tspec, 1 << 14,
                                             device="cpu")
    # A stream cut in half.
    stream = jax_spliced(_src(spec, 3000, seed=3), spec, 1000)
    pay, plens = _matrix([stream[: len(stream) // 2]])
    with pytest.raises(TruncatedStreamError):
        tns.decode_variable_nonstrict_device(pay, plens, tspec, 1 << 13,
                                             device="cpu")


@pytest.mark.parametrize("name", ["gif7", "tiff"])
def test_container_nonstrict_device_route(name, monkeypatch):
    spec = SPECS[name]
    bs = 1 << 13
    data = _src(spec, bs * 2 + 777, seed=4)
    payloads = [jax_spliced(data[i : i + bs], spec, 1100)
                for i in range(0, len(data), bs)]
    container = framing.pack_frame(from_reference_spec(spec), bs, len(data),
                                   payloads)
    # The JAX codec, with its native runtime, decodes the same container.
    assert JaxCodec(spec, block_size=bs).decode(container) == data

    def host_called(*args, **kwargs):
        raise AssertionError("the device route called the native runtime")

    monkeypatch.setattr(NativeRuntime, "apply_words", host_called)
    monkeypatch.setattr(NativeRuntime, "decode_blocks", host_called)
    stages = {}
    codec = BlockParallelCodec(from_reference_spec(spec), block_size=bs,
                               device="cpu", pass2="device",
                               stage_times=stages)
    assert codec.decode(container) == data
    assert {"dec_parse_epochs", "dec_pass1", "dec_pass2",
            "dec_d2h_out"} <= set(stages)
