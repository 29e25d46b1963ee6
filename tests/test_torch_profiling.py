"""The port's run metrics and profiling helpers against the JAX package's.

``lzw_tpu_torch.utils.profiling`` against ``lzw_tpu.utils.profiling``: the
same ``RunMetrics`` numbers and JSON for equal fields, a wall-clock
``Timer``, a ``torch.profiler`` trace written as JSON into its directory,
and the memory report's keys.  All on the CPU: the trace has no CUDA
activity here and the memory report its one ``"cpu"`` entry.
"""

import json
import time

import numpy as np
import pytest
import torch

from lzw_tpu.utils import profiling as jprof

from lzw_tpu_torch import BlockParallelCodec, LzwSpec
from lzw_tpu_torch.utils import profiling

RUNS = [
    ("encode", "gif7", 128 << 20, 46_000_000, 0.31, 2048, 1),
    ("decode", "gif7", 46_000_000, 128 << 20, 0.27, 2048, 2),
    ("encode", "fixed12", 32 << 20, 20_000_000, 0.125, 8192, 8),
    ("decode", "tiff", 9960, 23336, 1e-3, 1, 1),
    ("encode", "gif2", 0, 2, 1e-6, 0, 1),
    ("decode", "gif7", 2, 0, 0.0, 0, 1),
    ("encode", "gif7", 23336, 9960, 0.0, 1, 1),
]


@pytest.mark.parametrize("fields", RUNS, ids=lambda f: f"{f[0]}-{f[1]}-"
                         f"{f[2]}-{f[4]}")
def test_run_metrics_match_the_jax_package(fields):
    ours, theirs = profiling.RunMetrics(*fields), jprof.RunMetrics(*fields)
    assert ours.ratio == theirs.ratio
    assert ours.throughput_bps == theirs.throughput_bps
    assert ours.to_json() == theirs.to_json()


def test_run_metrics_defaults_match():
    ours = profiling.RunMetrics("encode", "gif7", 10, 5, 1.0)
    assert ours.to_json() == jprof.RunMetrics("encode", "gif7", 10, 5,
                                              1.0).to_json()
    assert json.loads(ours.to_json())["n_devices"] == 1


def test_same_public_names():
    assert profiling.__all__ == jprof.__all__


def test_timer_measures_a_sleep():
    with profiling.Timer() as t:
        time.sleep(0.05)
    # A sleep lasts at least its time; a loaded host may add a little.
    assert 0.05 <= t.seconds < 0.5


def test_trace_writes_a_json_trace(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 128, 3000).astype(np.uint8).tobytes()
    codec = BlockParallelCodec(LzwSpec.gif(7), block_size=1024, device="cpu")
    log_dir = tmp_path / "trace"
    with profiling.trace(log_dir):
        out = codec.decode(codec.encode(data))
    assert out == data
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_trace_is_written_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(tmp_path):
            torch.ones(4).sum()
            raise ValueError("inside the traced region")
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    json.loads(files[0].read_text())


def test_device_memory_report_keys():
    report = profiling.device_memory_report()
    keys = {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert report
    for entry in report.values():
        assert set(entry) == keys
    for entry in jprof.device_memory_report().values():
        assert set(entry) == keys
    if not torch.cuda.is_available():
        assert report == {"cpu": dict.fromkeys(keys)}
