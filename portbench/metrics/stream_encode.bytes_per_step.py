"""Bytes the stream encode kernel (``csrc/stream_encode.cu``) walks a step
in the profiled encode calls: the counters ``stream_encode.bytes`` over
``stream_encode.steps``, the phrases (the mean phrase length).
Nothing to read where the program keeps no such counters."""

from portbench import spans


def read(run):
    return spans.ratio("stream_encode.bytes", "stream_encode.steps")
