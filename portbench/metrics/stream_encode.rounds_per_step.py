"""The stream encode kernel's (``csrc/stream_encode.cu``) table loads of
its chain warp a phrase, in the profiled encode calls: the counters
``stream_encode.rounds`` over ``stream_encode.steps`` (the phrases).  A
round walks up to six phrases, so 1.0 is one load a phrase and short
phrases read below it.  Nothing to read where the program keeps no such
counters."""

from portbench import spans


def read(run):
    return spans.ratio("stream_encode.rounds", "stream_encode.steps")
