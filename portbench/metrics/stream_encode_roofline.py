"""The single-stream encode kernel's (``csrc/stream_encode.cu``) share of
its roofline in the profiled encode calls: the work
``encode_parse_roofline`` counts for the same job, the input bytes and 4 B
a data code at the HBM bandwidth (or a probe a byte at the integer peak),
over its device time."""

from portbench import readers, roofline


def read(run):
    return readers.kernel_roofline(
        run, "encode", "stream_encode_kernel",
        lambda exp, n: roofline.encode_parse(n, exp.codes))
