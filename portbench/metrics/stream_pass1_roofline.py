"""The single-stream decode pass 1's (``csrc/stream_pass1.cu``) share of its
roofline in the profiled decode calls: as ``decode_pass1_roofline``, the
stream's bytes and 4 B a word descriptor over its device time."""

from portbench import readers, roofline


def read(run):
    return readers.kernel_roofline(
        run, "decode", "stream_pass1_kernel",
        lambda exp, n: roofline.decode_pass1(exp.payload_bytes, exp.codes))
