"""The single-stream decode pass 2's (``csrc/stream_pass2.cu``) share of its
roofline in the profiled decode calls: as ``decode_pass2_roofline``, 4 B a
word descriptor and the bytes out over its device time."""

from portbench import readers, roofline


def read(run):
    return readers.kernel_roofline(
        run, "decode", "stream_pass2_kernel",
        lambda exp, n: roofline.decode_pass2(n, exp.codes))
