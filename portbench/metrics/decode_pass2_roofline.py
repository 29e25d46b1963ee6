"""Decode pass 2's flat walk (``csrc/decode_pass2.cu``) share of its roofline
in the profiled decode calls: 4 B a word descriptor and the bytes out over
its device time."""

from portbench import readers, roofline


def read(run):
    return readers.kernel_roofline(
        run, "decode", "decode_pass2_kernel",
        lambda exp, n: roofline.decode_pass2(n, exp.codes))
