"""The card's peaks, and the work of each kernel a roofline share reads.

A kernel's roofline share is the least time its work can take on the
card, the larger of its bytes over the memory bandwidth and its 32-bit
integer operations over their peak, divided by its device time in the
trace.  The work is counted from the run's own data: each input byte read
once and each output byte written once, whatever the kernel reads again.

Peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W): 3.35 TB/s of HBM, and
16.7 T integer operations a second (64 a clock on each of 132 SMs at
1.98 GHz, CUDA C++ Programming Guide, compute capability 9.0).  A card
held below 700 W runs slower, so a share is read beside its card's power
limit.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
# Each data code leaves the encode-parse kernel, and each word descriptor
# leaves pass 1 and enters pass 2, as one 32-bit value.
CODE_BYTES = 4


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / INT32_OPS_S)


def encode_parse(in_bytes: int, codes: int) -> tuple[int, int]:
    """(bytes, ops) of the encode-parse kernel over one container: the
    blocks in, a code out for each data code; one dictionary probe a
    byte."""
    return in_bytes + CODE_BYTES * codes, in_bytes


def decode_pass1(payload_bytes: int, codes: int) -> tuple[int, int]:
    """(bytes, ops) of decode pass 1: the payloads in, a word descriptor
    out for each data code; one table step a code."""
    return payload_bytes + CODE_BYTES * codes, codes


def decode_pass2(out_bytes: int, codes: int) -> tuple[int, int]:
    """(bytes, ops) of decode pass 2: the descriptors in, the decoded bytes
    out; one step a byte."""
    return CODE_BYTES * codes + out_bytes, out_bytes


def share_pct(work: list[tuple[int, int]], device_s: float) -> float | None:
    """The roofline share of a kernel, in percent, over calls whose
    (bytes, ops) are ``work`` and which took ``device_s`` seconds on the
    card together; None when the trace holds no time of it."""
    if not work or device_s <= 0:
        return None
    return 100 * sum(least_seconds(b, o) for b, o in work) / device_s
