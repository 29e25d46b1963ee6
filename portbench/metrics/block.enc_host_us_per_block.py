"""Host work of an encode a block, from the program's spans and counter,
us a block of the profiled calls: the seconds of the spans
``span.enc_host_ms`` sums (``enc_host_prep``, ``enc_payloads``,
``enc_verify``, ``pack_frame``) over the blocks the container's encode
calls were given (``encode.blocks``).  Nothing to read where the program
has no such counter."""

from portbench import spans

NAMES = ("enc_host_prep", "enc_payloads", "enc_verify", "pack_frame")


def read(run):
    tally = spans.profiled()
    if run.profile is None or tally is None or not tally.get("encode.blocks"):
        return None
    seconds = sum(tally.get(spans.PREFIX + n, 0.0) for n in NAMES)
    return 1e6 * seconds / tally["encode.blocks"]
