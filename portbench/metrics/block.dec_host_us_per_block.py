"""Host work of a decode a block, from the program's spans and counter,
us a block of the profiled calls: the seconds of the spans
``span.dec_host_ms`` sums (``parse_frame``, ``dec_host_prep``,
``dec_errors``) over the blocks the container's decode calls were given
(``decode.blocks``).  Nothing to read where the program has no such
counter."""

from portbench import spans

NAMES = ("parse_frame", "dec_host_prep", "dec_errors")


def read(run):
    tally = spans.profiled()
    if run.profile is None or tally is None or not tally.get("decode.blocks"):
        return None
    seconds = sum(tally.get(spans.PREFIX + n, 0.0) for n in NAMES)
    return 1e6 * seconds / tally["decode.blocks"]
