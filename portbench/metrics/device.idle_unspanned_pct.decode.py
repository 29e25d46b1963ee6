"""The share of the profiled decode calls' idle seconds (no kernel, copy
or fill on the card) that no stage span of the program names, in
percent."""

from portbench import spans


def read(run):
    return spans.idle_unspanned_pct(run, "decode")
