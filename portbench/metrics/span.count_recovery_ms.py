"""Host count recovery of a variable-width decode, from the program's span
``dec_count_recovery``, ms a profiled call: the work
``schedule.count_recovery_ms`` times between two synchronisations, here
on the profiler's clock; nothing to read where a flavor has none (fixed
12-bit)."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "decode", ("dec_count_recovery",))
