"""The device: the share of an operation's time in which no kernel, copy or
fill ran, in percent.  The busy seconds are the profiled operation's, from
the profiler's trace; the operation's time is the median of the traced
run's window operations, which the spans' synchronisations slow by a few
percent and the profiler not at all (it roughly doubles the host's time of
the operation it traces, so that operation's own length would read the
idle share high)."""

import statistics


def read(rec):
    prof = rec["profile"]
    if rec["kind"] != "update" or not prof.get("busy_s") or not rec.get("op_seconds"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / statistics.median(rec["op_seconds"]))
