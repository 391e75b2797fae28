"""Device kernel launches in one update, counted from the profiler's trace of
the update profiled after the window (every kernel: the rollout's and the
learner's)."""


def read(rec):
    prof = rec["profile"]
    if rec["kind"] != "update" or not prof.get("kernels"):
        return None
    return float(prof["kernels"])
