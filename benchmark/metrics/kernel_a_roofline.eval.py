"""Kernel A (`ops/fused_actor_critic`, the forwards without gradient, with
its weight preparation) in the operation profiled after the window: the sum
over the algorithm's forwards of the least time the card needs for each
(its operations at the TF32 peak or its bytes at the HBM peak, whichever is
longer; `benchmark/yardstick.py`) over kernel A's device time in the trace,
in percent.  Nothing when the trace shows no kernel A."""


def read(rec):
    prof, work = rec["profile"], rec["profiled_work"]
    if rec["kind"] != "eval" or work is None or not prof.get("kernel_a_s"):
        return None
    return 100.0 * work.least_seconds() / prof["kernel_a_s"]
