"""The whole step: the model's operations over the traced window (every
operation's forwards and learner steps, from the algorithm's shapes,
`benchmark/yardstick.py`) over the window's seconds and the TF32 peak of
494.7 TFLOP/s, in percent."""

from benchmark.yardstick import PEAK_FLOPS


def read(rec):
    if rec["kind"] != "eval" or not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_FLOPS
