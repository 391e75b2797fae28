"""The benchmark of the PyTorch and CUDA port (`splendax_torch`) on NVIDIA
H100s: one cell of `BENCHMARK.json`, run once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads the cell's configuration and
traffic, warms up (set-up: imports, the kernels built into build/kernels/
or loaded from there, the committed nets, one warm-up operation), then runs
operations back to back for `--seconds` (the window ends at the first
operation boundary at or after it), checks the timed path's output against
the plain reference in `benchmark/reference/`, and prints one JSON line as
the last line of its standard output; everything else goes to standard
error, whose last lines are the compared numbers beside their limits.

`--trace 0` reports the cell's end-to-end metrics.  `--trace 1` runs the
window with a span, synchronised at both ends, around each layer's calls,
then one more operation under torch.profiler, and reports the per-layer
metrics (each read by `benchmark/metrics/<name>.py`), the device's busy and
window seconds, and the breakdown of device time and idle gaps.

The run exits with code 2, printing no result, without as many CUDA
devices as the cell asks for, and with code 3 if JAX or the JAX package
(`splendax`, compared by the top-level name) is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.harness import log  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
            small: dict | None = None, t_start: float | None = None) -> tuple:
    """Set up, run the window and check the cell -> (result dict, compared
    numbers).  `small` (CPU tests only) shrinks the traffic."""
    import torch

    run = harness.driver(cell["traffic"]["kind"]).Run(cell, seed, device, small)
    compile_s = run.build_kernels()
    log(f"bench: kernel build {compile_s:.3f} s (the first run in a checkout compiles)")
    run.warm()
    t_window = time.perf_counter()
    setup_s = t_window - (T_START if t_start is None else t_start) - run.capture_s
    log(f"bench: set-up {setup_s:.3f} s; the capture for the check {run.capture_s:.3f} s, "
        "not counted")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # Set-up's objects leave the collector's generations, so a collection in
    # the window scans only what the window makes.
    gc.collect()
    gc.freeze()
    spans = harness.Spans(run.sync) if trace else None
    with run.spans(spans) if trace else contextlib.nullcontext():
        win = harness.run_window(run.op, seconds)
        span_seconds = dict(spans.seconds) if trace else {}
        device_info = harness.device_info(cell["chips"]) if cuda else {"platform": "cpu"}
        profile = {}
        if trace and cuda:
            with harness.profiled(profile, spans), spans.span("op"):
                run.op()
            device_info.update(busy_s=profile.get("busy_s", 0.0),
                               window_s=profile.get("window_s", 0.0))
    run.finish()
    gc.unfreeze()
    log(f"bench: window {win['seconds']:.3f} s, {win['ops']} operations, op seconds "
        f"{[round(s, 4) for s in win['op_seconds']]}")
    found = harness.forbidden_modules()
    if found:
        raise Forbidden(found)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if not trace:
        for m in cell["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else win["rate"]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        record = {"kind": run.kind, "ops": win["ops"], "window_s": win["seconds"],
                  "op_seconds": win["op_seconds"], "spans": span_seconds, "profile": profile,
                  "flops": sum(run.work(i).flops for i in range(win["ops"])),
                  "profiled_work": run.work(win["ops"]) if profile else None}
        for m in cell["per_layer"]:
            value = harness.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    attempted, failed = win["ops"], run.failed_ops()
    log("bench:", {"compile_s": compile_s, "setup_s": setup_s, **run.info()})
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = run.check()["program"]
    log(f"bench: reference check {time.perf_counter() - t0:.1f} s")
    result = {"attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and profile:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    return result, numbers


class Forbidden(RuntimeError):
    pass


def verdict(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, {number: {value, limit}}): every compared number at or
    under its limit (a NaN never is) and no operation failed."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    return correct, checks


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not harness.cuda_ready(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); this machine has {n}")
        return 2
    log(f"bench: {args.workload} seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"{harness.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        result, numbers = measure(cell, args.seed, args.seconds, bool(args.trace))
    except Forbidden as e:
        log(f"bench: JAX or the JAX package is loaded: {', '.join(e.args[0])}")
        return 3
    found = harness.forbidden_modules()
    if found:
        log(f"bench: JAX or the JAX package is loaded: {', '.join(found)}")
        return 3
    correct, checks = verdict(numbers, cell["limits"], result["failed"])
    print(harness.result_line(correct, result["attempted"], result["failed"], result["metrics"],
                              result["device"], checks, result.get("breakdown")), flush=True)
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
