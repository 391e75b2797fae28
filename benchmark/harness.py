"""What every cell shares: the manifest and the files found by name, the
checks before and after a run, the measured window, the spans and the
profiler's summary, and the result line.

A cell `<config>.<traffic>` of `BENCHMARK.json` is found as
  benchmark/configs/<config>.json   the configuration as it is run
  benchmark/traffic/<traffic>.json  the traffic mix; its "kind" names the
                                    driver module benchmark/drivers/<kind>.py
  benchmark/limits/<cell>.json      each compared number's limit
  benchmark/metrics/<metric>.py     a per-layer metric's reader
so a later change adds a configuration, a mix or a metric by adding files.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "splendax")
# Kernel A's kernels (its two routes' forwards, the wide route's head sums
# and the weight preparation), by the names the program gives them.
KERNEL_A = ("fused_ac_wgmma_kernel", "fused_ac_wide_kernel", "wide_heads_kernel",
            "prepare_kernel")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload entry `name` with its configuration, traffic, limits and
    the end-to-end and per-layer metrics it reports."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")

    def reports(metric) -> bool:
        return name in metric.get("workloads", [name])

    return {
        "name": name,
        "chips": w["chips"],
        "config": read_json(os.path.join(root, conf_entry["file"])),
        "traffic": read_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        "limits": read_json(os.path.join(bench, "limits", name + ".json")),
        "end_to_end": [m for m in man["end_to_end"] if reports(m)],
        "per_layer": [m for m in man["per_layer"] if reports(m)],
        "run_seconds": man["run_seconds"],
    }


def driver(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, root: str = ROOT):
    """The `read(record) -> float | None` of a per-layer metric's file."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def window_rate(t0: float, ends: list, units: list) -> tuple:
    """(rate, seconds) of a window that started at `t0`, whose operations
    ended at `ends` and each did `units`: all the work over all the time,
    up to the end of the last operation."""
    seconds = ends[-1] - t0
    return sum(units) / seconds, seconds


def run_window(op, seconds: float, clock=time.perf_counter) -> dict:
    """Run `op() -> units` back to back until the first operation that ends
    at or after `seconds` from the start."""
    t0 = clock()
    ends, units = [], []
    while True:
        units.append(op())
        ends.append(clock())
        if ends[-1] - t0 >= seconds:
            break
    rate, length = window_rate(t0, ends, units)
    return {"rate": rate, "seconds": length, "ops": len(ends), "units": units,
            "op_seconds": [b - a for a, b in zip([t0] + ends[:-1], ends)]}


# ---------------------------------------------------------------- spans

class Spans:
    """Host seconds of named spans.  A span synchronises the device at both
    ends and is a profiler range of the same name, so a traced run reads
    each layer's time and the profiler sees where it lies."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = {}
        self.counts = {}

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        self.sync()
        t0 = time.perf_counter()
        with record_function(name):
            yield
            self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def wrap(self, fn, name: str):
        def wrapper(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return wrapper


def to_host(x):
    """Tensors, also inside dicts and lists, copied to the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_host(v) for v in x]
    return x


@contextlib.contextmanager
def patched(obj, name: str, make):
    """`obj.name` replaced by `make(original)` while open."""
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


# ---------------------------------------------------------------- the profiler

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize_trace(events, window: str = "op") -> dict | None:
    """The device's work inside the host range `window` from profiler
    events, each (name, kind, start_ns, end_ns) with kind "device" for a
    kernel, "copy" for a device copy or fill, "range" for a host range of
    a span, "host" for a host operation.  Returns kernels (launches), busy
    and window seconds, kernel A's seconds and launches, the device
    operations by time, and the idle gaps by what the host was doing (the
    innermost span and the outermost host operation at the gap's middle);
    None if the window is missing or the device ran nothing in it."""
    win = [(s, e) for n, k, s, e in events if k == "range" and n == window]
    if not win:
        return None
    w0, w1 = win[0]
    device = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in events
              if k in ("device", "copy") and e > w0 and s < w1]
    if not device:
        return None
    busy = _merge([(s, e) for _, _, s, e in device])
    by_op = {}
    for n, _, s, e in device:
        by_op[n] = by_op.get(n, 0) + (e - s)
    kernel_a = [(s, e) for n, k, s, e in device if k == "device" and any(a in n for a in KERNEL_A)]
    # The spans nest, so a sweep over their starts and ends keeps the open
    # ones on a stack, the innermost on top.
    marks = sorted([(s, 1, n) for n, k, s, e in events if k == "range" and n != window]
                   + [(e, 0, n) for n, k, s, e in events if k == "range" and n != window])
    tops, end = [], -1
    for s, e, n in sorted((s, e, n) for n, k, s, e in events if k == "host"):
        if s >= end:
            tops.append((s, e, n))
            end = e
    starts = [t[0] for t in tops]
    gaps, stack, j = {}, [], 0
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(marks) and marks[j][0] <= mid:
            t, opening, n = marks[j]
            if opening:
                stack.append(n)
            elif n in stack:
                del stack[len(stack) - 1 - stack[::-1].index(n)]
            j += 1
        label = stack[-1] if stack else "outside spans"
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and tops[i][1] > mid:
            label += ": " + tops[i][2]
        gaps[label] = gaps.get(label, 0) + (b - a)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": sum(1 for _, k, _, _ in device if k == "device"),
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernel_a_s": sum(e - s for s, e in kernel_a) / 1e9,
        "kernel_a_launches": len(kernel_a),
        "device_ops": [[n, t / 1e9] for n, t in top],
        "idle_gaps": [[n, t / 1e9] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def kineto_events(prof, ranges) -> list:
    """A torch.profiler session's events as `summarize_trace` takes them:
    on the device a kernel, or a copy or fill; on the host the `ranges`
    (the spans' names; their device-side shadows are dropped) and every
    other operation."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name in ranges:
                continue
            kind = "copy" if name.startswith(("Memcpy", "Memset")) else "device"
        else:
            kind = "range" if name in ranges else "host"
        out.append((name, kind, e.start_ns(), e.end_ns()))
    return out


@contextlib.contextmanager
def profiled(result: dict, spans: "Spans"):
    """A torch.profiler session over the block, summarised into `result`
    (the span "op" must be opened inside)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    t0 = time.perf_counter()
    summary = summarize_trace(kineto_events(prof, set(spans.counts) | {"op"}))
    log(f"bench: profiler summary read in {time.perf_counter() - t0:.1f} s")
    if summary is not None:
        result.update(summary)


# ---------------------------------------------------------------- the run

def build_kernels(device) -> float:
    """Build the program's kernels that build/kernels/ lacks (the first run
    in a checkout) -> the seconds it took."""
    import torch

    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from splendax_torch.ops import _build

        _build.build()
    return time.perf_counter() - t0


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ready(chips: int) -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.device_count() >= chips


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The result's JSON line: the contract's keys, the compared numbers
    with their limits last."""
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)
