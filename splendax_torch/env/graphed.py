"""CUDA graphs over the engine's fast-mode plies.

A fast-mode ply -- the transition (`core.step_core`, `rules.apply_action`),
the observation encode and the next legal mask -- is one or two launches of
the ply's kernels (`ops/engine_ply`) and the few selects and copies around
them, each issued by the host.  `call(site, fn, *args)` runs `fn(*args)` on
CUDA tensors as the replay of one `torch.cuda.CUDAGraph`:

  * a graph is captured lazily per key: the site, the arguments' structure,
    each tensor's shape, dtype and device, and the keyword arguments.  A
    key's first call runs `fn` eagerly (the warm-up PyTorch asks for before
    a capture); its second captures `fn` with `torch.cuda.graph`, on that
    context's side stream, into one memory pool that every graph of the
    process shares, and replays it; every later call replays;
  * a call copies its tensors into the graph's static inputs
    (`torch._foreach_copy_`, one launch a dtype), replays, and copies the
    static outputs into fresh tensors the same way.  What a caller gets back
    is its own: no later replay writes it;
  * `fn` runs eagerly, exactly as without this module, on CPU tensors, in
    parity mode (`rng_mode` other than "fast": its token return reads the
    device from the host), while a stream is being captured, for an empty
    batch, and for a new key once its site holds `MAX_GRAPHS` graphs (a
    league slot drawn per episode searches a new number of games each turn).

`fn(*args, rng_mode=..., **static)` must be a function of its tensor
arguments alone: no blocking read (`trace.sync` inside a capture raises), no
random draw, no tensor kept for later.  Kernel A stays outside every graph:
its callers read and count each of its launches.  The ply's kernels
(`engine_ply.launches.*`) launch on the current stream, so a capture records
them; the capture runs nothing, so their launch counters are given back, and
each replay adds the launches its graph holds.  A span inside `fn` closes at
the capture, not at a replay.

Counters (`splendax_torch.trace`): `graph.capture.<site>` and
`graph.replay.<site>`; a capture blocks on the device (`torch.cuda.graph`
synchronises first) and is the `trace.sync` site `graph.capture`.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import trace

MAX_GRAPHS = 4  # graphs a site keeps; a further key runs eagerly
LAUNCHES = "engine_ply.launches."  # the ply kernels' counters

_graphs: dict = {}  # key -> _Graph
_seen: set = set()  # keys called once, eagerly
_per_site: dict = {}  # site -> graphs it holds
_pool = None  # the memory pool every graph shares


def _flatten(x, leaves: list):
    """Append x's tensors to `leaves`; return x's structure, hashable."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if x is None:
        return "N"
    if isinstance(x, tuple):
        return ("L", tuple(_flatten(v, leaves) for v in x))
    if dataclasses.is_dataclass(x):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("C", type(x), names, tuple(_flatten(getattr(x, n), leaves) for n in names))
    raise TypeError(f"graphed: cannot pass a {type(x).__name__} through a graph")


def _unflatten(spec, leaves):
    """The structure `spec` rebuilt from an iterator of tensors."""
    if spec == "T":
        return next(leaves)
    if spec == "N":
        return None
    if spec[0] == "L":
        return tuple(_unflatten(s, leaves) for s in spec[1])
    return spec[1](**{n: _unflatten(s, leaves) for n, s in zip(spec[2], spec[3])})


def _by_dtype(tensors: list) -> list:
    """[(dtype, indices)] of `tensors`, for one foreach copy a dtype."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.items())


class _Graph:
    """One captured graph: its static inputs and outputs."""

    def __init__(self, site: str, fn, leaves: list, spec, rng_mode: str, static: dict):
        global _pool
        self.site = site
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
        self.in_groups = [([self.inputs[i] for i in idx], idx) for _, idx in _by_dtype(leaves)]
        args = _unflatten(spec, iter(self.inputs))
        if _pool is None:
            _pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        before = trace.counters(LAUNCHES)

        def capture():
            with torch.no_grad(), torch.cuda.graph(self.graph, pool=_pool):
                out = fn(*args, rng_mode=rng_mode, **static)
                flat: list = []
                out_spec = _flatten(out, flat)
                # Dense outputs, so each copy out takes the foreach fast path.
                return out_spec, [t.contiguous() for t in flat]

        self.out_spec, self.outputs = trace.sync("graph.capture", capture)
        self.launches = {k: n - before.get(k, 0) for k, n in trace.counters(LAUNCHES).items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            trace.count(k, -n)  # the capture ran nothing
        self.out_groups = [([self.outputs[i] for i in idx], idx)
                           for _, idx in _by_dtype(self.outputs)]
        self.replays = 0
        trace.count("graph.capture." + site)

    def __call__(self, leaves: list):
        for static, idx in self.in_groups:
            torch._foreach_copy_(static, [leaves[i] for i in idx])
        self.graph.replay()
        fresh = [torch.empty_like(t) for t in self.outputs]
        for static, idx in self.out_groups:
            torch._foreach_copy_([fresh[i] for i in idx], static)
        self.replays += 1
        trace.count("graph.replay." + self.site)
        for k, n in self.launches.items():
            trace.count(k, n)
        return _unflatten(self.out_spec, iter(fresh))


def _graphable(leaves: list, rng_mode: str) -> bool:
    if rng_mode != "fast" or not leaves:
        return False
    dev = leaves[0].device
    return (dev.type == "cuda" and all(t.device == dev and t.numel() > 0 for t in leaves)
            and not torch.cuda.is_current_stream_capturing())


def call(site: str, fn, *args, rng_mode: str = "fast", **static):
    """`fn(*args, rng_mode=rng_mode, **static)`, as a graph replay where the
    module docstring says so.  `args` are tensors, None, and tuples and
    dataclasses (a `GameState`) of them, and so are `fn`'s outputs;
    `static` are hashable values, part of the key.  `fn` must be one
    module-level function per site (it is part of the key)."""
    leaves: list = []
    spec = _flatten(args, leaves)
    if not _graphable(leaves, rng_mode):
        return fn(*args, rng_mode=rng_mode, **static)
    key = (site, fn, spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves),
           tuple(sorted(static.items())))
    graph = _graphs.get(key)
    if graph is None:
        if key not in _seen or _per_site.get(site, 0) >= MAX_GRAPHS:
            _seen.add(key)
            return fn(*args, rng_mode=rng_mode, **static)
        graph = _graphs[key] = _Graph(site, fn, leaves, spec, rng_mode, static)
        _per_site[site] = _per_site.get(site, 0) + 1
    return graph(leaves)


def captured() -> list:
    """One dict per graph held: site, input shapes, the ply's kernel
    launches a replay adds (`launches`, by counter), replays so far."""
    return [{"site": g.site, "shapes": [tuple(t.shape) for t in g.inputs],
             "launches": dict(g.launches), "replays": g.replays}
            for g in _graphs.values()]


def reset() -> None:
    """Drop every graph and every key seen (their pool memory returns to the
    allocator once nothing holds it)."""
    global _pool
    _graphs.clear()
    _seen.clear()
    _per_site.clear()
    _pool = None
