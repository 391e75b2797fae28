"""Kernel A's route and mode checks: a frozen copy of those of
`splendax_torch/bench.py` (`derived_modes`, `read_launches`, `check_route`),
reporting what they find instead of raising.

While `derived_modes` is open, each forward of the `wgmma` or `wide` route
whose mode the wrapper picks adds the mode its B derives, and each forward
not given a prepared buffer adds the preparation its weights call for.  The
run prints what `route_problems` finds on its standard error; the
comparison with the reference alone decides `correct`.
"""

from __future__ import annotations

import contextlib

from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt


def needs_preparation(weights) -> bool:
    return not isinstance(weights, fac.PreparedWeights) or weights.stale()


@contextlib.contextmanager
def derived_modes(derived: dict):
    """Count into `derived` ("tile", "cluster", "wide_pass", "wide_half",
    "prep") what each forward's shape and weights derive."""
    launch = fac._launch

    def counted(r, weights, obs, mask, with_value, prepared=None, lib=None, mode=None):
        if r == "wgmma" and mode is None:
            key = fac.wgmma_mode(obs.shape[0], weights[0].shape[1])
            derived[key] = derived.get(key, 0) + 1
        elif r == "wide" and mode is None:
            key = "wide_" + fac.wide_mode(obs.shape[0], weights[0].shape[1], with_value)
            derived[key] = derived.get(key, 0) + 1
        if r != "mma_sync" and prepared is None and obs.shape[0] > 0:
            derived["prep"] = derived.get("prep", 0) + needs_preparation(weights)
        return launch(r, weights, obs, mask, with_value, prepared, lib, mode)

    fac._launch = counted
    try:
        yield
    finally:
        fac._launch = launch


def counters() -> dict:
    """Kernel A's counters (forwards, by route, by mode, preparations) and
    kernel B's launches."""
    return {**fac.launch_counts(), "ring_take": rt.launches}


def route_problems(n: dict, derived: dict, hidden: int) -> list:
    """What the launches `n` (counter deltas) show against the route the
    hidden width derives and the modes and preparations `derived`."""
    route = fac.route(hidden)
    out = []
    total = n.get("fused_actor_critic", 0)
    if total == 0 or n.get("fused_actor_critic_" + route, 0) != total:
        out.append(f"kernel A's {total} forwards did not all take the {route} route: {n}")
    if n.get("fused_actor_critic_prep", 0) != derived.get("prep", 0):
        out.append(f"kernel A prepared {n.get('fused_actor_critic_prep', 0)} times, its "
                   f"forwards' weights called for {derived.get('prep', 0)}")
    for r, names in (("wgmma", ("tile", "cluster")), ("wide", ("wide_pass", "wide_half"))):
        modes = {m: n.get("fused_actor_critic_" + m, 0) for m in names}
        if sum(modes.values()) != n.get("fused_actor_critic_" + r, 0) or any(
                modes[m] != derived.get(m, 0) for m in names):
            out.append(f"kernel A's {r} modes {modes} are not those its B derive {derived}")
    return out
