"""Opponent policies, in two idioms: on whole batches, and on the host.

Counterpart of `splendax/selfplay/opponents.py`.  The batch policies:
`random`, `greedy_v1`, `basic` and `greedy_v2`, each a function
`fn(obs int32 [B, 297], mask bool [B, 45], state GameState [B],
generator=None) -> action int64 [B]`.  `greedy_v1` and `greedy_v2` are
deterministic; `random` and `basic` break ties with uniform draws from
`generator`.  `device_policy(name, generator)` closes one over a generator as
the `policy(obs, mask, state)` that `dual.dual_step` takes.

The host policies are numpy callables `(obs, info) -> action` for the gym
wrappers, with the reference heuristics' control flow and the numpy global
RNG for their random tie-breaks: `random_opponent`, `greedy_opponent_v1`,
`basic_priority_opponent` and `greedy_opponent_v2_factory(env_ref)`.

The action space: take-3 0..9, take-2 10..14, buy a visible card 15..26,
reserve 27..41, buy a reserved card 42..44.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..engine import data as D
from ..engine import rules

_A = torch.arange(rules.TOTAL_ACTIONS)
# The action families, bool [45] each.
GROUPS = {
    "take3": _A <= 9,
    "take2": (_A >= 10) & (_A <= 14),
    "buy_vis": (_A >= 15) & (_A <= 26),
    "reserve": (_A >= 27) & (_A <= 41),
    "buy_res": _A >= 42,
    "buys": ((_A >= 15) & (_A <= 26)) | (_A >= 42),
}


def first_legal(mask: torch.Tensor) -> torch.Tensor:
    """The lowest True index of each row of a bool mask (0 where there is
    none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


@functools.lru_cache(maxsize=None)
def _groups_on(device: torch.device) -> dict:
    return {name: g.to(device) for name, g in GROUPS.items()}


def in_group(mask: torch.Tensor, name: str) -> torch.Tensor:
    """The legal actions of one action family: `mask & GROUPS[name]`."""
    return mask & _groups_on(mask.device)[name]


def choose(*cases, default: torch.Tensor) -> torch.Tensor:
    """The action of the first case whose condition holds, row by row:
    `cases` are (bool [B], action [B]) pairs in order of priority."""
    out = default
    for cond, action in reversed(cases):
        out = torch.where(cond, action, out)
    return out


def uniform_legal_action(mask: torch.Tensor, generator=None, u=None) -> torch.Tensor:
    """A uniformly random legal action per row of bool mask [B, 45]: the
    floor(u * n_legal)-th legal action, for u uniform in [0, 1) (drawn from
    `generator` unless given as f32 [B]).  Rows with no legal action give 0."""
    m = mask.to(torch.float32)
    n = m.sum(-1, keepdim=True)
    if u is None:
        u = torch.rand(mask.shape[:-1], generator=generator, device=mask.device)
    # The clamp guards the u just below 1 for which u*n rounds up to n.
    k = torch.minimum(torch.floor(u[..., None] * n), n - 1)
    before = torch.cumsum(m, -1) - m  # legal actions before each action
    hit = mask & (before == k)
    return torch.argmax(hit.to(torch.int32), dim=-1)


def random_policy(obs, mask, state, generator=None, u=None):
    """Uniform over all legal actions; `u` (f32 [B]) may give the draws."""
    return uniform_legal_action(mask, generator, u=u)


random_policy.draw_shape = lambda B: (B,)  # the uniforms a call draws


def greedy_v1_policy(obs, mask, state, generator=None):
    """buy > take-2 > take-3 > reserve, the first legal action of each
    group.  Deterministic."""
    groups = [in_group(mask, g) for g in ("buys", "take2", "take3", "reserve")]
    return choose(*((m.any(-1), first_legal(m)) for m in groups), default=first_legal(mask))


def basic_priority_policy(obs, mask, state, generator=None, u=None):
    """The visible buy with the most points > a reserved buy > take-3 >
    take-2 > reserve > first legal, each tie broken at random (`u`, f32
    [2, B], may give the draws).  Card points are read from the observation
    (`obs[32 + 13 * slot + 2]`)."""
    B = mask.shape[0]
    u1, u2 = torch.rand((2, B), generator=generator, device=mask.device) if u is None else u
    buy_vis = in_group(mask, "buy_vis")
    pts45 = torch.zeros((B, rules.TOTAL_ACTIONS), dtype=obs.dtype, device=obs.device)
    pts45[:, 15:27] = obs[:, 34 : 34 + 12 * 13 : 13]
    best_pts = torch.where(buy_vis, pts45, -1).amax(-1, keepdim=True)
    best_vis = buy_vis & (pts45 == best_pts)
    cases = [(buy_vis.any(-1), uniform_legal_action(best_vis, u=u1))]
    for group, u in (("buy_res", u1), ("take3", u2), ("take2", u2), ("reserve", u2)):
        m = in_group(mask, group)
        cases.append((m.any(-1), uniform_legal_action(m, u=u)))
    return choose(*cases, default=first_legal(mask))


basic_priority_policy.draw_shape = lambda B: (2, B)


def greedy_v2_policy(obs, mask, state, generator=None):
    """Scarcity-aware greedy: buys first; else the take-2 of the scarcest
    bank colour; else the take-3 with the least bank tokens over its three
    colours; else the reserve with the highest action index.  Reads the bank
    from the game state (public information), hence `privileged`."""
    t = rules.tables(mask.device)
    bank5 = state.bank[:, :5].long()
    buys = in_group(mask, "buys")
    # Scores are unique within a row, so ties go to the lowest action index.
    t2 = in_group(mask, "take2")
    t2_score = bank5 * 64 + t.ar5
    a_t2 = 10 + torch.argmin(torch.where(t2[:, 10:15], t2_score, 10_000), dim=-1)
    t3 = in_group(mask, "take3")
    combo_sum = (t.combo[None] * bank5[:, None, :]).sum(-1)  # [B, 10]
    t3_score = combo_sum * 64 + torch.arange(10, device=mask.device)
    a_t3 = torch.argmin(torch.where(t3[:, :10], t3_score, 10_000), dim=-1)
    rsv = in_group(mask, "reserve")
    a_rsv = 44 - first_legal(rsv.flip(-1))
    return choose((buys.any(-1), first_legal(buys)), (t2.any(-1), a_t2), (t3.any(-1), a_t3),
                  (rsv.any(-1), a_rsv), default=first_legal(mask))


greedy_v2_policy.privileged = True  # reads GameState, not only the observation

DEVICE_POLICIES = {
    "random": random_policy,
    "greedy_v1": greedy_v1_policy,
    "basic": basic_priority_policy,
    "greedy_v2": greedy_v2_policy,
}


def device_policy(name: str, generator=None, mesh=None):
    """`DEVICE_POLICIES[name]` as `policy(obs, mask, state) -> action [B]`,
    drawing its random tie-breaks from `generator`.  With a `mesh` the rows
    are this rank's: a policy that draws (`draw_shape`) draws for the global
    batch and keeps this rank's columns."""
    if name not in DEVICE_POLICIES:  # registered when its module is imported
        from ..eval import noble  # noqa: F401
    fn = DEVICE_POLICIES[name]
    shape = getattr(fn, "draw_shape", None)
    if shape is None:
        return lambda obs, mask, state: fn(obs, mask, state, generator)

    def policy(obs, mask, state):
        n = mask.shape[0] * (1 if mesh is None else mesh.dp)
        lo, hi = (0, n) if mesh is None else mesh.row_range(n)
        u = torch.rand(shape(n), generator=generator, device=mask.device)[..., lo:hi]
        return fn(obs, mask, state, generator, u=u)

    return policy


# ---------------------------------------------------------------------------
# Host (numpy) versions with the reference's exact control flow.
# ---------------------------------------------------------------------------


def random_opponent(obs, info):
    legal = np.flatnonzero(info["action_mask"])
    return int(np.random.choice(legal)) if len(legal) else 0


def greedy_opponent_v1(obs, info):
    legal = np.flatnonzero(info["action_mask"])
    if len(legal) == 0:
        return 0
    for group in (
        [a for a in legal if (15 <= a <= 26) or (42 <= a <= 44)],
        [a for a in legal if 10 <= a <= 14],
        [a for a in legal if 0 <= a <= 9],
        [a for a in legal if 27 <= a <= 41],
    ):
        if group:
            return int(group[0])
    return int(legal[0])


def basic_priority_opponent(obs, info):
    legal = np.flatnonzero(info["action_mask"])
    if len(legal) == 0:
        return 0
    buy_vis = [a for a in legal if 15 <= a <= 26]
    buy_res = [a for a in legal if 42 <= a <= 44]
    if buy_vis:
        pts = {a: int(obs[32 + (a - 15) * 13 + 2]) for a in buy_vis}
        best = max(pts.values())
        return int(np.random.choice([a for a in buy_vis if pts[a] == best]))
    if buy_res:
        return int(np.random.choice(buy_res))
    for group in (
        [a for a in legal if 0 <= a <= 9],
        [a for a in legal if 10 <= a <= 14],
        [a for a in legal if 27 <= a <= 41],
    ):
        if group:
            return int(np.random.choice(group))
    return int(legal[0])


def greedy_opponent_v2_factory(env_ref=None):
    """Scarcity-aware greedy; reads the bank from the wrapped env's state
    (a `GameState` with B=1)."""

    def policy(obs, info):
        legal = np.flatnonzero(info["action_mask"])
        if len(legal) == 0:
            return 0
        buys = [a for a in legal if (15 <= a <= 26)] + [a for a in legal if 42 <= a <= 44]
        if buys:
            return int(buys[0])
        if env_ref is not None and getattr(env_ref, "state", None) is not None:
            bank_vec = env_ref.state.bank[0, :5].tolist()
        else:
            bank_vec = [1, 1, 1, 1, 1]
        take2 = [a for a in legal if 10 <= a <= 14]
        if take2:
            return int(min(take2, key=lambda a: bank_vec[a - 10]))
        take3 = [a for a in legal if 0 <= a <= 9]
        if take3:
            return int(min(take3, key=lambda a: sum(bank_vec[i] for i in D.TAKE3_COMBOS[a])))
        res = [a for a in legal if 27 <= a <= 41]
        if res:
            return int(sorted(res, reverse=True)[0])
        return int(legal[0])

    return policy


HOST_POLICIES = {
    "random": random_opponent,
    "greedy_v1": greedy_opponent_v1,
    "basic": basic_priority_opponent,
}
