"""The plain Gumbel sequential-halving root search (Danihelka et al. 2022,
"Policy improvement by planning with Gumbel", with wide batched playouts in
place of a tree), as the port's `search/gumbel.py` and `search/mc.py`
define it for the configurations' searches: privileged (the root children
expand the true state), playouts guided by the actor, critic leaves.

1. `m` legal root actions are drawn without replacement by the Gumbel-top-k
   trick on the actor's masked logits, the prior's argmax forced into slot 0.
2. log2(m) halving rounds: every surviving action gets `k0 * 2^r` playouts
   of `horizon` plies (each ply a Gumbel-argmax sample of the actor, lanes
   frozen once terminal), scored at the leaf by the exact terminal reward
   or the critic's value clipped to +-0.95, from the searcher's side; the
   survivors are ranked by g + logits + c_scale * q (stable, the lower slot
   first on a tie) and the top half kept.
3. The move: the survivor with the largest g + logits + c_scale * q, or with
   `greedy_final` the largest q + 1e-3 * logits.

The random inputs are drawn from `generator` in the port's order: the
root's Gumbel noise [B, 45], then for each round and each ply the playout
noise [B * m * k0, 45].  So a generator restored to the state the program's
search started from gives the reference the same draws.  Forwards run the
reference's `forward` in the precision it is given; the engine is the
benchmark's frozen copy.
"""

from __future__ import annotations

import torch

from . import model
from .engine import core, rules
from .engine.encode import encode_observation
from .engine.state import GameState

A = rules.TOTAL_ACTIONS
NEG = -float("inf")


def repeat_rows(state: GameState, n: int) -> GameState:
    return state.map(lambda x: x.repeat_interleave(n, dim=0))


def leaf_values(states: GameState, me: torch.Tensor, fwd) -> torch.Tensor:
    """Each leaf from player `me`'s side: the exact reward where the game is
    over, else the critic's value (negated where the opponent is to move)
    clipped to +-0.95."""
    term = rules.is_terminal(states)
    term_v = core.final_rewards_of(states).gather(1, me.long()[:, None])[:, 0]
    obs = encode_observation(states)
    every = torch.ones((obs.shape[0], A), dtype=torch.bool, device=obs.device)
    _, v = fwd(obs, every, True)
    live = torch.clamp(torch.where(states.to_play == me, v, -v), -0.95, 0.95)
    return torch.where(term, term_v.to(live.dtype), live)


def rollout_values(states: GameState, me: torch.Tensor, fwd, generator, horizon: int):
    """`horizon` actor-sampled plies from each state, then `leaf_values`."""
    st = states
    for _ in range(horizon):
        term = rules.is_terminal(st)
        pmask = rules.legal_mask(st)
        logits, _ = fwd(encode_observation(st), pmask, False)
        noise = model.gumbel_noise(logits.shape, generator, logits.device)
        a = torch.argmax(model.masked_logits(logits, pmask) + noise.to(logits.dtype), dim=-1)
        nxt, _ = core.step_core(st, a, mask=pmask)
        st = core.select(term, st, nxt)
    return leaf_values(st, me, fwd)


def root_candidates(gscore, logits, mask, m: int) -> torch.Tensor:
    """int64 [B, m]: the top-m actions by g + logits, the prior's argmax in
    slot 0."""
    amax = torch.argmax(torch.where(mask, logits, NEG), dim=-1)
    is_amax = torch.arange(gscore.shape[1], device=gscore.device)[None] == amax[:, None]
    return torch.argsort(-torch.where(is_amax, float("inf"), gscore), dim=-1, stable=True)[:, :m]


@torch.no_grad()
def gumbel_search(fwd, obs, mask, state: GameState, generator, m: int, k0: int, horizon: int,
                  c_scale: float = 10.0, greedy_final: bool = False) -> torch.Tensor:
    """The move of each of B games (int64 [B]).  `fwd(obs, mask, with_value)
    -> (masked logits, value)` is the network in the reference's
    precision."""
    rounds = int(m).bit_length() - 1
    B, dev = mask.shape[0], mask.device
    me = state.to_play
    rows = torch.arange(B, device=dev)[:, None]
    logits, _ = fwd(obs, mask, False)
    dt = logits.dtype
    g = model.gumbel_noise((B, A), generator, dev).to(dt)
    gscore = torch.where(mask, g + logits, NEG)
    cand = root_candidates(gscore, logits, mask, m)
    alive = mask.gather(1, cand)
    cand_g = gscore.gather(1, cand)
    child = rules.apply_action(repeat_rows(state, m), cand.reshape(-1))
    q_sum = torch.zeros((B, m), dtype=dt, device=dev)
    n_cnt = torch.zeros((B, m), dtype=dt, device=dev)
    lanes = m * k0
    for r in range(rounds):
        n_alive = m >> r
        k_r = lanes // n_alive
        order = torch.argsort((~alive).to(torch.int8), dim=-1, stable=True)[:, :n_alive]
        lane_child = (rows * m + order).reshape(-1).repeat_interleave(k_r)
        flat = child.map(lambda x: x[lane_child])
        vals = rollout_values(flat, me.repeat_interleave(n_alive * k_r), fwd, generator,
                              horizon).reshape(B, n_alive, k_r)
        total = vals[..., 0].clone()
        for j in range(1, k_r):
            total = total + vals[..., j]
        q_sum = q_sum + torch.where(alive, torch.zeros_like(q_sum).scatter_add(1, order, total),
                                    0.0)
        n_cnt = n_cnt + torch.where(alive, torch.zeros_like(n_cnt).scatter_add(
            1, order, torch.full((B, n_alive), float(k_r), dtype=dt, device=dev)), 0.0)
        if r < rounds - 1:
            score = torch.where(alive, cand_g + c_scale * q_sum / torch.clamp(n_cnt, min=1.0),
                                NEG)
            top = torch.argsort(-score, dim=-1, stable=True)[:, :m >> (r + 1)]
            alive = alive & torch.zeros_like(alive).scatter(1, top, True)
    q_hat = q_sum / torch.clamp(n_cnt, min=1.0)
    if greedy_final:
        final = torch.where(alive, q_hat + 1e-3 * logits.gather(1, cand), NEG)
    else:
        final = torch.where(alive, cand_g + c_scale * q_hat, NEG)
    return cand.gather(1, torch.argmax(final, dim=-1)[:, None])[:, 0]
