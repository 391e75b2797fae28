"""PUCT Monte-Carlo tree search on whole batches (fixed-size tree arrays).

Counterpart of `splendax/search/uct.py`.  Every game of the batch grows its
own tree of `sims + 1` nodes held in fixed arrays [B, sims + 1, ...]: PUCT
selection, one expansion per simulation, actor priors and critic leaf values
(exact terminal rewards when a leaf ends the game), and the backup of a
per-seat value pair.  `to_play` alternates every ply, so the tree is strictly
alternating; backing up the pair, swapped at each level, rather than a sign
flip keeps the turn-limit draw, which is -0.1 for both seats, right at every
depth.

The JAX package grows one tree per game under `vmap`; here each of the
`sims` simulations walks all B trees together: `max_depth` selection steps,
one engine ply and one leaf evaluation on B states, `max_depth` backup
steps.  The steps are small, so a move is bound by the host's launch rate.
Expansion steps the engine in fast mode, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine import rules as R
from ..engine.encode import encode_observation
from ..engine.state import GameState
from ..env import core
from ..ops.fused_actor_critic import fused_masked_forward
from .mc import _NEG, as_ctx, div_const

A = R.TOTAL_ACTIONS


def _leaf_eval(state: GameState, ctx):
    """(prior f32 [B, 45], value2 f32 [B, 2], terminal bool [B], mask bool
    [B, 45]).  value2 = [value for the player to move, value for the other
    seat]: a live leaf takes the critic's estimate (the prestige lead over
    15 without a network), clipped to +-0.95, and its negation; a terminal
    leaf takes each seat's exact reward."""
    mask = R.legal_mask(state)
    term = R.is_terminal(state) | ~mask.any(-1)
    B = mask.shape[0]
    ar = torch.arange(B, device=mask.device)
    me = state.to_play.long()
    if ctx is None:
        logits = torch.zeros((B, A), device=mask.device)
        lead = (state.prestige[ar, me] - state.prestige[ar, 1 - me]).to(torch.float32)
        v_live = torch.clamp(div_const(lead, 15.0), -0.95, 0.95)
    else:
        logits, v = fused_masked_forward(ctx, encode_observation(state), mask, with_value=True)
        v_live = torch.clamp(v, -0.95, 0.95)
    # The softmax over the legal actions (all zero where there is none).
    ml = torch.where(mask, logits, _NEG)
    e = torch.exp(ml - ml.amax(-1, keepdim=True))
    prior = torch.where(mask, e / e.sum(-1, keepdim=True), 0.0)
    fr = core.final_rewards_of(state)  # [B, 2] by seat
    v_term = torch.stack([fr[ar, me], fr[ar, 1 - me]], dim=1)
    v_est = torch.stack([v_live, -v_live], dim=1)
    return prior, torch.where(term[:, None], v_term, v_est), term, mask


def _puct_scores(prior, n_sa, w_sa, mask, c_puct, fpu):
    """PUCT scores at one node of each game, [B, 45]; illegal actions -inf.
    First-play urgency: an unvisited edge takes the node's own value
    estimate `fpu` [B] as its Q instead of 0."""
    n_total = n_sa.sum(-1, keepdim=True)
    q = torch.where(n_sa > 0, w_sa / torch.clamp(n_sa, min=1.0), fpu[:, None])
    u = c_puct * prior * torch.sqrt(n_total + 1.0) / (1.0 + n_sa)
    return torch.where(mask, q + u, _NEG)


def uct_search(state: GameState, ctx, sims: int, max_depth: int, c_puct: float):
    """Grow a `sims`-node tree for each game -> (root visit counts f32
    [B, 45], root Q f32 [B, 45], -inf where unvisited)."""
    B = state.batch_size
    dev = state.to_play.device
    N = sims + 1
    ar = torch.arange(B, device=dev)
    # Node 0 of every tree holds the root; the other slots are stale copies.
    states = state.map(lambda x: x[:, None].expand((B, N) + tuple(x.shape[1:])).clone())
    prior0, value0, term0, mask0 = _leaf_eval(state, ctx)

    children = torch.full((B, N, A), -1, dtype=torch.int64, device=dev)
    prior = torch.zeros((B, N, A), device=dev)
    n_sa = torch.zeros((B, N, A), device=dev)
    w_sa = torch.zeros((B, N, A), device=dev)
    term = torch.zeros((B, N), dtype=torch.bool, device=dev)
    value = torch.zeros((B, N, 2), device=dev)  # [to-move seat, other seat]
    mask = torch.zeros((B, N, A), dtype=torch.bool, device=dev)
    prior[:, 0], term[:, 0], value[:, 0], mask[:, 0] = prior0, term0, value0, mask0

    for sim in range(sims):
        new_id = sim + 1  # one expansion per simulation

        # Select: follow PUCT to an unexpanded edge or a terminal node.
        node = torch.zeros(B, dtype=torch.int64, device=dev)
        stop = torch.zeros(B, dtype=torch.bool, device=dev)
        path_n = torch.full((B, max_depth), -1, dtype=torch.int64, device=dev)
        path_a = torch.full((B, max_depth), -1, dtype=torch.int64, device=dev)
        for d in range(max_depth):
            scores = _puct_scores(prior[ar, node], n_sa[ar, node], w_sa[ar, node],
                                  mask[ar, node], c_puct, value[ar, node, 0])
            a = torch.argmax(scores, dim=-1)
            child = children[ar, node, a]
            take = ~stop & ~term[ar, node]
            path_n[:, d] = torch.where(take, node, -1)
            path_a[:, d] = torch.where(take, a, -1)
            # Stop after recording an unexpanded edge, or at a terminal node.
            stop = stop | term[ar, node] | (take & (child < 0))
            node = torch.where(take & (child >= 0), child, node)
        depth = (path_n >= 0).sum(1)  # edges recorded
        expanding = depth > 0  # False only where the root itself is terminal
        last_d = torch.clamp(depth - 1, min=0)
        exp_node = path_n[ar, last_d].clamp(min=0)
        exp_action = path_a[ar, last_d].clamp(min=0)

        # Expand the chosen edge.  It may already have a child (the path
        # stopped at a terminal node it leads to, or at the depth cap): then
        # that node's stored value is reused and nothing is written.
        parent_state = states.map(lambda x: x[ar, exp_node])
        child_state = R.apply_action(parent_state, exp_action, rng_mode="fast")
        c_prior, c_value, c_term, c_mask = _leaf_eval(child_state, ctx)
        edge_child = children[ar, exp_node, exp_action]
        fresh = expanding & (edge_child < 0)

        new = [(arr, getattr(child_state, name)) for name, arr in states.items()]
        for arr, val in new + [(prior, c_prior), (term, c_term), (value, c_value), (mask, c_mask)]:
            arr[:, new_id] = torch.where(fresh.view((-1,) + (1,) * (val.dim() - 1)), val,
                                         arr[:, new_id])
        children[ar, exp_node, exp_action] = torch.where(fresh, new_id, edge_child)

        # Back up the leaf's pair: walking upward the edge's actor alternates
        # between the two seats, so credit the pair's "other" component and
        # swap at each level.  A reused child gives its stored pair.
        reuse_value = value[ar, edge_child.clamp(min=0)]
        pair = torch.where(fresh[:, None], c_value,
                           torch.where(expanding[:, None], reuse_value, value[:, 0]))
        for i in range(max_depth):
            d = torch.clamp(depth - 1 - i, min=0)  # the deepest edge first
            valid = (i < depth).to(torch.float32)
            bn, ba = path_n[ar, d].clamp(min=0), path_a[ar, d].clamp(min=0)
            n_sa[ar, bn, ba] += valid
            w_sa[ar, bn, ba] += valid * pair[:, 1]
            pair = torch.where(valid[:, None] > 0, pair.flip(1), pair)

    root_n = n_sa[:, 0]
    root_q = torch.where(root_n > 0, w_sa[:, 0] / torch.clamp(root_n, min=1.0), _NEG)
    return root_n, root_q


def uct_search_policy(simulations: int = 64, params=None, c_puct: float = 1.5,
                      max_depth: int = 16) -> Tuple:
    """Eval-suite PolicySpec: PUCT tree search per move.  Plays the root
    action with the most visits; Q breaks ties.  `params` gives actor priors
    and critic leaf values; without it the priors are uniform and leaves
    score by prestige lead.  Deterministic: `generator` is not read."""

    @torch.no_grad()
    def fn(ctx, obs, mask, state, generator=None):
        root_n, root_q = uct_search(state, ctx, simulations, max_depth, c_puct)
        score = torch.where(mask, root_n + 1e-3 * torch.tanh(root_q), _NEG)
        return torch.argmax(score, dim=-1)

    fn.__name__ = f"uct_s{simulations}"
    fn.privileged = True  # the tree expands the true state
    return (fn, as_ctx(params))
