"""Flat Monte-Carlo lookahead on whole batches.

Counterpart of `splendax/search/mc.py`.  For every game and every one of the
45 root actions: apply the action with the rules engine, run `rollouts`
independent playouts of `horizon` plies (lanes freeze once terminal), score
each leaf from the searcher's point of view, and play the root action with
the best mean score.  A leaf that ended the game scores its exact reward
(win +1, loss -1, draw 0, turn-limit draw -0.1); a live leaf scores the
critic's value when a network is given, else the prestige lead over 15,
clipped to +-0.95 so that a proven result always beats an estimate.

The JAX package nests `vmap` over games, actions and playouts; here the
engine is batched already, so the nest is one flat lane batch of
B x 45 x rollouts games.  A network is given as `ctx`, its 12 weights in the
fused forward's layout (`models.actor_critic.kernel_weights`, or a pool
slot), best as a `PreparedWeights` handle (`as_ctx` builds one), so that a
search prepares them once; every forward runs the fused actor-critic
kernel: playout moves on the actor alone, leaves on the critic alone
(`fused_value_forward`, the value's bits those of the call with both
heads).

On the card in fast mode the flat batch of root children and each playout
step (the ply, the frozen lanes, the next obs and mask) are each one
launch of the ply's kernels (`ops/engine_ply`).

A search is `fn(ctx, obs, mask, state, generator=None, draws=None)`.  Its
random inputs come from `generator` unless `draws` gives them: for each ply
of the playouts the Gumbel noise f32 [N, 45] of the guided move sample, or
the uniform f32 [N] of the unguided one.

The searcher reads the full GameState (deck order, hidden reserves), hence
`privileged`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine import rules as R
from ..engine.encode import encode_observation
from ..engine.state import GameState
from ..env import core
from ..env.core import select
from ..models import actor_critic as ac
from ..ops import engine_ply
from ..ops.fused_actor_critic import PreparedWeights, fused_masked_forward, fused_value_forward
from ..selfplay.opponents import uniform_legal_action

_NEG = -float("inf")


def as_ctx(params):
    """The fused forward's 12 weights of `params` as a `PreparedWeights`
    handle, which the search context owns: `params` an `ActorCritic`, its 12
    weights (a handle is kept as it is), or None for a search without a
    network."""
    if params is None or isinstance(params, PreparedWeights):
        return params
    if isinstance(params, (list, tuple)):
        return PreparedWeights(params)
    return PreparedWeights(ac.kernel_weights(params))


def repeat_rows(state: GameState, n: int) -> GameState:
    """Each game n times in a row: [B] -> [B * n]."""
    return state.map(lambda x: x.repeat_interleave(n, dim=0))


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis, added left to right (the order in which
    the JAX package's reduce adds on the CPU, so sums agree bit for bit)."""
    total = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c, as the product with the float32 reciprocal of
    c: what XLA compiles the JAX package's division by a constant to, and
    what torch computes on a CUDA tensor divided by a Python scalar.  A true
    division, as torch makes on the CPU, can be an ulp off it."""
    return x * (torch.ones((), dtype=torch.float32) / c).item()


def playout_ply(state: GameState, generator=None, rng_mode: str = "fast", u=None) -> GameState:
    """One uniform-random ply for every game, frozen once terminal.  Steps
    through `core.step_core`, so a stalemate is a draw inside the search
    too."""
    term = R.is_terminal(state)
    mask = R.legal_mask(state)
    a = uniform_legal_action(mask, generator, u=u)
    nxt, _ = core.step_core(state, a, rng_mode=rng_mode, mask=mask)
    return select(term, state, nxt)  # a finished game stays as it is


def _by_seat(vec2: torch.Tensor, seat: torch.Tensor) -> torch.Tensor:
    """vec2[b, seat[b]] for vec2 [N, 2]."""
    return vec2.gather(1, seat.long()[:, None])[:, 0]


def leaf_values(states: GameState, me: torch.Tensor, ctx=None, obs=None) -> torch.Tensor:
    """f32 [N]: each leaf scored from player `me`'s point of view in
    [-1, 1].  `obs` may pass in the leaves' observations."""
    term = R.is_terminal(states)
    term_v = _by_seat(core.final_rewards_of(states), me)
    if ctx is None:
        lead = _by_seat(states.prestige, me) - _by_seat(states.prestige, 1 - me)
        live = div_const(lead.to(torch.float32), 15.0)
    else:
        if obs is None:
            obs = encode_observation(states)  # from the point of view of to_play
        v = fused_value_forward(ctx, obs)
        live = torch.where(states.to_play == me, v, -v)
    live = torch.clamp(live, -0.95, 0.95)
    return torch.where(term, term_v, live)


def observe(states: GameState, rng_mode: str = "fast", with_obs: bool = True):
    """(obs or None, legal mask) of each state."""
    if engine_ply.takes(states.to_play, rng_mode):
        return engine_ply.observe(states, with_obs=with_obs)[1:]
    return (encode_observation(states) if with_obs else None), R.legal_mask(states)


def playout_step(states: GameState, action: torch.Tensor, mask: torch.Tensor,
                 rng_mode: str = "fast", with_obs: bool = True):
    """One ply of every lane, a finished lane frozen, from the lanes' legal
    `mask` -> (successor, its obs or None, its legal mask): one launch of
    the step kernel on the card."""
    if engine_ply.takes(states.to_play, rng_mode):
        nxt, _, obs, next_mask = engine_ply.step(states, action, mask, freeze_terminal=True,
                                                 with_obs=with_obs, with_mask=True)
        return nxt, obs, next_mask
    term = R.is_terminal(states)
    nxt, _ = core.step_core(states, action, rng_mode=rng_mode, mask=mask)
    nxt = select(term, states, nxt)  # a finished lane stays as it is
    return (nxt,) + observe(nxt, with_obs=with_obs)


def rollout_values(flat_states: GameState, me_flat: torch.Tensor, ctx, generator,
                   horizon: int, rng_mode: str = "fast", guided: bool = True, draws=None,
                   obs=None, mask=None):
    """Play `horizon` plies from each of a flat batch of states and score
    the leaves from `me_flat`'s point of view.  Moves are sampled from the
    actor when `ctx` is given and `guided`, else uniformly over the legal
    actions.  `draws[k]` is ply k's random input (module docstring).
    `mask` and `obs` may pass in the states' legal masks and, with `ctx`,
    observations.  Each ply is kernel A and the sample, then one
    `playout_step`, which yields the next ply's obs and mask."""
    with_obs = ctx is not None  # the actor's and the critic's input
    st = flat_states
    if mask is None:
        obs, mask = observe(st, rng_mode=rng_mode, with_obs=with_obs)
    for k in range(horizon):
        d = None if draws is None else draws[k]
        if ctx is not None and guided:
            logits, _ = fused_masked_forward(ctx, obs, mask, with_value=False)
            a, _ = ac.sample_action(logits, mask, generator=generator, noise=d)
        else:
            a = uniform_legal_action(mask, generator, u=d)
        st, obs, mask = playout_step(st, a, mask, rng_mode=rng_mode, with_obs=with_obs)
    return leaf_values(st, me_flat, ctx, obs=obs)


def root_children(state: GameState, rng_mode: str) -> GameState:
    """child[b * 45 + a] = apply(state[b], a), all 45 actions of every game.
    Illegal actions give garbage children that the caller masks out."""
    B = state.batch_size
    acts = torch.arange(R.TOTAL_ACTIONS, device=state.to_play.device).repeat(B)
    return R.apply_action(repeat_rows(state, R.TOTAL_ACTIONS), acts, rng_mode=rng_mode)


def _flat_children(state: GameState, rng_mode: str = "fast", rollouts: int = 1,
                   with_obs: bool = True):
    """`root_children`, each `rollouts` times in a row, with their obs (or
    None) and legal masks."""
    if engine_ply.takes(state.to_play, rng_mode):
        acts = torch.arange(R.TOTAL_ACTIONS, device=state.to_play.device)
        acts = acts.repeat_interleave(rollouts).repeat(state.batch_size)
        nxt, _, obs, mask = engine_ply.step(state, acts, apply_only=True,
                                            repeat=R.TOTAL_ACTIONS * rollouts,
                                            with_obs=with_obs, with_mask=True)
        return nxt, obs, mask
    flat = repeat_rows(root_children(state, rng_mode), rollouts)
    return (flat,) + observe(flat, with_obs=with_obs)


def mc_search_q(rollouts: int = 8, horizon: int = 24, rng_mode: str = "fast",
                guided: bool = True):
    """The root Q function of the flat-MC search:
    `fn(ctx, obs, mask, state, generator=None, draws=None) -> q f32 [B, 45]`
    with illegal actions at -inf."""
    A = R.TOTAL_ACTIONS

    @torch.no_grad()
    def fn(ctx, obs, mask, state, generator=None, draws=None):
        B = mask.shape[0]
        flat, f_obs, f_mask = _flat_children(state, rng_mode=rng_mode, rollouts=rollouts,
                                             with_obs=ctx is not None)  # [B * A * K]
        me_flat = state.to_play.repeat_interleave(A * rollouts)
        vals = rollout_values(flat, me_flat, ctx, generator, horizon, rng_mode=rng_mode,
                              guided=guided, draws=draws, obs=f_obs, mask=f_mask)
        q = div_const(sum_last(vals.reshape(B, A, rollouts)), rollouts)
        return torch.where(mask, q, _NEG)

    fn.__name__ = f"mc_search_q_r{rollouts}_h{horizon}"
    fn.privileged = True
    return fn


def mc_search_policy(rollouts: int = 8, horizon: int = 24, params=None, rng_mode: str = "fast",
                     guided: bool = True) -> Tuple:
    """Eval-suite PolicySpec running the flat-MC search.  `params` (an
    `ActorCritic` or its kernel weights) guides the playouts with the actor
    (`guided=False` keeps them uniform) and scores live leaves with the
    critic."""
    q_fn = mc_search_q(rollouts, horizon, rng_mode=rng_mode, guided=guided)

    def fn(ctx, obs, mask, state, generator=None, draws=None):
        return torch.argmax(q_fn(ctx, obs, mask, state, generator, draws), dim=-1)

    fn.__name__ = f"mc_search_r{rollouts}_h{horizon}"
    fn.privileged = True  # expands and plays out the true state
    return (fn, as_ctx(params))
