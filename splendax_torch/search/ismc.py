"""Information-set search: determinized hidden information, on whole batches.

Counterpart of `splendax/search/ismc.py`.  The privileged searches (mc,
uct, gumbel) expand the true GameState, deck order and the opponent's blind
reserves included, which the 297-wide observation censors.  Here every
playout runs over a determinization of the root state: a world re-sampled
uniformly from the mover's information set, so that averaging playouts over
worlds estimates information-set action values.

`determinize` keeps, bit for bit, all the mover knows: everything in the
observation, the tier each blind opponent reserve came from, and the mover's
own blind reserves.  It re-samples, jointly and uniformly per tier, the
order of the face-down deck and the identities of the opponent's blind
reserves: a blind reserve is exchangeable with every card still in its
tier's deck.

The censored flat-MC search draws one world per (game, playout), shared
across the 45 root actions (common random numbers); the censored Gumbel
search is `gumbel.gumbel_search_fn` with `determinize_fn=determinize`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..engine import data as D
from ..engine import rules as R
from ..engine.state import GameState
from .mc import _NEG, as_ctx, div_const, repeat_rows, rollout_values, sum_last

A = R.TOTAL_ACTIONS
EXT = D.MAX_DECK + 3  # per-tier shuffle width: 40 deck slots + 3 reserve slots


def _tier_of(ids: torch.Tensor) -> torch.Tensor:
    """Tier (0..2) of card ids; -1-padded slots map to tier -1."""
    t = (ids >= int(D.TIER_OFFSETS[1])).long() + (ids >= int(D.TIER_OFFSETS[2])).long()
    return torch.where(ids >= 0, t, -1)


def determinize(state: GameState, generator=None, u=None) -> GameState:
    """Re-sample the hidden information of every game's mover uniformly.

    Per tier, the live deck cards and the opponent's blind reserves of that
    tier form one pool; a uniform permutation of the pool reassigns the
    blind reserves' identities and the deck order.  The permutation is the
    argsort of uniforms `u` f32 [N, 3, 43] (one row per tier: 40 deck slots,
    then the 3 reserve slots), drawn from `generator` unless given.  Both
    argsorts are stable, so dead slots and -1 padding stay in place; the
    observation and the legal mask do not change.
    """
    N = state.batch_size
    dev = state.to_play.device
    ar = torch.arange(N, device=dev)
    opp = 1 - state.to_play.long()
    opp_ids = state.reserved_ids[ar, opp]  # [N, 3]
    opp_rev = state.reserved_revealed[ar, opp]
    opp_cnt = state.reserved_count[ar, opp]
    ar3 = torch.arange(3, device=dev)
    # Slots whose identity the mover cannot know.
    blind = (opp_ids >= 0) & (ar3[None] < opp_cnt[:, None]) & (opp_rev == 0)
    blind_tier = _tier_of(opp_ids)
    if u is None:
        u = torch.rand((N, 3, EXT), generator=generator, device=dev)

    deck_live = torch.arange(D.MAX_DECK, device=dev)[None, None] < state.deck_count[:, :, None]
    res_live = blind[:, None, :] & (blind_tier[:, None, :] == ar3[None, :, None])  # [N, tier, slot]
    live = torch.cat([deck_live, res_live], dim=2)  # [N, 3, 43]
    vals = torch.cat([state.deck_perm, opp_ids[:, None, :].expand(N, 3, 3)], dim=2)
    # A random order of the live slots; dead slots keep their order behind.
    perm_idx = torch.argsort(torch.where(live, u, float("inf")), dim=2, stable=True)
    idx_live = torch.argsort((~live).to(torch.int8), dim=2, stable=True)
    shuffled = torch.zeros_like(vals).scatter(2, idx_live, vals.gather(2, perm_idx))
    new_deck = torch.where(deck_live, shuffled[:, :, : D.MAX_DECK], state.deck_perm)
    # A blind reserve is live in its own tier's row only.
    new_opp = torch.where(res_live, shuffled[:, :, D.MAX_DECK:], 0).sum(1).to(opp_ids.dtype)
    new_opp = torch.where(blind, new_opp, opp_ids)
    is_opp = torch.arange(2, device=dev)[None, :, None] == opp[:, None, None]
    return state.replace(deck_perm=new_deck,
                         reserved_ids=torch.where(is_opp, new_opp[:, None, :], state.reserved_ids))


def censored_mc_q(rollouts: int = 8, horizon: int = 24, rng_mode: str = "fast",
                  guided: bool = True):
    """Censored flat-MC root Q: like `mc.mc_search_q`, but every playout
    lane runs in a determinized world, one per (game, playout), shared by
    the 45 root actions.  `fn(ctx, obs, mask, state, generator=None,
    draws=None) -> q f32 [B, 45]` with illegal actions at -inf; `draws` is
    `{"det": u f32 [B * rollouts, 3, 43], "playout": per-ply draws}`."""

    @torch.no_grad()
    def fn(ctx, obs, mask, state, generator=None, draws=None):
        draws = draws or {}
        B = mask.shape[0]
        det = determinize(repeat_rows(state, rollouts), generator, u=draws.get("det"))
        # child[b, k, a] = apply(det[b, k], a): the root's refills come from
        # the re-sampled deck, not the true one.
        acts = torch.arange(A, device=mask.device).repeat(B * rollouts)
        flat = R.apply_action(repeat_rows(det, A), acts, rng_mode=rng_mode)
        me_flat = state.to_play.repeat_interleave(rollouts * A)
        vals = rollout_values(flat, me_flat, ctx, generator, horizon, rng_mode=rng_mode,
                              guided=guided, draws=draws.get("playout"))
        q = div_const(sum_last(vals.reshape(B, rollouts, A).transpose(1, 2)), rollouts)
        return torch.where(mask, q, _NEG)

    fn.__name__ = f"censored_mc_q_r{rollouts}_h{horizon}"
    fn.privileged = False  # playouts see determinized worlds only
    return fn


def censored_mc_policy(rollouts: int = 8, horizon: int = 24, params=None,
                       rng_mode: str = "fast", guided: bool = True) -> Tuple:
    """Eval-suite PolicySpec: the argmax of the censored flat-MC Q."""
    q_fn = censored_mc_q(rollouts, horizon, rng_mode=rng_mode, guided=guided)

    def fn(ctx, obs, mask, state, generator=None, draws=None):
        return torch.argmax(q_fn(ctx, obs, mask, state, generator, draws), dim=-1)

    fn.__name__ = f"censored_mc_r{rollouts}_h{horizon}"
    fn.privileged = False
    return (fn, as_ctx(params))


def censored_gumbel_policy(m: int = 16, k0: int = 6, horizon: int = 4, params=None,
                           c_scale: float = 10.0, rng_mode: str = "fast", guided: bool = True,
                           greedy_final: bool = False) -> Tuple:
    """Censored Gumbel sequential-halving search: `gumbel.gumbel_search_fn`
    with a fresh determinization per playout lane."""
    from .gumbel import gumbel_search_fn

    fn = gumbel_search_fn(m=m, k0=k0, horizon=horizon, c_scale=c_scale, rng_mode=rng_mode,
                          guided=guided, determinize_fn=determinize, greedy_final=greedy_final)
    return (fn, as_ctx(params))
