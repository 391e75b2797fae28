"""Gumbel sequential-halving root search on whole batches.

Counterpart of `splendax/search/gumbel.py`: the Gumbel-AlphaZero root
procedure (Danihelka et al. 2022) with wide batched playouts in place of a
tree.

1. `m` legal root actions are sampled without replacement by the
   Gumbel-top-k trick on the actor's masked logits (g + logits), the prior's
   argmax forced into slot 0.
2. `log2(m)` halving rounds: every surviving action gets `k0 * 2^r`
   actor-guided playouts of `horizon` plies (`mc.rollout_values`: critic
   leaves, exact terminal rewards); survivors are ranked by
   `g + logits + c_scale * q` and the top half kept.  Every round costs
   `m * k0` lanes a game.
3. The last survivor is the move: the argmax of `g + logits + c_scale * q`,
   or of `q` alone under `greedy_final`.

On the card in fast mode the root children, each round's lanes (their
states, obs and masks) and every playout step are each one launch of the
ply's kernels (`ops/engine_ply`); kernel A, the samples and the halving
run between them.

Halving is by rank with stable sorts, so which of two equal scores survives
is fixed: the lower slot.  Games with fewer than `m` legal actions pad with
-inf-scored slots, which sort last and never win.

The root prior and the playout moves run the fused actor-critic kernel,
whose logits come masked (-1e9 at illegal actions).  Every read of the
logits here is at a legal action, so the masked logits serve where the JAX
package takes the unmasked ones.

`draws` may give the search's random inputs: `{"g": Gumbel noise f32
[B, 45], "playout": for each round the per-ply draws of
`mc.rollout_values` on its B * m * k0 lanes, "det": for each round the
uniforms f32 [B * k_r, 3, 43] of `ismc.determinize`}`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import trace
from ..engine import rules as R
from ..engine.state import GameState
from ..models.actor_critic import gumbel_noise
from ..ops import engine_ply
from ..ops.fused_actor_critic import fused_masked_forward
from .mc import _NEG, as_ctx, observe, repeat_rows, rollout_values, sum_last

A = R.TOTAL_ACTIONS


def _root_candidates(gscore, logits, mask, m: int) -> torch.Tensor:
    """int64 [B, m]: the top-m actions by Gumbel-perturbed score, with the
    prior's argmax forced into slot 0.  The forcing changes the order of
    selection only: callers gather the honest g + logits per slot."""
    amax = torch.argmax(torch.where(mask, logits, _NEG), dim=-1)
    is_amax = torch.arange(gscore.shape[1], device=gscore.device)[None] == amax[:, None]
    sel = torch.where(is_amax, float("inf"), gscore)
    return torch.argsort(-sel, dim=-1, stable=True)[:, :m]


def children(state: GameState, actions: torch.Tensor, rng_mode: str = "fast") -> GameState:
    """child[b * m + j] = apply(state[b], actions[b, j]) for actions [B, m]."""
    if engine_ply.takes(state.to_play, rng_mode):
        return engine_ply.step(state, actions.reshape(-1), apply_only=True,
                               repeat=actions.shape[1])[0]
    return R.apply_action(repeat_rows(state, actions.shape[1]), actions.reshape(-1),
                          rng_mode=rng_mode)


def _lanes(child: GameState, lane_child: torch.Tensor, rng_mode: str = "fast",
           with_obs: bool = True):
    """The playout lanes' states, `child[lane_child]`, with their obs (or
    None) and legal masks."""
    if engine_ply.takes(child.to_play, rng_mode):
        return engine_ply.observe(child, rows=lane_child, with_obs=with_obs)
    flat = child.map(lambda x: x[lane_child])
    return (flat,) + observe(flat, with_obs=with_obs)


def gumbel_search_fn(m: int = 16, k0: int = 6, horizon: int = 4, c_scale: float = 10.0,
                     rng_mode: str = "fast", guided: bool = True, determinize_fn=None,
                     greedy_final: bool = False):
    """Returns `fn(ctx, obs, mask, state, generator=None, draws=None,
    info=None) -> action int64 [B]`, one Gumbel sequential-halving search
    per game.

    `m` must be a power of two, at most 45; `k0` is the playouts per
    candidate in round 0.  `ctx` (kernel weights) gives the actor prior, the
    guided playout policy and the critic's leaf values; without it the
    prior is uniform over the legal actions and leaves score by prestige
    lead.

    `determinize_fn` (`ismc.determinize`) switches to information-set mode:
    each round draws k_r fresh worlds a game, shared across the surviving
    candidates, and each playout lane expands its root child from its
    world instead of the true state.

    A dict passed as `info` receives the candidates, the survivors, the
    mean values, the final scores and the scores at every halving.
    """
    rounds = int(m).bit_length() - 1
    if m <= 1 or (1 << rounds) != m:
        raise ValueError(f"m must be a power of two >= 2, got {m}")
    if m > A:
        raise ValueError(f"m must be <= TOTAL_ACTIONS ({A}), got {m}")

    @torch.no_grad()
    def fn(ctx, obs, mask, state, generator=None, draws=None, info=None):
        with trace.span("search"):
            draws = draws or {}
            B = mask.shape[0]
            dev = mask.device
            me = state.to_play
            rows = torch.arange(B, device=dev)[:, None]

            if ctx is not None:
                logits, _ = fused_masked_forward(ctx, obs, mask, with_value=False)
            else:
                logits = torch.zeros((B, A), device=dev)
            g = draws["g"] if "g" in draws else gumbel_noise((B, A), generator, dev)
            gscore = torch.where(mask, g + logits, _NEG)
            cand = _root_candidates(gscore, logits, mask, m)  # [B, m]
            cand_live = mask.gather(1, cand)
            cand_g = gscore.gather(1, cand)  # g + logits, -inf in padded slots

            if determinize_fn is None:
                # Root children once per candidate: child[b * m + j].
                child = children(state, cand, rng_mode=rng_mode)

            q_sum = torch.zeros((B, m), device=dev)
            n_cnt = torch.zeros((B, m), device=dev)
            alive = cand_live
            lanes = m * k0  # the lane budget of every round
            cuts = []  # (scores, slots kept) of every halving

            for r in range(rounds):
                with trace.span("search.round"):
                    n_alive = m >> r
                    k_r = lanes // n_alive
                    # Survivors packed into the first n_alive slots, in slot order.
                    order = torch.argsort((~alive).to(torch.int8), dim=-1, stable=True)[:, :n_alive]
                    f_obs = f_mask = None
                    if determinize_fn is None:
                        lane_child = (rows * m + order).reshape(-1).repeat_interleave(k_r)
                        flat, f_obs, f_mask = _lanes(child, lane_child, rng_mode=rng_mode,
                                                     with_obs=ctx is not None)
                    else:
                        det = determinize_fn(repeat_rows(state, k_r), generator,
                                             u=draws["det"][r] if "det" in draws else None)
                        # Lane (b, a, k) expands candidate a in world (b, k).
                        world = (rows[:, :, None] * k_r
                                 + torch.arange(k_r, device=dev)[None, None, :])
                        world = world.expand(B, n_alive, k_r).reshape(-1)
                        act = cand.gather(1, order).repeat_interleave(k_r, dim=1).reshape(-1)
                        flat = R.apply_action(det.map(lambda x: x[world]), act, rng_mode=rng_mode)
                    me_flat = me.repeat_interleave(n_alive * k_r)
                    vals = rollout_values(
                        flat, me_flat, ctx, generator, horizon, rng_mode=rng_mode, guided=guided,
                        draws=draws["playout"][r] if "playout" in draws else None,
                        obs=f_obs, mask=f_mask,
                    ).reshape(B, n_alive, k_r)
                    # The survivors' sums go back to their own slots.
                    add_sum = torch.zeros((B, m), device=dev).scatter_add(1, order, sum_last(vals))
                    add_cnt = torch.zeros((B, m), device=dev).scatter_add(
                        1, order, torch.full((B, n_alive), float(k_r), device=dev))
                    q_sum = q_sum + torch.where(alive, add_sum, 0.0)
                    n_cnt = n_cnt + torch.where(alive, add_cnt, 0.0)

                    if r < rounds - 1:
                        q_hat = q_sum / torch.clamp(n_cnt, min=1.0)
                        score = torch.where(alive, cand_g + c_scale * q_hat, _NEG)
                        keep = m >> (r + 1)
                        # The top `keep` slots by rank, not by a threshold: a tie at
                        # the threshold must not keep extra slots.
                        top = torch.argsort(-score, dim=-1, stable=True)[:, :keep]
                        cuts.append((score, keep))
                        in_top = torch.zeros((B, m), dtype=torch.bool, device=dev).scatter(
                            1, top, torch.ones_like(top, dtype=torch.bool))
                        alive = alive & in_top

            # Never a padded slot: alive is a subset of cand_live, and slot 0 is
            # legal whenever any action is.
            q_hat = q_sum / torch.clamp(n_cnt, min=1.0)
            if greedy_final:
                final = torch.where(alive, q_hat + 1e-3 * logits.gather(1, cand), _NEG)
            else:
                final = torch.where(alive, cand_g + c_scale * q_hat, _NEG)
            best_slot = torch.argmax(final, dim=-1)
            if info is not None:
                info.update(cand=cand, alive=alive, q_hat=q_hat, final=final, cuts=cuts)
            return cand.gather(1, best_slot[:, None])[:, 0]

    censored = determinize_fn is not None
    fn.__name__ = (f"{'censored_' if censored else ''}gumbel_search_m{m}_k{k0}_h{horizon}"
                   f"{'_gf' if greedy_final else ''}")
    # Privileged unless determinized: the root children expand the true state.
    fn.privileged = not censored
    return fn


def draw_inputs(B: int, m: int, k0: int, horizon: int, generator, device,
                censored: bool = False) -> dict:
    """The `draws` that `gumbel_search_fn(m, k0, horizon)` would take from
    `generator` for B games, taken in the same order: the root's Gumbel
    noise, then for each round its determinizations' uniforms (`censored`)
    and its playout plies' Gumbel noise [B * m * k0, 45] (the playouts
    follow the actor).  Every draw is game-major, so `draw_rows` can cut it."""
    from .ismc import EXT

    rounds = int(m).bit_length() - 1
    lanes = m * k0
    draws = {"g": gumbel_noise((B, A), generator, device), "playout": []}
    if censored:
        draws["det"] = []
    for r in range(rounds):
        if censored:
            k_r = lanes // (m >> r)
            draws["det"].append(torch.rand((B * k_r, 3, EXT), generator=generator, device=device))
        draws["playout"].append([gumbel_noise((B * lanes, A), generator, device)
                                 for _ in range(horizon)])
    return draws


def draw_rows(draws: dict, lo: int, hi: int, m: int, k0: int) -> dict:
    """The draws of games [lo, hi) of `draw_inputs`' batch."""
    lanes = m * k0
    out = {"g": draws["g"][lo:hi],
           "playout": [[d[lo * lanes:hi * lanes] for d in plies] for plies in draws["playout"]]}
    if "det" in draws:
        out["det"] = []
        for u in draws["det"]:
            k_r = u.shape[0] // draws["g"].shape[0]
            out["det"].append(u[lo * k_r:hi * k_r])
    return out


def gumbel_search_policy(m: int = 16, k0: int = 6, horizon: int = 4, params=None,
                         c_scale: float = 10.0, rng_mode: str = "fast", guided: bool = True,
                         greedy_final: bool = False) -> Tuple:
    """Eval-suite PolicySpec for the Gumbel sequential-halving search."""
    fn = gumbel_search_fn(m=m, k0=k0, horizon=horizon, c_scale=c_scale, rng_mode=rng_mode,
                          guided=guided, greedy_final=greedy_final)
    return (fn, as_ctx(params))
