"""Multi-rank dry run: the whole PPO update on a dp x tp mesh of ranks.

Counterpart of `__graft_entry__.dryrun_multichip`.  `dryrun_multichip(n)`
starts n gloo ranks on this host (on the card, which they share, unless
`device="cpu"`) and runs, on a mesh with tp=2 (tp=1 below 4 ranks):
  * one plain `update_step` at tiny shapes;
  * one update of the search-hardened league slot (`--search-opponent
    --search-static`), whose strided sentinel rows split evenly over dp;
  * the Gumbel-search eval: each rank searches its rows of a dp-split
    batch with the weights gathered whole over tp (kernel A takes whole
    weights), from the global search's draws; every action must be legal.

    python -m splendax_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .multihost import spawn


def _rank(n: int, device: str) -> dict:
    from ..env import core
    from ..models import actor_critic as ac
    from ..ops import fused_actor_critic as fac
    from ..ops import ring_take as rt
    from ..search import gumbel
    from ..train import ppo
    from ..train.config import PPOConfig
    from . import collectives
    from .multihost import local_device

    dev = local_device(device)
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    B = max(8, 2 * dp)
    cfg = PPOConfig(num_envs=B, num_steps=4, minibatch_size=8, total_timesteps=B * 4,
                    pool_size=2, dp=dp, tp=tp)
    lines = []
    ts = ppo.init_train_state(cfg, device=dev)
    ts, metrics = ppo.update_step(cfg, ts)
    lines.append(f"dryrun_multichip OK: mesh dp={dp} tp={tp}, loss={metrics['loss'].item():.4f}, "
                 f"kl={metrics['approx_kl'].item():.4f}")

    cfg_league = cfg.replace(search_opponent=True, search_static=True, p_search=0.25,
                             search_m=4, search_k0=1, search_horizon=1)
    ts_l = ppo.init_train_state(cfg_league, device=dev)
    ts_l, m_l = ppo.update_step(cfg_league, ts_l)
    lines.append(f"dryrun_multichip league OK: search-static slot on dp={dp} tp={tp} "
                 f"(S={cfg_league.n_search_static} stride={cfg_league.search_stride}), "
                 f"loss={m_l['loss'].item():.4f}")

    mesh = ts.mesh
    g = torch.Generator(device=dev).manual_seed(3)
    state, obs, mask = core.reset(B, g, dev)
    lo, hi = mesh.row_range(B)
    weights = fac.PreparedWeights(ac.kernel_weights(ts.params))  # whole, gathered over tp
    m, k0, horizon = 4, 2, 2
    draws = gumbel.draw_rows(gumbel.draw_inputs(B, m, k0, horizon, g, dev), lo, hi, m, k0)
    search_fn = gumbel.gumbel_search_fn(m=m, k0=k0, horizon=horizon)
    actions = search_fn(weights, obs[lo:hi], mask[lo:hi], state.map(lambda x: x[lo:hi]), g,
                        draws=draws)
    legal = mask[lo:hi].gather(1, actions[:, None]).all()
    n_legal = collectives.all_reduce(legal.to(torch.int64).reshape(1), mesh.world_group)
    if int(n_legal) != n:
        raise AssertionError("multi-rank gumbel search returned an illegal action")
    lines.append(f"dryrun_multichip search-eval OK: gumbel m={m} k0={k0} on dp={dp} tp={tp}, "
                 f"B={B}, all actions legal")
    return {"lines": lines, "device": str(dev), "loss": metrics["loss"].item(),
            "launches": {**fac.launch_counts(), "ring_take": rt.launches},
            "routes": dict(collectives.routes)}


def dryrun_multichip(n_ranks: int, device: str = "cuda", timeout: float = 600.0) -> list:
    """Run the dry run on `n_ranks` ranks; prints rank 0's lines and
    returns every rank's result (its lines, device, kernel launches and
    collective routes)."""
    results = spawn(_rank, n_ranks, args=(n_ranks, device), device=device, timeout=timeout)
    for line in results[0]["lines"]:
        print(line, flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ranks", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.device)


if __name__ == "__main__":
    main()
