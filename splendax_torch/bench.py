"""The port's benchmark: one workload per invocation, one JSON line on stdout.

    python -m splendax_torch.bench                                   # env, ring autoreset
    python -m splendax_torch.bench --naive-reset                     # env, full-batch reset
    python -m splendax_torch.bench --workload update --slot static   # the league recipe
    python -m splendax_torch.bench --workload search --bot gumbel    # a search bot's eval

Workload `env` (the default) is the counterpart of the root `bench.py`:
env steps/s of B=32,768 games in lockstep, each step a uniform random legal
action, the rules step, the 297-dim encode and the autoreset.  The obs and
the reward are summed on the device so that the encode is done and read.
A call runs 400 steps and deals its ring of B * ceil(steps / 64) fresh games
(window 4,096) inside the timed region; 1 warm-up call, then 5 timed ones.
The value is the best call, with the mean and median beside it.  The run
raises unless the ring never clamped a lane (its overflow summed over all
calls is 0) and, on the card, kernel B launched once a step.

Workload `update` times `train/ppo.update_step` at the league recipe
(`runs/ppo_splendor_2b_h768_league/config.json`, `league_config`, its seed
42 unless `--seed` is given), the counterpart of
`scripts/profile_train.py`'s update and of `scripts/bench_search_slot.py`'s
variants (`--slot`).  With the committed nets (`flagship_state`, the
default) the state is the recipe's late update: the pool full, as it is
from update 16 * 12 on, and the schedule at the last updates of the
committed agent's run, whose lr and approx-KL its metrics.jsonl logged
(`committed_update`).  The warm-up is that run's update 3,811; the timed
reps repeat update 3,812, where the run logged a KL far under the stop,
so each rep must take all 64 optimizer steps, as the run did.  With
`--weights random` (`--hidden`, `--num-envs`, `--num-steps`) the warm-up
is the recipe's first update.  Each timed rep starts from the state the
warm-up left (params, optimizer state, pool, games, opponents and
generator, saved once, the pool slots' kernel A preparations with it), so
every rep does the same work; one more rep reports the seconds of the
rollout, GAE and the epochs, with a synchronise around each, and checks
kernel A's modes and preparations, apart from the headline reps.  Agent
steps/s = num_envs * num_steps / seconds per update.  The line gives the
weight preparations an update (`preparations_per_update`: the CURRENT slot
once after its write, and any slot the saved state left stale), the
prepared buffers the pool holds (`prepared_bytes`) and the peak memory.
The run raises unless every metric is finite, the committed state's reps
took every optimizer step and, on the card, every kernel A launch took the
route and mode its shape derives and prepared as its weights called for
(no slot more than once an update), every update launched the same
kernels, and kernel B launched once a turn.

Workload `search` (`--bot mc|gumbel|uct|greedy`) is the counterpart of
`scripts/time_search.py`: the bot over the committed h768 net
(`runs/ppo_splendor_2b_h768`) plays `suite.eval_vs_opponent` against that
net's greedy policy, `--games` (100) games from seed 7.  The bots are
time_search's: `mc_search_policy(8, 4)`, `gumbel_search_policy(m=16, k0=6,
horizon=4)`, `uct_search_policy(64)` and the greedy net itself, all on one
`PreparedWeights` handle that the opponent shares.  One untimed warm-up eval
(the kernel builds, first use, the one weight preparation, and kernel A's
modes derived from its shapes), then `--reps` (2) timed evals; the value is
the best.  `search_moves_per_sec` is the agent's moves in live games (each
game's agent moves, summed) over the best eval's seconds; `ms_per_move` is
that eval's seconds over the turns its loop ran (`turns_played`), which is
time_search's figure with another denominator: JAX's eval scan always runs
100 turns, the port's loop stops once no game is active.  The run raises
unless every agent move was legal, each timed eval launched what the
warm-up launched (no preparation), the same moves in the same turns, and,
on the card, every kernel A launch took the wgmma route in the mode its B
derives.

`--seed` seeds the env workload's generator (default 0) and the update
workload's TrainState (default the recipe's).  Entry points run on the
card unless given `device="cpu"` (`--device cpu`), and raise on a machine
without one.  Timing: `time.perf_counter()` around work that ends in
`torch.cuda.synchronize()`.  Everything but the JSON line goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import time

import torch

from . import trace
from .device import resolve_device
from .env import core
from .env import ring as ring_lib
from .ops import fused_actor_critic as fac
from .ops import ring_take as rt
from .ops import engine_ply as ep
from .selfplay.opponents import uniform_legal_action
from .train.config import PPOConfig

BASELINE_STEPS_PER_SEC = 6000.0  # the reference's single-env CPU assertion, as bench.py:40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAGUE_CONFIG = "runs/ppo_splendor_2b_h768_league/config.json"
AGENT_NPZ = "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"
AGENT_METRICS = "runs/ppo_splendor_2b_h768/metrics.jsonl"
POOL_NPZ = ("runs/ppo_splendor_4b_h768/ppo_splendor_params.npz",
            "runs/distill_h768/distilled_params.npz")
# The league slot's variants, as scripts/bench_search_slot.py sets them.
SLOTS = {
    "none": dict(search_opponent=False, search_static=False, search_censored=False),
    "bernoulli": dict(search_opponent=True, search_static=False, search_censored=False),
    "static": dict(search_opponent=True, search_static=True, search_censored=False),
    "static_cens": dict(search_opponent=True, search_static=True, search_censored=True),
}
LEARNER_PHASES = ("rollout", "_gae", "_ppo_epochs")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {msg}")


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- launch counts

# The mode each wgmma or wide forward should take, derived from its B
# while `derived_modes` is open: "derived_tile", "derived_cluster",
# "derived_wide_pass" and "derived_wide_half" beside the counters that
# `read_launches` returns; and "derived_prep", the weight preparations the
# forwards' weights call for.
DERIVED = {"tile": 0, "cluster": 0, "wide_pass": 0, "wide_half": 0, "prep": 0}


def needs_preparation(weights) -> bool:
    """True if a forward on `weights` prepares them: a plain list always; a
    `PreparedWeights` handle only if it was never prepared or a write has
    moved the version counter of a weight it read since (the pool's writes,
    an optimizer step, a restore)."""
    return not isinstance(weights, fac.PreparedWeights) or weights.stale()


@contextlib.contextmanager
def derived_modes():
    """While open, each wgmma or wide forward whose mode the wrapper picks
    adds the mode its B gives (`wgmma_mode`, `wide_mode`) to DERIVED.  A
    launch that names its mode (the kernel phase's) adds nothing.  Each
    forward of those routes that is not given a prepared buffer adds the
    preparation its weights call for (`needs_preparation`).  Keep it out of
    timed work: it wraps every forward in Python."""
    launch = fac._launch

    def derived(r, weights, obs, mask, with_value, prepared=None, lib=None, mode=None):
        if r == "wgmma" and mode is None:
            DERIVED[fac.wgmma_mode(obs.shape[0], weights[0].shape[1])] += 1
        elif r == "wide" and mode is None:
            DERIVED["wide_" + fac.wide_mode(obs.shape[0], weights[0].shape[1], with_value)] += 1
        if prepared is None and obs.shape[0] > 0:
            DERIVED["prep"] += needs_preparation(weights)
        return launch(r, weights, obs, mask, with_value, prepared, lib, mode)

    fac._launch = derived
    try:
        yield
    finally:
        fac._launch = launch


def kernel_launches() -> dict:
    """The kernels' own launch counters (`read_launches` without the
    derived modes)."""
    return {**fac.launch_counts(), "ring_take": rt.launches,
            **{f"engine_ply_{k}": n for k, n in ep.launches.items()}}


def read_launches() -> dict:
    """The launch counters: kernel A's forwards in all ("fused_actor_critic"),
    by route and by the wgmma and wide routes' modes, those of the critic
    alone ("fused_actor_critic_critic_only"), its weight preparations,
    kernel B and the ply's kernels (`engine_ply_step`,
    `engine_ply_observe`); and the modes derived from the forwards' B and
    the preparations derived from their weights."""
    return {**kernel_launches(), **{f"derived_{m}": n for m, n in DERIVED.items()}}


def zero_launches() -> None:
    trace.zero("kernel_a.")
    trace.zero("kernel_b.")
    trace.zero("engine_ply.")
    for k in DERIVED:
        DERIVED[k] = 0


def check_route(path: str, n: dict, route: str = "wgmma") -> None:
    """Every kernel A launch of the path took `route` (the hidden width's),
    none another route, the weights were prepared as often as the forwards'
    weights called for (`needs_preparation`: once per forward on a plain
    list, once per written weight version on a handle), and the wgmma and
    wide forwards took the modes their B derive."""
    others = [r for r in fac.launches_by_route if r != route]
    check(n["fused_actor_critic"] > 0 and n["fused_actor_critic_" + route] == n["fused_actor_critic"]
          and all(n["fused_actor_critic_" + r] == 0 for r in others),
          f"{path}: kernel A's launches did not all take the {route} route: {n}")
    check(n["fused_actor_critic_prep"] == n["derived_prep"],
          f"{path}: kernel A prepared its weights {n['fused_actor_critic_prep']} times, its "
          f"forwards' weights called for {n['derived_prep']}: {n}")
    for r, names in (("wgmma", ("tile", "cluster")), ("wide", ("wide_pass", "wide_half"))):
        modes = {m: n["fused_actor_critic_" + m] for m in names}
        check(sum(modes.values()) == n["fused_actor_critic_" + r]
              and all(modes[m] == n["derived_" + m] for m in modes),
              f"{path}: kernel A's {r} modes {modes} are not those its B derive: {n}")


# ---------------------------------------------------------------- env workload

def env_step(state, mask, ring, u=None, generator=None):
    """One step of the env workload: a uniform legal action (the
    floor(u * n_legal)-th, `u` f32 [B] drawn from `generator` unless
    given), the step, and the autoreset from `ring` (the full-batch reset
    from `generator` where `ring` is None).  Returns (state, mask, ring,
    (games ended, obs sum, reward sum)) with the sums on the device."""
    action = uniform_legal_action(mask, generator, u=u)
    if ring is None:
        state, out, obs, mask = core.step_autoreset(state, action, generator, mask=mask)
    else:
        state, out, obs, mask, ring = ring_lib.step_autoreset_ring(state, action, ring, mask=mask)
    return state, mask, ring, (out.terminated.sum(), obs.sum(), out.reward.sum())


def env_call(state, mask, steps: int, generator, naive: bool = False,
             window: int = ring_lib.DEFAULT_WINDOW):
    """One call of the env workload: deal the ring (unless `naive`), then
    `steps` steps.  Returns (state, mask, games ended, obs sum, reward sum,
    ring overflow), the last four device scalars."""
    B, dev = mask.shape[0], mask.device
    ring = (None if naive else
            ring_lib.make_ring(B * max(1, -(-steps // 64)), generator, dev, window=window))
    done = torch.zeros((), dtype=torch.int64, device=dev)
    obs_sum = torch.zeros((), dtype=torch.int64, device=dev)
    r_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(steps):
        state, mask, ring, (d, o, r) = env_step(state, mask, ring, generator=generator)
        done += d
        obs_sum += o
        r_sum += r
    overflow = torch.zeros((), dtype=torch.int64, device=dev) if ring is None else ring.overflow
    return state, mask, done, obs_sum, r_sum, overflow


def bench_env_steps(batch: int = 32768, steps: int = 400, reps: int = 5, naive: bool = False,
                    device="cuda", seed: int = 0, window: int = ring_lib.DEFAULT_WINDOW) -> dict:
    """Env steps/s of `batch` games: 1 warm-up call, then `reps` timed calls
    of `steps` steps each.  Raises if the ring clamped a lane or, on the
    card, kernel B did not launch once a ring step."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    state, _, mask = core.reset(batch, g, dev)
    n0 = rt.launches
    state, mask, done, _, _, overflow = env_call(state, mask, steps, g, naive, window)  # warm-up
    synchronize(dev)
    total_overflow = int(overflow)
    per_rep = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, mask, done, _, _, overflow = env_call(state, mask, steps, g, naive, window)
        synchronize(dev)
        per_rep.append(batch * steps / (time.perf_counter() - t0))
        total_overflow += int(overflow)
    takes = rt.launches - n0
    check(total_overflow == 0, f"ring window overflow: {total_overflow} lanes")
    want = (reps + 1) * steps if dev.type == "cuda" and not naive else 0
    check(takes == want, f"kernel B launched {takes} times, not {want}")
    return {
        "steps_per_sec": max(per_rep),
        "steps_per_sec_mean": statistics.mean(per_rep),
        "steps_per_sec_median": statistics.median(per_rep),
        "per_rep": per_rep,
        "batch": batch,
        "scan_steps": steps,
        "reps": reps,
        "episodes_finished_last_rep": int(done),
        "ring_overflow": total_overflow,
        "ring_take_launches": takes,
    }


# ---------------------------------------------------------------- update workload

def league_config(slot: str = "static") -> PPOConfig:
    """`runs/ppo_splendor_2b_h768_league/config.json` with the league slot
    `slot` (SLOTS; the committed recipe's is "static")."""
    with open(os.path.join(ROOT, LEAGUE_CONFIG)) as f:
        return PPOConfig(**json.load(f)).replace(**SLOTS[slot])


def flagship_state(cfg: PPOConfig, device, full_pool: bool = False):
    """A TrainState at flagship width: the agent from the committed 2B-step
    h768 run, two frozen pool slots from the 4B-step and the distilled h768
    nets (and, with `full_pool`, the agent in every other frozen slot)."""
    from .models.actor_critic import import_params_npz
    from .selfplay import pool as pool_lib
    from .train import ppo

    agent = import_params_npz(os.path.join(ROOT, AGENT_NPZ), device=device)
    ts = ppo.init_train_state(cfg, params=agent, device=device)
    pool = ts.pool
    for src in POOL_NPZ:
        pool = pool_lib.push_snapshot(pool, import_params_npz(os.path.join(ROOT, src), device=device))
    while full_pool and pool.filled < pool.pool_size:
        pool = pool_lib.push_snapshot(pool, agent)
    ts.pool = pool
    opp_idx = ppo._sample_opponents(cfg, pool, ts.generator, cfg.num_envs)
    ts.opp_idx = opp_idx if ts.mesh is None else ts.mesh.rows(opp_idx)  # the global draw's rows
    return ts


def committed_update(cfg: PPOConfig) -> dict:
    """The update of the committed agent's run (AGENT_METRICS) that the
    update workload repeats with the committed nets: the schedule's last
    with an lr above 0 (`num_updates - 2`; the last one's is 0).  Returns
    its index, the lr the recipe's schedule gives it, and the lr and
    approx-KL the run logged for it.  Raises unless the two lrs agree (to
    1e-3: near the schedule's end 1 - progress keeps few float32 bits, and
    the run rounded it on another device) and the logged KL lies under
    the stop: then the run took every optimizer step of that update."""
    from .train import ppo

    k = cfg.num_updates - 2
    step = (k + 1) * cfg.batch_size  # a train line logs the step count after its update
    with open(os.path.join(ROOT, AGENT_METRICS)) as f:
        lines = [d for d in map(json.loads, f) if d.get("type") == "train" and d["step"] == step]
    check(len(lines) == 1, f"{AGENT_METRICS} logs {len(lines)} train lines at step {step}")
    lr, _ = ppo._anneal(cfg, k)
    logged = lines[0]
    check(lr > 0 and math.isclose(lr, logged["lr"], rel_tol=1e-3),
          f"update {k}: the recipe's lr {lr} is not the run's {logged['lr']}")
    check(logged["approx_kl"] <= cfg.target_kl,
          f"update {k}: the run logged approx_kl {logged['approx_kl']} over the stop")
    return {"update": k, "lr": lr, "logged_lr": logged["lr"],
            "logged_approx_kl": logged["approx_kl"]}


@contextlib.contextmanager
def timed_calls(module, names, seconds: dict, last: dict, launches: dict | None = None,
                device="cuda"):
    """While open, each function `names` of `module` adds its synchronised
    host seconds to `seconds` (and, given `launches`, its kernel A launches
    to it) and leaves its last arguments and result in `last`."""
    originals = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def wrapper(*args, **kw):
            synchronize(device)
            t0, n0 = time.perf_counter(), fac.launches
            out = fn(*args, **kw)
            synchronize(device)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            if launches is not None:
                launches[name] = launches.get(name, 0) + fac.launches - n0
            last[name] = (args, out)
            return out
        return wrapper

    for name, fn in originals.items():
        setattr(module, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def save_state(ts):
    """A copy of TrainState `ts` that later updates leave alone: (the state
    without its generator, the generator's state).  A torch.Generator does
    not deepcopy."""
    return copy.deepcopy(dataclasses.replace(ts, generator=None)), ts.generator.get_state()


def restore_state(saved):
    """A fresh TrainState from `save_state`'s copy."""
    frozen, gen_state = saved
    ts = copy.deepcopy(frozen)
    gen = torch.Generator(device=ts.obs.device)
    gen.set_state(gen_state)
    return dataclasses.replace(ts, generator=gen)


def timed_updates(cfg: PPOConfig, saved, reps: int) -> list:
    """`reps` update_steps, each from the saved state -> one dict a rep:
    seconds, optimizer steps, metrics, kernel launches and the params
    after it."""
    from .train import ppo

    out = []
    for _ in range(reps):
        ts = restore_state(saved)
        dev = ts.obs.device
        count0, n0 = ts.opt_state.count, kernel_launches()
        synchronize(dev)
        t0 = time.perf_counter()
        ts, metrics = ppo.update_step(cfg, ts)
        synchronize(dev)
        dt = time.perf_counter() - t0
        out.append(dict(seconds=dt, optimizer_steps=ts.opt_state.count - count0,
                        metrics={k: v.item() for k, v in metrics.items()},
                        launches={k: v - n0[k] for k, v in kernel_launches().items()},
                        params=[p.detach() for p in ts.params.parameters()]))
    return out


def bench_update(slot: str = "static", weights: str = "committed", hidden: int | None = None,
                 num_envs: int | None = None, num_steps: int | None = None, reps: int = 3,
                 device="cuda", seed: int | None = None) -> dict:
    """Agent steps/s of the league recipe's `update_step` with slot `slot`:
    1 warm-up update, `reps` timed ones each from the state it left, and
    one more split into rollout, GAE and epochs, with kernel A's modes
    derived from its shapes."""
    from .train import ppo

    dev = resolve_device(device)
    cfg = league_config(slot)
    cfg = cfg.replace(**{k: v for k, v in (("seed", seed), ("hidden", hidden),
                                           ("num_envs", num_envs), ("num_steps", num_steps))
                         if v is not None})
    full = cfg.update_epochs * cfg.num_minibatches
    if weights == "committed":
        check(cfg == league_config(slot).replace(seed=cfg.seed),
              "the committed nets run at the recipe's shape (H=768, 8192 x 64)")
        at = committed_update(cfg)
        ts = flagship_state(cfg, dev, full_pool=True)
        ts = dataclasses.replace(ts, update_idx=at["update"] - 1,
                                 global_step=(at["update"] - 1) * cfg.batch_size)
    elif weights == "random":
        at = {"update": 1}
        ts = ppo.init_train_state(cfg, device=dev)
    else:
        raise ValueError(f"weights must be 'committed' or 'random', not {weights!r}")
    ts, _ = ppo.update_step(cfg, ts)  # the warm-up: the update before the timed one
    synchronize(dev)
    check(ts.update_idx == at["update"], f"the timed update is {ts.update_idx}")
    saved = save_state(ts)
    del ts
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = timed_updates(cfg, saved, reps)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    split, last = {}, {}
    ts = restore_state(saved)
    stale = sum(h.stale() for h in ts.pool.slots)  # slots whose handle the saved state left stale
    before = read_launches()
    with derived_modes(), timed_calls(ppo, LEARNER_PHASES, split, last, device=dev):
        ts, _ = ppo.update_step(cfg, ts)
    per_update = {k: v - before[k] for k, v in read_launches().items()}
    prepared_bytes = sum(h.prepared_bytes for h in ts.pool.slots)
    del ts, last

    for i, r in enumerate(runs):
        check(all(v == v and abs(v) != float("inf") for v in r["metrics"].values()),
              f"rep {i}: a metric is not finite: {r['metrics']}")
        check(r["launches"] == {k: per_update[k] for k in r["launches"]},
              f"rep {i} launched {r['launches']}, the split rep {per_update}")
        if weights == "committed":
            check(r["optimizer_steps"] == full,
                  f"rep {i} took {r['optimizer_steps']} of {full} optimizer steps; the run took "
                  f"all at update {at['update']} (approx_kl {at['logged_approx_kl']})")
    if dev.type == "cuda":
        check_route(f"update ({slot})", per_update, fac.route(cfg.hidden))
        # An update writes CURRENT before its first forward and pushes a
        # snapshot after its last: each slot's handle prepares at most once.
        check(per_update["fused_actor_critic_prep"] <= cfg.pool_size + 1,
              f"{per_update['fused_actor_critic_prep']} weight preparations in an update, more "
              f"than its {cfg.pool_size + 1} pool slots")
        want_b = cfg.num_steps if cfg.reset_ring_mult > 0 else 0
    else:  # the plain versions run on the CPU and launch nothing
        check(not any(per_update.values()), f"a kernel counted a launch on the CPU: {per_update}")
        want_b = 0
    check(per_update["ring_take"] == want_b,
          f"kernel B launched {per_update['ring_take']} times in an update, not {want_b}")
    rates = [cfg.batch_size / r["seconds"] for r in runs]
    return {
        "agent_steps_per_sec": max(rates),
        "mean": statistics.mean(rates),
        "median": statistics.median(rates),
        "per_rep": rates,
        "seconds_per_rep": [r["seconds"] for r in runs],
        "optimizer_steps_per_rep": [r["optimizer_steps"] for r in runs],
        "optimizer_steps_max": full,
        "approx_kl_per_rep": [r["metrics"]["approx_kl"] for r in runs],
        "update": at,
        "split_seconds": {"rollout": split["rollout"], "gae": split["_gae"],
                          "epochs": split["_ppo_epochs"]},
        "peak_memory_bytes": peak,
        "preparations_per_update": per_update["fused_actor_critic_prep"],
        "slots_stale_at_start": stale,
        "prepared_bytes": prepared_bytes,
        "launches_per_update": per_update,
        "updates_counted": reps + 1,  # each launched launches_per_update; the warm-up uncounted
        "last_metrics": runs[-1]["metrics"],
        "seed": cfg.seed,
        "num_envs": cfg.num_envs,
        "num_steps": cfg.num_steps,
        "hidden": cfg.hidden,
        "minibatch_size": cfg.minibatch_size,
        "update_epochs": cfg.update_epochs,
    }


# ---------------------------------------------------------------- search workload

SEARCH_BOTS = ("mc", "gumbel", "uct", "greedy")
SEARCH_SEED = 7  # scripts/time_search.py's eval seed


def search_bots(params) -> dict:
    """scripts/time_search.py's bots over `params` (an `ActorCritic`):
    {name: (time_search's label, PolicySpec)}, all on one `PreparedWeights`
    handle, so the net is prepared once for every bot and the greedy
    opponent.  Building them launches nothing."""
    from . import search
    from .eval import suite
    from .models import actor_critic as ac

    net = fac.PreparedWeights(ac.kernel_weights(params))
    return {
        "mc": ("mc(r8,h4)", search.mc_search_policy(8, 4, net)),
        "gumbel": ("gumbel(m16,k6,h4)", search.gumbel_search_policy(m=16, k0=6, horizon=4,
                                                                    params=net)),
        "uct": ("uct(s64)", search.uct_search_policy(64, params=net)),
        "greedy": ("greedy", (suite._greedy_model_fn, net)),
    }


def bench_search(bot: str, games: int = 100, reps: int = 2, device="cuda",
                 seed: int = SEARCH_SEED) -> dict:
    """Agent moves/s of search bot `bot` (SEARCH_BOTS) against the greedy
    h768 net over `games` games: one untimed warm-up eval with kernel A's
    modes derived, then `reps` timed evals."""
    from .eval import suite
    from .models.actor_critic import import_params_npz

    check(bot in SEARCH_BOTS, f"unknown bot {bot!r}, not one of {SEARCH_BOTS}")
    dev = resolve_device(device)
    params = import_params_npz(os.path.join(ROOT, AGENT_NPZ), device=dev)
    bots = search_bots(params)
    label, spec = bots[bot]
    opponent = bots["greedy"][1]
    last = {}

    def evaluate():
        """One eval -> (its result, agent moves in live games, turns the
        loop ran); each game's moves come from `_match`'s checks."""
        with timed_calls(suite, ["_match"], {}, last, device=dev):
            res = suite.eval_vs_opponent(spec, opponent, games, seed=seed, device=dev)
        checks = last["_match"][1][4]
        return res, int(checks.sum()), int(checks.max())

    before = read_launches()
    with derived_modes():
        warm, moves, turns = evaluate()
    per_eval = {k: v - before[k] for k, v in read_launches().items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(reps):
        n0 = kernel_launches()
        synchronize(dev)
        t0 = time.perf_counter()
        res, m, t = evaluate()
        synchronize(dev)
        runs.append(dict(seconds=time.perf_counter() - t0, result=res, moves=m, turns=t,
                         launches={k: v - n0[k] for k, v in kernel_launches().items()}))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    check(warm["illegal_action_rate"] == 0, f"the warm-up eval played illegal moves: {warm}")
    for i, r in enumerate(runs):
        check(r["result"]["illegal_action_rate"] == 0, f"rep {i} played illegal moves: {r}")
        check((r["moves"], r["turns"]) == (moves, turns),
              f"rep {i} played {r['moves']} moves in {r['turns']} turns, the warm-up {moves} in "
              f"{turns}")
        want = {k: 0 if k == "fused_actor_critic_prep" else per_eval[k] for k in r["launches"]}
        check(r["launches"] == want, f"rep {i} launched {r['launches']}, the warm-up {per_eval}")
    if dev.type == "cuda":
        check_route(f"search ({bot})", per_eval, fac.route(params.hidden))
        check(per_eval["fused_actor_critic_prep"] == 1,
              f"the bots' one handle prepared {per_eval['fused_actor_critic_prep']} times")
    else:  # the plain versions run on the CPU and launch nothing
        check(not any(per_eval.values()), f"a kernel counted a launch on the CPU: {per_eval}")
    check(per_eval["ring_take"] == 0, f"an eval launched kernel B {per_eval['ring_take']} times")
    seconds = [r["seconds"] for r in runs]
    rates = [moves / dt for dt in seconds]
    res = runs[-1]["result"]
    return {
        "search_moves_per_sec": max(rates),
        "mean": statistics.mean(rates),
        "median": statistics.median(rates),
        "per_rep": rates,
        "seconds_per_rep": seconds,
        "ms_per_move": min(seconds) / turns * 1e3,
        "turns_played": turns,
        "agent_moves": moves,
        "bot": bot,
        "label": label,
        "games": games,
        "seed": seed,
        "reps": reps,
        "win_rate": res["win_rate"],
        "win_rate_ci95": res["win_rate_ci95"],
        "avg_turns": res["avg_turns"],
        "illegal_action_rate": res["illegal_action_rate"],
        "privileged": res["privileged"],
        "peak_memory_bytes": peak,
        "launches_per_eval": per_eval,  # the warm-up's; each rep's the same without the prep
        "evals_counted": reps + 1,
        "hidden": params.hidden,
    }


# ---------------------------------------------------------------- the JSON line

def device_info(dev: torch.device):
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"nvidia_smi": smi[dev.index or 0], "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count()}


def host_info() -> dict:
    """The host's CPU (its model name, or vendor, family and model where the
    name reads "unknown"), core count, and the torch, CUDA and Python
    versions."""
    fields = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    cpu = fields.get("model name", "unknown")
    if cpu == "unknown":
        cpu = " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
                       if k in fields) or platform.machine()
    return {"cpu": cpu, "cores": os.cpu_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=("env", "update", "search"), default="env")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="env: the generator's seed (0); update: the TrainState's (the recipe's)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps (env 5, update 3, search 2)")
    ap.add_argument("--batch", type=int, default=32768, help="env: games in lockstep")
    ap.add_argument("--steps", type=int, default=400, help="env: steps a timed call")
    ap.add_argument("--naive-reset", action="store_true", help="env: full-batch reset, no ring")
    ap.add_argument("--slot", choices=tuple(SLOTS), default="static", help="update: league slot")
    ap.add_argument("--weights", choices=("committed", "random"), default="committed")
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--num-steps", type=int, default=None)
    ap.add_argument("--bot", choices=SEARCH_BOTS, default=None, help="search: the bot")
    ap.add_argument("--games", type=int, default=100, help="search: games an eval")
    args = ap.parse_args(argv)
    if args.workload == "search" and args.bot is None:
        ap.error(f"--workload search needs --bot, one of {', '.join(SEARCH_BOTS)}")
    dev = resolve_device(args.device)
    common = {"backend": dev.type, "device": device_info(dev), "host": host_info()}
    if args.workload == "env":
        seed = 0 if args.seed is None else args.seed
        r = bench_env_steps(args.batch, args.steps, args.reps or 5, args.naive_reset, dev, seed)
        value = r["steps_per_sec"]
        line = {
            "metric": "env_steps_per_sec_per_chip",
            "value": round(value, 1),
            "unit": "steps/s",
            "vs_baseline": round(value / BASELINE_STEPS_PER_SEC, 2),
            "mean": round(r["steps_per_sec_mean"], 1),
            "median": round(r["steps_per_sec_median"], 1),
            "per_rep": r["per_rep"],
            **common,
            "batch": r["batch"],
            "steps": r["scan_steps"],
            "reps": r["reps"],
            "episodes_finished_last_rep": r["episodes_finished_last_rep"],
            "ring_overflow": r["ring_overflow"],
            "ring_take_launches": r["ring_take_launches"],
            "seed": seed,
            "detail": "mask+sample+step+encode+autoreset"
            + (" (naive reset)" if args.naive_reset else " (ring reset)")
            + f", eager loop of {r['scan_steps']} steps a call, best of {r['reps']} reps "
            + f"(mean {r['steps_per_sec_mean']:,.0f}/s)",
        }
    elif args.workload == "search":
        r = bench_search(args.bot, args.games, args.reps or 2, dev)
        line = {
            "metric": "search_moves_per_sec",
            "value": round(r.pop("search_moves_per_sec"), 1),
            "unit": "agent moves/s",
            "mean": round(r.pop("mean"), 1),
            "median": round(r.pop("median"), 1),
            **common,
            **r,
            "detail": f"{r['label']} vs the greedy h768 net, eval_vs_opponent over {r['games']} "
            + f"games from seed {r['seed']}, best of {r['reps']} reps after a warm-up: "
            + f"{r['agent_moves']} agent moves in {r['turns_played']} turns",
        }
    else:
        r = bench_update(args.slot, args.weights, args.hidden, args.num_envs, args.num_steps,
                         args.reps or 3, dev, args.seed)
        line = {
            "metric": "agent_steps_per_sec",
            "value": round(r.pop("agent_steps_per_sec"), 1),
            "unit": "agent steps/s",
            "mean": round(r.pop("mean"), 1),
            "median": round(r.pop("median"), 1),
            **common,
            "slot": args.slot,
            "weights": args.weights,
            **r,
            "detail": f"league recipe update_step ({args.slot} slot, {args.weights} weights), "
            + f"update {r['update']['update']}, best of {len(r['per_rep'])} reps from one "
            + "saved state after a warm-up",
        }
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
