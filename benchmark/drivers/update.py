"""Cells of kind "update": consecutive `train/ppo.update_step`s of a league
recipe from the committed nets, as a resumed training run makes them.

Set-up builds one TrainState (a frozen copy of `splendax_torch/bench.py`'s
`flagship_state` with its full pool: the agent, the configuration's frozen
slots, the agent in every other slot), seeded with `--seed`, at the
traffic's schedule index, and drives it through one update: the warm-up,
which builds and loads every kernel, prepares the pool's weights and uses
every shape of the window.  That same TrainState then runs the window: one
update an operation, no restore between updates, the pool's snapshot push
every 16 updates included.

The check follows two updates: the warm-up, from the committed nets, and
one of the window's, the second or the third, drawn from the seed (from
the traffic's start at 3,406 the first window update ends in a snapshot
push, so the pool that update leaves is in the followed one's).  While
they run, the benchmark's own wrappers around the program's functions keep
references to what the reference needs (the generator's state at each
draw, each turn's game state and the opponents' moves, the rollout, the
bootstrap, the advantages, the first three optimizer steps), and every
update before the followed one hands over, from the end of its epochs, the
parameters and the optimizer's state that the next update starts from.
Nothing is copied to the host inside the window.  Kernel A's launches in
the warm-up are held to the route and modes their shapes derive.  After
the window the reference follows both updates
(`reference/follow.check_update`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import random
import time

import torch

from splendax_torch.env import ring as ring_lib
from splendax_torch.models.actor_critic import import_params_npz
from splendax_torch.selfplay import dual
from splendax_torch.selfplay import pool as pool_lib
from splendax_torch.train import optim, ppo
from splendax_torch.train.config import PPOConfig

from .. import harness, yardstick
from ..harness import ROOT, log, patched, to_host
from ..reference import follow, learner
from . import launches


def recipe_of(cell: dict, small: dict | None = None) -> dict:
    """The configuration's recipe with the traffic's settings over it (and,
    in the CPU tests, `small`'s)."""
    return {**cell["config"]["recipe"], **cell["traffic"].get("recipe", {}), **(small or {})}


def logged_update(config: dict, recipe: dict, k: int) -> dict | None:
    """The committed run's log line of update `k` (its step count is logged
    after the update), checked as `bench.committed_update` checks it: the
    recipe's lr for `k` is the logged one and the logged approx-KL lies
    under the stop, so the run took every optimizer step.  None where the
    configuration has no log."""
    if not config.get("log"):
        return None
    step = (k + 1) * recipe["num_envs"] * recipe["num_steps"]
    with open(os.path.join(ROOT, config["log"])) as f:
        lines = [d for d in map(json.loads, f) if d.get("type") == "train" and d["step"] == step]
    if len(lines) != 1:
        raise RuntimeError(f"{config['log']} logs {len(lines)} train lines at update {k}")
    lr, _ = learner.anneal(recipe, k)
    line = lines[0]
    if not (lr > 0 and math.isclose(lr, line["lr"], rel_tol=1e-3)
            and line["approx_kl"] <= recipe["target_kl"]):
        raise RuntimeError(f"update {k}: lr {lr} against the log's {line['lr']}, approx_kl "
                           f"{line['approx_kl']} against the stop {recipe['target_kl']}")
    return {"lr": line["lr"], "approx_kl": line["approx_kl"]}


def pool_paths(config: dict, pool_size: int) -> list:
    """The npz of every pool slot: the frozen slots first, the agent in the
    rest and in CURRENT."""
    frozen = list(config.get("frozen_slots", []))[:pool_size]
    return frozen + [config["agent"]] * (pool_size + 1 - len(frozen))


def flagship_state(cfg: PPOConfig, config: dict, device):
    """The TrainState of a frozen copy of `bench.flagship_state` with a
    full pool."""
    agent = import_params_npz(os.path.join(ROOT, config["agent"]), device=device)
    ts = ppo.init_train_state(cfg, params=agent, device=device)
    pool = ts.pool
    for src in config.get("frozen_slots", []):
        pool = pool_lib.push_snapshot(pool, import_params_npz(os.path.join(ROOT, src),
                                                              device=device))
    while pool.filled < pool.pool_size:
        pool = pool_lib.push_snapshot(pool, agent)
    ts.pool = pool
    ts.opp_idx = ppo._sample_opponents(cfg, pool, ts.generator, cfg.num_envs)
    return ts




def _fields(state) -> dict:
    return dict(state.items())


class Run:
    kind = "update"

    def __init__(self, cell: dict, seed: int, device, small: dict | None = None):
        self.cell, self.device = cell, torch.device(device)
        small = dict(small or {})
        checked = small.pop("checked", None)  # a CPU test's window update
        self.recipe = recipe_of(cell, small)
        fields = {f.name for f in dataclasses.fields(PPOConfig)}
        self.cfg = PPOConfig(**{k: v for k, v in self.recipe.items() if k in fields}).replace(
            seed=seed)
        self.start = cell["traffic"]["start_update"]
        self.units = self.cfg.num_envs * self.cfg.num_steps
        self.log_line = logged_update(cell["config"], self.recipe, self.start) \
            if not small else None
        # The window update the check follows: the second or the third.
        self.checked = 1 + random.Random(seed).randrange(2) if checked is None else checked
        self.capture_s = 0.0
        self.steps, self.metrics = [], []
        self.cap, self.window_cap, self.handover, self.prev_end = None, None, {}, None

    def build_kernels(self) -> float:
        return harness.build_kernels(self.device)

    def sync(self) -> None:
        harness.synchronize(self.device)

    def warm(self) -> None:
        """Load the nets, build the state and run the warm-up update with
        the capture and the launch checks."""
        cfg = self.cfg
        ts = flagship_state(cfg, self.cell["config"], self.device)
        self.pool_filled = ts.pool.filled
        self.n_snapshots0 = ts.pool.n_snapshots
        ts = dataclasses.replace(ts, update_idx=self.start, global_step=self.start * self.units)
        cap = {"turns": [], "update_idx": self.start}
        derived, before = {}, launches.counters()
        with self._capture(cap), self._handover(self.start), launches.derived_modes(derived):
            ts, _ = ppo.update_step(cfg, ts)
        self.sync()
        n = {k: v - before[k] for k, v in launches.counters().items()}
        if self.device.type == "cuda":
            for problem in launches.route_problems(n, derived, cfg.hidden):
                log("bench: launch check:", problem)
            log("bench: warm-up update launches", json.dumps(n))
        t0 = time.perf_counter()
        self.cap = to_host(cap)
        self.capture_s = time.perf_counter() - t0
        self.ts = ts

    @contextlib.contextmanager
    def _handover(self, update_idx: int):
        """Keep, from the end of this update's epochs, the parameters and the
        optimizer's state (device copies of a few MB), and references to the
        game state its rollout ended in: what the next update starts from."""

        def on_rollout(orig):
            def rollout(cfg, ts):
                ts2, traj = orig(cfg, ts)
                self.prev_end = {"state": _fields(ts2.env_state), "obs": ts2.obs,
                                 "mask": ts2.mask, "opp_idx": ts2.opp_idx}
                return ts2, traj
            return rollout

        def on_epochs(orig):
            def epochs(cfg, ts, batch, lr, ent_coef_now, perms=None):
                ts2, metrics = orig(cfg, ts, batch, lr, ent_coef_now, perms)
                st = ts2.opt_state
                self.handover[update_idx] = {
                    "params": [p.detach().clone() for p in ts2.params.parameters()],
                    "mu": [m.clone() for m in st.mu], "nu": [v.clone() for v in st.nu],
                    "count": st.count}
                return ts2, metrics
            return epochs

        with patched(ppo, "rollout", on_rollout), patched(ppo, "_ppo_epochs", on_epochs):
            yield

    @contextlib.contextmanager
    def _capture(self, cap: dict):
        """The wrappers that keep what the reference follows."""

        def on_rollout(orig):
            def rollout(cfg, ts):
                cap["gen_rollout"] = ts.generator.get_state().clone()
                ts2, traj = orig(cfg, ts)
                cap["traj"] = {k: getattr(traj, k) for k in
                               ("obs", "mask", "action", "logp", "value", "reward", "done")}
                cap["end"] = {"state": _fields(ts2.env_state), "obs": ts2.obs, "mask": ts2.mask,
                              "opp_idx": ts2.opp_idx}
                return ts2, traj
            return rollout

        def on_make_ring(orig):
            def make_ring(*args, **kw):
                ring = orig(*args, **kw)
                cap["ring_packed"] = ring.packed
                return ring
            return make_ring

        def on_turn(orig):
            def rollout_turn(cfg, weights, pool, env_state, obs, mask, opp_idx, ring, **kw):
                rec = {"gen": kw["generator"].get_state().clone(), "state": _fields(env_state),
                       "opp_idx": opp_idx}
                turn = orig(cfg, weights, pool, env_state, obs, mask, opp_idx, ring, **kw)
                rec["opp_action"] = turn.opp_action
                cap["turns"].append(rec)
                return turn
            return rollout_turn

        def on_gae(orig):
            def gae(cfg, traj, last_value):
                cap["last_value"] = last_value
                return orig(cfg, traj, last_value)
            return gae

        def on_epochs(orig):
            def epochs(cfg, ts, batch, lr, ent_coef_now, perms=None):
                cap["epochs"] = {
                    "gen": ts.generator.get_state().clone(),
                    "adv": batch[5], "ret": batch[6], "losses": [], "approx_kl": [],
                    "params0": [p.detach().clone() for p in ts.params.parameters()],
                    "mu0": [m.clone() for m in ts.opt_state.mu]}
                return orig(cfg, ts, batch, lr, ent_coef_now, perms)
            return epochs

        def on_loss(orig):
            def loss(*args, **kw):
                out = orig(*args, **kw)
                ep = cap["epochs"]
                if len(ep["losses"]) < 3:
                    ep["losses"].append(out[0].detach())
                    ep["approx_kl"].append(out[1][3].detach())
                return out
            return loss

        def on_step(orig):
            calls = [0]

            def step(params, grads, state, lr, **kw):
                out = orig(params, grads, state, lr, **kw)
                calls[0] += 1
                if calls[0] == 1:
                    cap["epochs"]["mu1"] = [m.clone() for m in state.mu]
                if calls[0] == 3:
                    cap["epochs"]["params3"] = [p.detach().clone() for p in params]
                return out
            return step

        with contextlib.ExitStack() as stack:
            for obj, name, make in ((ppo, "rollout", on_rollout), (ring_lib, "make_ring",
                                                                  on_make_ring),
                                    (ppo, "rollout_turn", on_turn), (ppo, "_gae", on_gae),
                                    (ppo, "_ppo_epochs", on_epochs), (ppo, "ppo_loss", on_loss),
                                    (optim, "step", on_step)):
                stack.enter_context(patched(obj, name, make))
            yield

    def op(self) -> int:
        """One update; returns its agent steps."""
        i = len(self.steps)
        update_idx = self.ts.update_idx
        if i < self.checked:
            keep = self._handover(update_idx)
        elif i == self.checked:
            self.window_cap = {"turns": [], "update_idx": update_idx, "prev_end": self.prev_end}
            keep = self._capture(self.window_cap)
        else:
            keep = contextlib.nullcontext()
        count = self.ts.opt_state.count
        with keep:
            self.ts, metrics = ppo.update_step(self.cfg, self.ts)
        self.sync()
        self.steps.append(self.ts.opt_state.count - count)
        self.metrics.append(metrics)
        return self.units

    def finish(self) -> None:
        """Run, after a window too short to hold it, the update the check
        follows (a short trial's window; a cell's window of run_seconds
        holds it)."""
        while self.window_cap is None:
            log("bench: the window ended before the followed update; running it after")
            self.op()

    @contextlib.contextmanager
    def spans(self, spans):
        """The layers' spans: the rollout, the dual step with the opponents
        inside it, the opponents' policy (the pool's slots and the league
        slot's search), GAE and the epochs."""

        def on_policy(orig):
            def opponent_policy(*args, **kw):
                return spans.wrap(orig(*args, **kw), "opponent")
            return opponent_policy

        with contextlib.ExitStack() as stack:
            for obj, name, span in ((ppo, "rollout", "rollout"), (ppo, "_gae", "gae"),
                                    (ppo, "_ppo_epochs", "epochs"),
                                    (dual, "dual_step_autoreset_ring", "dual_step")):
                stack.enter_context(patched(obj, name, lambda f, s=span: spans.wrap(f, s)))
            stack.enter_context(patched(ppo, "_opponent_policy", on_policy))
            yield

    def work(self, op_index: int) -> yardstick.Work:
        return yardstick.update_work(self.recipe, self.cap_search_rows(), self.steps[op_index])

    def cap_search_rows(self) -> int:
        cfg = self.cfg
        return cfg.n_search_static if cfg.search_opponent and cfg.search_static else 0

    def failed_ops(self) -> int:
        """Window updates whose metrics are not all finite."""
        return sum(not all(math.isfinite(float(v)) for v in m.values()) for m in self.metrics)

    def info(self) -> dict:
        return {"start_update": self.start, "logged": self.log_line,
                "optimizer_steps": self.steps, "checked_window_update": self.checked,
                "warm_up_losses": [float(x) for x in self.cap["epochs"]["losses"]],
                "warm_up_approx_kl": [float(x) for x in self.cap["epochs"]["approx_kl"]]}

    def release(self) -> None:
        del self.ts
        self.metrics = []

    def check(self, controls=(), faults=()) -> dict:
        cfg = self.cfg
        updates = [self.cap, to_host(self.window_cap)]
        handover = to_host(self.handover)
        self.window_cap = self.handover = self.prev_end = None
        for u in updates:
            ep = u["epochs"]
            if len(ep.get("losses", [])) < 3 or "params3" not in ep:
                raise RuntimeError(f"update {u['update_idx']} took fewer than three optimizer "
                                   "steps")
            ep["losses"] = [float(x) for x in ep["losses"]]
            ep["approx_kl"] = [float(x) for x in ep["approx_kl"]]
        cap = dict(recipe=self.recipe, updates=updates, handover=handover, start=self.start,
                   agent=os.path.join(ROOT, self.cell["config"]["agent"]),
                   slots=[os.path.join(ROOT, p) for p in pool_paths(self.cell["config"],
                                                                    cfg.pool_size)],
                   search_rows=self.cap_search_rows(), search_stride=cfg.search_stride,
                   pool_filled=self.pool_filled, n_snapshots0=self.n_snapshots0, seed=cfg.seed)
        return follow.check_update(cap, self.device, controls, faults)
