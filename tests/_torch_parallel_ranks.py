"""What the ranks of tests/test_torch_parallel.py run.

Each function runs on every rank of a gloo process group on the CPU and
returns numpy arrays and numbers to the test.  The ranks are started once
per world size by `splendax_torch.parallel.multihost.spawn` and `serve`
the test's calls until told to stop (`Fleet`), so the tests pay the ranks'
start-up once.  This module imports no JAX: the ranks load torch and the
port only; the test's own process holds the references.
"""

import multiprocessing
import os
import queue as queue_lib
import sys
import threading
import traceback

import numpy as np
import torch

from splendax_torch.engine import state as S
from splendax_torch.env import core
from splendax_torch.env import ring as ring_lib
from splendax_torch.models import actor_critic as ac
from splendax_torch.parallel import collectives
from splendax_torch.parallel import mesh as mesh_lib
from splendax_torch.parallel.multihost import is_coordinator, rank, spawn, world_size
from splendax_torch.selfplay.opponents import uniform_legal_action
from splendax_torch.train import ppo
from splendax_torch.train.checkpoint import CheckpointManager
from splendax_torch.train.config import PPOConfig


def params_np(model):
    """The whole params, gathered over tp, in `parameters()` order."""
    return [p.detach().numpy().copy() for p in ac.whole_model(model).parameters()]


def update(kw, dp, tp, n_updates=1):
    """`n_updates` updates on a dp x tp mesh."""
    cfg = PPOConfig(**kw, dp=dp, tp=tp)
    ts = ppo.init_train_state(cfg, device="cpu")
    for _ in range(n_updates):
        ts, metrics = ppo.update_step(cfg, ts)
    return {"params": params_np(ts.params), "metrics": {k: v.item() for k, v in metrics.items()},
            "count": ts.opt_state.count, "opp_idx": ts.opp_idx.numpy(),
            "dp_rank": ts.mesh.dp_rank, "shapes": [tuple(p.shape) for p in ts.params.parameters()]}


def rollout(kw, dp, tp):
    """One rollout on a dp x tp mesh: this rank's rows of it."""
    cfg = PPOConfig(**kw, dp=dp, tp=tp)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, traj = ppo.rollout(cfg, ts)
    out = {k: getattr(traj, k).numpy() for k in ("action", "reward", "done", "logp", "overflow")}
    return dict(out, games=ts.pool.games.numpy(), wins=ts.pool.wins.numpy(), obs=ts.obs.numpy(),
                opp_idx=ts.opp_idx.numpy(), dp_rank=ts.mesh.dp_rank)


def env_rows(n, plies, seed):
    """`step_autoreset_ring` on this rank's rows of n games, random legal
    actions from the global draws: every ply's obs, mask, reward and
    terminated, then the last state and the ring's counters."""
    mesh = mesh_lib.make_mesh(world_size())
    g = torch.Generator().manual_seed(seed)
    state, _, mask = core.reset(n, g, "cpu")
    state, mask = state.map(mesh.rows), mesh.rows(mask)
    ring = ring_lib.make_ring(2 * n, g, "cpu", window=n)
    lo, hi = mesh.row_range(n)
    rec = {"obs": [], "mask": [], "reward": [], "terminated": []}
    for _ in range(plies):
        action = uniform_legal_action(mask, u=torch.rand(n, generator=g)[lo:hi])
        state, out, obs, mask, ring = ring_lib.step_autoreset_ring(state, action, ring, mask=mask,
                                                                   mesh=mesh)
        for k, v in (("obs", obs), ("mask", mask), ("reward", out.reward),
                     ("terminated", out.terminated)):
            rec[k].append(v.numpy())
    return dict({k: np.stack(v) for k, v in rec.items()}, state=S.to_numpy(state),
                ptr=int(ring.ptr), overflow=int(ring.overflow))


def ring_take(packed, mask0, size, ptr, done):
    """`ring.take` of this rank's rows of `done` from a whole ring."""
    mesh = mesh_lib.make_mesh(world_size())
    ring = ring_lib.FreshGameRing(packed=torch.from_numpy(packed), mask0=torch.from_numpy(mask0),
                                  ptr=torch.tensor(ptr), overflow=torch.tensor(0), size=size)
    fresh, fresh_mask, ring = ring_lib.take(ring, mesh.rows(torch.from_numpy(done)), mesh)
    return {"state": S.to_numpy(fresh), "mask": fresh_mask.numpy(), "ptr": int(ring.ptr),
            "overflow": int(ring.overflow)}


def epochs(kw, flat, batch, perms, lr, ent_coef):
    """`_ppo_epochs` on dp = world size: this rank's rows of a turn-major
    [T, N] batch, the global permutations."""
    dp = world_size()
    cfg = PPOConfig(**kw, dp=dp)
    ts = ppo.init_train_state(cfg, params=ac.params_from_jax(flat, device="cpu"), device="cpu")
    n, lo, hi = cfg.num_envs, *ts.mesh.row_range(cfg.num_envs)
    mine = [torch.from_numpy(np.ascontiguousarray(x.reshape((-1, n) + x.shape[1:])[:, lo:hi]
                                                  .reshape((-1,) + x.shape[1:]))) for x in batch]
    ts, metrics = ppo._ppo_epochs(cfg, ts, mine, lr, ent_coef,
                                  perms=[torch.from_numpy(p).long() for p in perms])
    return {"params": params_np(ts.params), "mu": [m.numpy() for m in ts.opt_state.mu],
            "count": ts.opt_state.count, "metrics": {k: v.item() for k, v in metrics.items()}}


def tp_grads(flat, obs, kw_batch):
    """The loss and the whole gradients of `ppo_loss` on tp = world size
    shards (gathered), beside the whole model's on the same rows."""
    mesh = mesh_lib.make_mesh(1, world_size())
    cfg = PPOConfig()
    whole = ac.params_from_jax(flat, device="cpu")
    model = ac.params_from_jax(flat, device="cpu", mesh=mesh)
    rows = [torch.from_numpy(obs)] + [torch.from_numpy(kw_batch[k]) for k in
                                      ("mask", "action", "logp", "value", "adv", "ret")]
    loss, _ = ppo.ppo_loss(cfg, 0.01, model, *rows)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    whole_grads = [(g if d is None else collectives.all_gather_cat(g, mesh.tp_group, d)).numpy()
                   for g, d in zip(grads, model.shard_dims)]
    loss_w, _ = ppo.ppo_loss(cfg, 0.01, whole, *rows)
    grads_w = torch.autograd.grad(loss_w, list(whole.parameters()))
    logits = model(rows[0])[0].detach().numpy()
    return {"loss": loss.item(), "grads": whole_grads, "want_loss": loss_w.item(),
            "want_grads": [g.numpy() for g in grads_w], "logits": logits,
            "want_logits": whole(rows[0])[0].detach().numpy()}


def tp_handles(kw):
    """On a tp mesh: the pool's CURRENT handle after `set_current` from the
    sharded params (the tp gather, new tensors each rollout), prepared once
    for the rollout, after an in-place write to the shards once more; the
    frozen slots keep theirs.  Returns whether each buffer was the plain
    preparation of the whole weights, and the handles' preparations."""
    from splendax_torch.ops import fused_actor_critic as fac
    from splendax_torch.selfplay import pool as pool_lib

    cfg = PPOConfig(**kw, dp=1, tp=world_size())
    ts = ppo.init_train_state(cfg, device="cpu")
    pool = ts.pool
    for h in pool.slots:
        h.buffer()
    ok = []
    for step in range(2):
        with torch.no_grad():
            for p in ts.params.parameters():
                p.add_(0.01 * (step + 1))  # this rank's shards, in place
        whole = ac.kernel_weights(ts.params)  # gathered over tp
        pool = pool_lib.set_current(pool, ts.params)
        cur = pool.slot(pool.pool_size)
        ok.append(cur.stale() and not any(h.stale() for h in pool.slots[:-1]))
        for _ in range(3):  # the rollout's forwards
            ok.append(torch.equal(cur.buffer(), fac.prepare_weights_plain(whole)))
    return {"ok": ok, "preparations": [h.preparations for h in pool.slots],
            "sharded": ts.params.mesh is not None}


def train_cli(argv):
    """`train.train` through its flags on the CPU, the evals stubbed."""
    from splendax_torch.train import train

    cfg = train.parse_args(argv)
    auto = train._make_mesh_from_cfg(cfg.replace(dp=-1, tp=2)).shape
    ts = train.train(cfg, eval_fn=lambda params, seed: {}, device="cpu")
    return {"dp_tp": (cfg.dp, cfg.tp), "auto": auto, "update_idx": ts.update_idx,
            "mesh": ts.mesh.shape, "w0": tuple(ts.params.actor[0].weight.shape),
            "num_updates": cfg.num_updates, "params": params_np(ts.params)}


def resume(kw, dp, tp, log_dir):
    """3 uninterrupted updates, against 2, a checkpoint, a restore into a
    fresh sharded state, and 1 more."""
    cfg = PPOConfig(**kw, dp=dp, tp=tp)
    ts_a = ppo.init_train_state(cfg, device="cpu")
    for _ in range(3):
        ts_a, _ = ppo.update_step(cfg, ts_a)
    ts_b = ppo.init_train_state(cfg, device="cpu")
    for _ in range(2):
        ts_b, _ = ppo.update_step(cfg, ts_b)
    mgr = CheckpointManager(log_dir)
    mgr.save_checkpoint(ts_b)
    ts_c = mgr.restore_checkpoint(ppo.init_train_state(cfg, device="cpu"))
    ts_c, _ = ppo.update_step(cfg, ts_c)
    def leaves(ts):
        return params_np(ts.params) + [m.numpy() for m in ts.opt_state.mu + ts.opt_state.nu]

    return {"a": leaves(ts_a), "c": leaves(ts_c),
            "update_idx": ts_c.update_idx, "w0": tuple(ts_c.params.actor[0].weight.shape),
            "obs_equal": bool(torch.equal(ts_a.obs, ts_c.obs)),
            "gen_equal": bool(torch.equal(ts_a.generator.get_state(), ts_c.generator.get_state()))}


def default_mesh(kw, log_dir):
    """The default config (dp=0) in a multi-process run: a global mesh, one
    update, a checkpoint that the coordinator alone writes."""
    cfg = PPOConfig(**kw)
    ts = ppo.init_train_state(cfg, device="cpu")
    ts, metrics = ppo.update_step(cfg, ts)
    mgr = CheckpointManager(log_dir)
    latest, _ = mgr.save_checkpoint(ts)
    return {"mesh": ts.mesh.shape, "loss": metrics["loss"].item(), "writer": mgr.write,
            "coordinator": is_coordinator(), "saved": os.path.isfile(latest),
            "params": params_np(ts.params)}


def serve(inboxes, outbox):
    """Run each (function name, args) that arrives in this rank's inbox and
    send back (rank, "ok" or "error", result or traceback), until None."""
    me = rank()
    while (call := inboxes[me].get()) is not None:
        name, args = call
        try:
            outbox.put((me, "ok", getattr(sys.modules[__name__], name)(*args)))
        except Exception:  # reported to the test, which raises it
            outbox.put((me, "error", traceback.format_exc()))


class Fleet:
    """`world` ranks that stay up across calls: `call(fn, *args)` runs a
    function of this module on every rank and returns the results in rank
    order, raising any rank's traceback.  A call that times out leaves the
    fleet unusable (its ranks may wait in a collective): later calls raise."""

    def __init__(self, world: int, timeout: float = 300.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout, self.broken = world, timeout, None
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.thread = threading.Thread(target=spawn, args=(serve, world),
                                       kwargs=dict(args=(self.inboxes, self.outbox),
                                                   device="cpu", timeout=24 * 3600),
                                       daemon=True)
        self.thread.start()

    def call(self, fn, *args):
        if self.broken:
            raise RuntimeError(f"the fleet of {self.world} ranks broke earlier: {self.broken}")
        for box in self.inboxes:
            box.put((fn.__name__, args))
        got = {}
        try:
            for _ in range(self.world):
                r, status, value = self.outbox.get(timeout=self.timeout)
                got[r] = (status, value)
        except queue_lib.Empty:
            self.broken = f"{fn.__name__} gave no result within {self.timeout} s"
            raise RuntimeError(self.broken) from None
        errors = [f"rank {r}:\n{v}" for r, (st, v) in sorted(got.items()) if st == "error"]
        if errors:
            raise RuntimeError(f"{fn.__name__} failed:\n" + "\n".join(errors))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        if not self.broken:
            for box in self.inboxes:
                box.put(None)
            self.thread.join(timeout=60)
