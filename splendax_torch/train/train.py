"""Masked-PPO self-play training driver (CLI).

Counterpart of `splendax/train/train.py`, with the same flags and cadence:
the configuration written to `config.json`, an initial evaluation, a
checkpoint every `checkpoint_every_updates`, the eval suite with summary
plots every `eval_every_updates`, and at the end a final checkpoint and the
params as `ppo_splendor_params.npz`.  Checkpoints are resumable.

It runs on one GPU, or on a dp x tp mesh of ranks (`--dp`, `--tp`;
`parallel.mesh`) started by torchrun: every rank trains its shard, and only
the coordinator (rank 0) writes logs, plots, `config.json`, checkpoints and
the npz and runs the evals, on weights gathered whole.

Run: python -m splendax_torch.train.train --total-timesteps 1000000 ...
     torchrun --nproc-per-node 2 -m splendax_torch.train.train --dp 2 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from .. import trace
from ..eval.suite import run_evaluation_suite
from ..models.actor_critic import whole_model
from ..parallel import mesh as mesh_lib
from ..parallel.multihost import (init_multihost, is_coordinator, local_device, rank,
                                  world_size)
from .checkpoint import CheckpointManager, export_params_npz
from .config import PPOConfig
from .logging_utils import TrainingLogger
from . import ppo


def parse_args(argv=None) -> PPOConfig:
    p = argparse.ArgumentParser(description="splendax_torch masked PPO self-play")
    # Reference flags (ppo_splendor.py:69-99).
    p.add_argument("--total-timesteps", type=int, default=1_000_000)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--ent-coef", type=float, default=0.03)
    p.add_argument("--vf-coef", type=float, default=0.5)
    p.add_argument("--clip-coef", type=float, default=0.2)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--minibatch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--track", action="store_true", help="log to tensorboard")
    p.add_argument("--log-dir", type=str, default="runs/ppo_splendor")
    p.add_argument("--eval-every-updates", type=int, default=10)
    p.add_argument("--eval-games", type=int, default=400)
    p.add_argument("--lr-anneal", action="store_true")
    p.add_argument("--train-opponent", type=str, default="basic",
                   choices=["random", "greedy_v1", "basic"])
    p.add_argument("--self-play", dest="self_play", action="store_true", default=True)
    p.add_argument("--no-self-play", dest="self_play", action="store_false")
    p.add_argument("--pool-size", type=int, default=12)
    p.add_argument("--snapshot-every-updates", type=int, default=10)
    p.add_argument("--p-current", type=float, default=0.25)
    p.add_argument("--target-kl", type=float, default=0.02)
    p.add_argument("--vclip", type=float, default=0.2)
    p.add_argument("--ent-coef-final", type=float, default=0.01)
    # splendax extras.
    p.add_argument("--hidden", type=int, default=256,
                   help="MLP hidden width (256 = reference architecture)")
    p.add_argument("--rng-mode", type=str, default="fast", choices=["fast", "parity"])
    p.add_argument("--reference-entropy-quirk", action="store_true",
                   help="reproduce the reference's entropy-penalty loss sign")
    p.add_argument("--checkpoint-every-updates", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from <log_dir>/ppo_splendor_latest.pt")
    p.add_argument("--profile-updates", type=int, default=0,
                   help="capture a torch.profiler trace of this many updates, with "
                        "the program's spans on the same timeline, into "
                        "<log_dir>/profile/trace.json (a Chrome trace)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis: shard the env batch over "
                        "this many devices (0 = single device, -1 = all/tp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (megatron-style MLP shard)")
    p.add_argument("--opponent-sampling", type=str, default="uniform",
                   choices=["uniform", "pfsp"],
                   help="pool sampling: uniform (reference semantics) or "
                        "pfsp (prioritize snapshots the agent still loses to)")
    p.add_argument("--search-opponent", action="store_true",
                   help="league slot: with --p-search probability an episode "
                        "faces the CURRENT snapshot wrapped in a cheap "
                        "on-device Gumbel search (train/config.py notes)")
    p.add_argument("--p-search", type=float, default=0.125)
    p.add_argument("--search-m", type=int, default=8)
    p.add_argument("--search-k0", type=int, default=4)
    p.add_argument("--search-horizon", type=int, default=2)
    p.add_argument("--search-static", action="store_true",
                   help="pin the league slot to a static strided set of "
                        "round(p_search*num_envs) env rows (every "
                        "search_stride-th, dp-shard-even) and run the "
                        "search on that static slice only (~1/p_search "
                        "cheaper; see train/config.py `search_static`)")
    p.add_argument("--search-censored", action="store_true",
                   help="information-fair league slot: the sentinel search "
                        "runs in information-set mode "
                        "(determinization) instead of x-raying hidden state; "
                        "consider raising --search-k0")
    p.add_argument("--wandb-project-name", type=str, default=None,
                   help="enable wandb tracking into this project (the "
                        "reference's third channel, ppo_cleanRL.py:29-31; "
                        "degrades gracefully if wandb is not installed)")
    p.add_argument("--wandb-entity", type=str, default=None)
    a = p.parse_args(argv)
    return PPOConfig(
        total_timesteps=a.total_timesteps, num_envs=a.num_envs, num_steps=a.num_steps,
        gamma=a.gamma, gae_lambda=a.gae_lambda, lr=a.lr, ent_coef=a.ent_coef,
        vf_coef=a.vf_coef, clip_coef=a.clip_coef, update_epochs=a.update_epochs,
        minibatch_size=a.minibatch_size, seed=a.seed, track=a.track,
        log_dir=a.log_dir, eval_every_updates=a.eval_every_updates,
        eval_games=a.eval_games, lr_anneal=a.lr_anneal,
        train_opponent=a.train_opponent, self_play=a.self_play,
        pool_size=a.pool_size, snapshot_every_updates=a.snapshot_every_updates,
        p_current=a.p_current, target_kl=a.target_kl, vclip=a.vclip,
        ent_coef_final=a.ent_coef_final, hidden=a.hidden, rng_mode=a.rng_mode,
        reference_entropy_quirk=a.reference_entropy_quirk,
        checkpoint_every_updates=a.checkpoint_every_updates, resume=a.resume,
        profile_updates=a.profile_updates, dp=a.dp, tp=a.tp,
        opponent_sampling=a.opponent_sampling,
        search_opponent=a.search_opponent, p_search=a.p_search,
        search_m=a.search_m, search_k0=a.search_k0,
        search_horizon=a.search_horizon, search_static=a.search_static,
        search_censored=a.search_censored,
        wandb_project=a.wandb_project_name, wandb_entity=a.wandb_entity,
    )


def _make_mesh_from_cfg(cfg: PPOConfig):
    """The dp x tp mesh `cfg` asks for, or None for one process
    (`parallel.mesh.mesh_from_cfg`: a multi-process run always gets one, and
    dp=-1 fills the dp axis with world size / tp)."""
    return mesh_lib.mesh_from_cfg(cfg)


def train(cfg: PPOConfig, eval_fn=None, device="cuda") -> ppo.TrainState:
    # A no-op unless started by torchrun (or the process group is up
    # already); then every rank runs this function on its shard.
    init_multihost(device=device)
    coord = is_coordinator()
    device = local_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[device] torch {torch.__version__} on {device}: {name}, "
          f"rank {rank()} of {world_size()}")
    ppo._check_supported(cfg)
    ts = ppo.init_train_state(cfg, device=device)  # on the mesh cfg asks for
    if ts.mesh is not None:
        print(f"[mesh] dp={ts.mesh.dp} tp={ts.mesh.tp} ({ts.mesh.size} ranks); env batch "
              f"split over dp, MLP hidden over tp")

    logger = TrainingLogger(cfg.log_dir, track=cfg.track, write=coord,
                            wandb_project=cfg.wandb_project, wandb_entity=cfg.wandb_entity,
                            config=dataclasses.asdict(cfg))
    # The timestamped checkpoint names must agree on every rank: the
    # coordinator's clock decides.
    if world_size() > 1:
        run_ts = [logger.run_start_ts]
        dist.broadcast_object_list(run_ts, src=0)
        logger.run_start_ts = run_ts[0]
    ckpt = CheckpointManager(cfg.log_dir, logger.run_start_ts)
    if coord:
        # The exact configuration of every run, so each run describes itself.
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, sort_keys=True)
    eval_fn = eval_fn or (
        lambda params, seed: run_evaluation_suite(params, cfg.eval_games, seed, device=device)
    )

    if cfg.resume and ckpt.has_checkpoint():
        ts = ckpt.restore_checkpoint(ts)
        print(f"[resume] restored update {ts.update_idx}")

    start_update = ts.update_idx
    num_updates = cfg.num_updates
    if coord:
        print(f"[train] {num_updates} updates x {cfg.batch_size} turns"
              f" ({cfg.num_envs} envs x {cfg.num_steps} steps), self_play={cfg.self_play}")

    def evaluate(update):
        """The eval suite's results on the coordinator (None elsewhere), on
        weights every rank helps gather."""
        params = whole_model(ts.params)
        return eval_fn(params, update) if coord else None

    if start_update == 0 and coord:
        print("Running initial evaluation...")
    results = evaluate(0) if start_update == 0 else None
    if results is not None:
        logger.log_evaluation_results(results, 0)
        logger.update_history(0, results, cfg.lr, 0.0, 0.0, 0.0)
        logger.create_summary_plot(0)
        for name, res in results.items():
            print(f"  vs {name}: wr={res['win_rate']:.3f}±{res['win_rate_ci95']:.3f}")

    if cfg.profile_updates > 0 and start_update == 0:
        # One update outside the trace as a warm-up, then N traced ones.
        from torch.profiler import ProfilerActivity, profile

        ts, _ = ppo.update_step(cfg, ts)
        trace_dir = os.path.join(cfg.log_dir, "profile")
        if coord:
            os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof, trace.recording() as spans:
            for _ in range(cfg.profile_updates):
                ts, _ = ppo.update_step(cfg, ts)
            _sync(device)
        if coord:
            path = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(path)
            _add_spans(path, spans)
            print(f"[profile] wrote {cfg.profile_updates}-update trace to {trace_dir}")

    t0 = time.time()
    steps_done = 0

    # Metrics are flushed one update late, through a single transfer: the
    # host reads update k's scalars while update k+1 is already queued,
    # instead of waiting on each scalar in turn.  The logged data is the same.
    pending = None  # (update index, device metrics dict)
    m = {}

    def flush():
        nonlocal pending, m
        if pending is None:
            return
        upd, dev_metrics = pending
        pending = None
        keys = list(dev_metrics)
        values = trace.sync("train.metrics",
                            torch.stack([dev_metrics[k].to(torch.float64) for k in keys]).tolist)
        m = dict(zip(keys, values))
        logger.log_training_metrics(
            (upd + 1) * cfg.batch_size, m["lr"], m["pg_loss"], m["v_loss"],
            m["entropy"], m["approx_kl"],
            extra={"rollout_win_rate": m["rollout_win_rate"], "episodes": m["episodes"]},
        )

    for update in range(start_update, num_updates):
        ts, metrics = ppo.update_step(cfg, ts)
        steps_done += cfg.batch_size
        flush()  # the previous update's metrics
        pending = (update, metrics)
        global_step = (update + 1) * cfg.batch_size

        if (update + 1) % max(1, cfg.checkpoint_every_updates) == 0:
            flush()
            ckpt.save_checkpoint(ts)

        if (update + 1) % cfg.eval_every_updates == 0:
            flush()
            _sync(device)
            sps = steps_done / max(1e-9, time.time() - t0)
            results = evaluate(update + 1)
            if coord:
                print(f"update={update+1}/{num_updates} SPS(turns)={sps:,.0f}"
                      f" kl={m['approx_kl']:.4f} pg={m['pg_loss']:.4f}"
                      f" v={m['v_loss']:.4f} ent={m['entropy']:.3f}")
                logger.log_evaluation_results(results, global_step)
                logger.update_history(global_step, results, m["lr"],
                                      m["pg_loss"], m["v_loss"], m["entropy"])
                logger.create_summary_plot(global_step)
                for name, res in results.items():
                    print(f"  vs {name}: "
                          f"wr={res['win_rate']:.3f}±{res['win_rate_ci95']:.3f}"
                          f" turns={res['avg_turns']:.1f}")
            ckpt.save_checkpoint(ts, step=global_step)
    flush()

    latest, ts_path = ckpt.save_checkpoint(ts)
    params = whole_model(ts.params)
    if coord:
        export_params_npz(params, os.path.join(cfg.log_dir, "ppo_splendor_params.npz"))
        print(f"Saved final {latest} and {ts_path}")
    logger.close()
    return ts


def _add_spans(path: str, spans: list) -> None:
    """Add the program's `spans` (`trace.recording()`'s) to the profiler's
    Chrome trace at `path`, on the profiler's clock: its events' `ts` are
    microseconds from its `baseTimeNanoseconds`, as are theirs."""
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(trace.chrome_events(doc.get("baseTimeNanoseconds", 0), spans))
    with open(path, "w") as f:
        json.dump(doc, f)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
