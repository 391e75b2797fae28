"""Checkpoints: save and resume the whole training state.

Counterpart of `splendax/train/checkpoint.py`.  A checkpoint is one
`torch.save` file, `<log_dir>/<name>_latest.pt`, plus a timestamped copy
under `<log_dir>/checkpoints/`: the parameters, the optimizer state, the
opponent pool, the 18 game-state fields with obs, mask and opponent slots,
the generator's state and the counters.  The `.pt` name keeps it apart from
a checkpoint directory of the JAX package in the same `log_dir`.

`export_params_npz` writes the parameters alone in the JAX package's npz key
layout, which both packages load.

On a dp x tp mesh (the counterpart of `gather_to_host` in
`splendax/train/checkpoint.py`) saving is a collective: every rank gathers
the whole state (params and Adam moments over tp, the game rows over dp)
and only the coordinator writes the file, which is the same file a single
process writes.  Restoring loads it on every rank and takes each rank's
shard again.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..engine.state import GameState
from ..models.actor_critic import export_params_npz  # noqa: F401  (the JAX package exports it here)
from ..parallel import mesh as mesh_lib
from ..parallel.multihost import is_coordinator, world_size
from . import optim


def state_dict(ts) -> dict:
    """The TrainState as nested dicts and lists of CPU tensors and numbers
    (on a mesh a collective: the whole state, gathered)."""
    ts = mesh_lib.unshard_train_state(ts)
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    return {
        "params": {k: cpu(v) for k, v in ts.params.state_dict().items()},
        "opt_state": {"mu": [cpu(m) for m in ts.opt_state.mu],
                      "nu": [cpu(v) for v in ts.opt_state.nu],
                      "count": ts.opt_state.count},
        "pool": {"stack": [cpu(w) for w in ts.pool.stack],
                 "n_snapshots": ts.pool.n_snapshots,
                 "wins": cpu(ts.pool.wins), "games": cpu(ts.pool.games)},
        "env_state": {k: cpu(v) for k, v in ts.env_state.items()},
        "obs": cpu(ts.obs),
        "mask": cpu(ts.mask),
        "opp_idx": cpu(ts.opp_idx),
        "generator": ts.generator.get_state(),
        "update_idx": ts.update_idx,
        "global_step": ts.global_step,
    }


def load_state_dict(ts, saved: dict):
    """Overlay `saved` on the freshly initialised `ts`: every field the file
    holds replaces the fresh one (on the fresh one's device); a field the
    file lacks (one added after it was written) keeps its fresh value.  A
    sharded `ts` is gathered first and the result sharded again, on its
    mesh."""
    mesh = ts.mesh
    if mesh is not None:
        whole = load_state_dict(mesh_lib.unshard_train_state(ts), saved)
        return mesh_lib.shard_train_state(whole, mesh)

    def put(fresh, saved_tensor):
        return fresh if saved_tensor is None else saved_tensor.to(fresh.device)

    def put_list(fresh, saved_list):
        return [put(f, s) for f, s in zip(fresh, saved_list or [None] * len(fresh))]

    def put_dict(fresh_items, saved_dict):
        return {k: put(f, saved_dict.get(k)) for k, f in fresh_items}

    if "params" in saved:
        ts.params.load_state_dict(saved["params"])
    if "generator" in saved:
        # A CPU and a CUDA generator keep states of different sizes: a file
        # written on one kind of device restores on the other with the fresh
        # state's random stream (everything else is laid over as usual).
        if saved["generator"].numel() == ts.generator.get_state().numel():
            ts.generator.set_state(saved["generator"])
        else:
            print("[restore] the file's generator state is another device kind's; "
                  "the random stream starts afresh")
    opt, pool = saved.get("opt_state", {}), saved.get("pool", {})
    top = put_dict([(k, getattr(ts, k)) for k in ("obs", "mask", "opp_idx")], saved)
    return dataclasses.replace(
        ts,
        opt_state=optim.AdamState(mu=put_list(ts.opt_state.mu, opt.get("mu")),
                                  nu=put_list(ts.opt_state.nu, opt.get("nu")),
                                  count=opt.get("count", ts.opt_state.count)),
        pool=ts.pool.replace(
            stack=put_list(ts.pool.stack, pool.get("stack")),
            n_snapshots=pool.get("n_snapshots", ts.pool.n_snapshots),
            **put_dict([("wins", ts.pool.wins), ("games", ts.pool.games)], pool)),
        env_state=GameState(**put_dict(ts.env_state.items(), saved.get("env_state", {}))),
        update_idx=saved.get("update_idx", ts.update_idx),
        global_step=saved.get("global_step", ts.global_step),
        **top,
    )


class CheckpointManager:
    """Saves and restores TrainStates under `log_dir`; in a multi-process
    run only the coordinator writes, and every rank waits for the file."""

    def __init__(self, log_dir: str, run_ts: Optional[str] = None, name: str = "ppo_splendor"):
        self.log_dir = os.path.abspath(log_dir)
        self.name = name
        self.run_ts = run_ts or time.strftime("%Y%m%d_%H%M%S")
        self.write = is_coordinator()
        if self.write:
            os.makedirs(os.path.join(self.log_dir, "checkpoints"), exist_ok=True)

    @property
    def latest_path(self) -> str:
        return os.path.join(self.log_dir, f"{self.name}_latest.pt")

    def save_checkpoint(self, train_state, step: Optional[int] = None) -> Tuple[str, str]:
        """Write `<name>_latest.pt` and a timestamped copy under checkpoints/."""
        ts_path = os.path.join(
            self.log_dir, "checkpoints",
            f"{self.name}_{self.run_ts}" + (f"_{step}" if step is not None else "") + ".pt",
        )
        saved = state_dict(train_state)  # a collective on a mesh
        if self.write:
            tmp = self.latest_path + ".tmp"
            torch.save(saved, tmp)
            os.replace(tmp, self.latest_path)  # never leaves a half-written latest
            shutil.copyfile(self.latest_path, ts_path)
        if world_size() > 1:
            dist.barrier()  # no rank reads the file before it is whole
        return self.latest_path, ts_path

    def restore_checkpoint(self, fresh_state, path: Optional[str] = None):
        """The TrainState of the file at `path` (default: the latest),
        laid over `fresh_state`, a freshly initialised state of the same
        configuration."""
        saved = torch.load(path or self.latest_path, map_location="cpu", weights_only=True)
        return load_state_dict(fresh_state, saved)

    def has_checkpoint(self) -> bool:
        return os.path.isfile(self.latest_path)
