"""The dp x tp mesh over ranks, and the training state's shards on it.

Counterpart of `splendax/parallel/mesh.py`, with two axes:

  * `dp`, data parallel: each rank keeps its rows of the game batch (the
    games, obs, mask and opponent slots); rollout and GAE are per row, and
    the learner all-reduces its gradients over the dp group;
  * `tp`, tensor parallel: each rank keeps its shards of the MLP weights
    and their Adam moments, column-parallel into the hidden dim and
    row-parallel out of it (`_param_spec`, the JAX package's classification
    by shape).

JAX places a global-view TrainState and lets GSPMD insert the collectives;
here each rank holds its shard and the port calls the collectives
(`collectives`).  Ranks are numbered dp-major: rank = dp_rank * tp +
tp_rank, as `make_mesh` lays JAX's devices out.  What stays whole on every
rank: the opponent pool (kernel A takes whole weights, so the rollout's
forwards run on weights gathered over tp once a rollout), the fresh-game
ring, the generator (every draw keeps its global shape and each rank takes
its rows) and the counters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.fused_actor_critic import ACT_DIM, OBS_DIM
from . import collectives
from .multihost import world_size


@dataclass(frozen=True, eq=False)
class Mesh:
    dp: int
    tp: int
    rank: int = 0
    dp_group: object = None  # this rank's dp group (same tp_rank); None when dp == 1
    tp_group: object = None  # this rank's tp group (same dp_rank); None when tp == 1
    world_group: object = None  # every rank; None in one process

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def row_range(self, n_global: int) -> tuple[int, int]:
        """[lo, hi): this rank's rows of a batch of `n_global` games."""
        if n_global % self.dp:
            raise ValueError(f"a batch of {n_global} does not split over dp={self.dp}")
        n = n_global // self.dp
        return self.dp_rank * n, (self.dp_rank + 1) * n

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a tensor in the global batch shape."""
        if self.dp == 1:
            return x
        lo, hi = self.row_range(x.shape[0])
        return x[lo:hi].clone()


def make_mesh(dp: int, tp: int = 1) -> Mesh:
    """The dp x tp mesh over every rank of the process group (or the 1 x 1
    mesh of one process).  Every rank must call it, in the same order as
    any other `make_mesh`: it creates the groups."""
    world = world_size()
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: both axes must be at least 1")
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world}")
    if dp * tp < world:
        raise ValueError(f"mesh {dp}x{tp} leaves {world - dp * tp} of {world} ranks "
                         f"without rows: every rank must belong to the mesh")
    if world == 1:
        return Mesh(dp=1, tp=1)
    me = dist.get_rank()
    dp_group = tp_group = None
    if dp > 1:
        for t in range(tp):  # every rank creates every group
            g = dist.new_group([d * tp + t for d in range(dp)])
            dp_group = g if t == me % tp else dp_group
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            tp_group = g if d == me // tp else tp_group
    return Mesh(dp=dp, tp=tp, rank=me, dp_group=dp_group, tp_group=tp_group,
                world_group=dist.group.WORLD)


def mesh_from_cfg(cfg) -> Mesh | None:
    """The mesh a PPOConfig asks for, or None for one process.

    A multi-process run always gets a mesh: without one each rank would
    train an independent copy.  `dp <= 0` fills the dp axis with world
    size / tp (`dp=0`, the default, only in a multi-process run)."""
    world = world_size()
    if cfg.dp == 0 and cfg.tp == 1 and world == 1:
        return None
    dp = cfg.dp if cfg.dp > 0 else max(1, world // cfg.tp)
    return make_mesh(dp=dp, tp=cfg.tp)


def _param_spec(shape) -> tuple:
    """Megatron-style TP spec by shape (JAX layout, [in, out]):
    column-parallel into the hidden dim, row-parallel out of it; biases
    follow their activation's sharding.  Classified against the fixed
    interface dims (OBS_DIM in, ACT_DIM or 1 out), as the JAX package's
    `_param_spec`, whose PartitionSpec it equals as a tuple."""
    if len(shape) == 2:
        d_in, _ = shape
        if d_in == OBS_DIM:
            return (None, "tp")  # input projection: column parallel
        return ("tp", None)  # hidden and output projections: row parallel
    if len(shape) == 1 and shape[0] not in (ACT_DIM, 1):
        return ("tp",)  # hidden-layer bias
    return ()


def torch_shard_dim(shape) -> int | None:
    """The dim of a torch parameter (nn.Linear layout, [out, in]) that tp
    shards, or None where it is replicated."""
    jax_shape = tuple(shape)[::-1]
    spec = _param_spec(jax_shape)
    if "tp" not in spec:
        return None
    return len(spec) - 1 - spec.index("tp")


def shard(x: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    """This rank's tp shard of a whole tensor (a copy)."""
    if dim is None or mesh.tp == 1:
        return x
    if x.shape[dim] % mesh.tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over tp={mesh.tp}")
    return x.chunk(mesh.tp, dim)[mesh.tp_rank].clone()


def train_state_shardings(ts, mesh: Mesh) -> dict:
    """The spec of every field of a `splendax_torch.train.ppo.TrainState`
    on `mesh`, as `_param_spec`'s tuples: ("dp", None) for the game rows,
    the tp spec of each parameter and Adam moment (JAX layout), () for what
    every rank holds whole."""
    H = ts.params.hidden
    params = {}
    for head, out in (("actor", ACT_DIM), ("critic", 1)):
        for j, (w, b) in enumerate((((OBS_DIM, H), (H,)), ((H, H), (H,)), ((H, out), (out,)))):
            params[f"{head}.{j}.w"], params[f"{head}.{j}.b"] = _param_spec(w), _param_spec(b)
    batched = ("dp", None)
    return {
        "params": params,
        "opt_state": {"mu": params, "nu": params, "count": ()},
        "pool": {"stack": (), "n_snapshots": (), "p_current": (), "wins": (), "games": ()},
        "env_state": {k: ("dp",) + (None,) * (v.dim() - 1) for k, v in ts.env_state.items()},
        "obs": batched, "mask": batched, "opp_idx": ("dp",),
        "generator": (), "update_idx": (), "global_step": (),
        "mesh": mesh.shape,
    }


def shard_train_state(ts, mesh: Mesh):
    """A whole TrainState (every rank holds the same) -> this rank's shard
    on `mesh`: its rows of the games, its tp shards of the params and the
    Adam moments.  The pool, generator and counters stay whole."""
    from ..models import actor_critic as ac
    from ..train import optim

    if ts.mesh is not None:
        raise ValueError("shard_train_state: the state is already sharded")
    dims = [torch_shard_dim(p.shape) for p in ts.params.parameters()]
    rows = mesh.rows
    return dataclasses.replace(
        ts,
        params=ac.shard_model(ts.params, mesh),
        opt_state=optim.AdamState(mu=[shard(m, d, mesh) for m, d in zip(ts.opt_state.mu, dims)],
                                  nu=[shard(v, d, mesh) for v, d in zip(ts.opt_state.nu, dims)],
                                  count=ts.opt_state.count),
        env_state=ts.env_state.map(rows), obs=rows(ts.obs), mask=rows(ts.mask),
        opp_idx=rows(ts.opp_idx), mesh=mesh,
    )


def unshard_train_state(ts):
    """The whole TrainState on every rank, gathered from the shards: params
    and moments over tp, game rows over dp.  A collective: every rank calls
    it."""
    from ..models import actor_critic as ac
    from ..train import optim

    mesh = ts.mesh
    if mesh is None:
        return ts
    dims = ts.params.shard_dims if mesh.tp > 1 else [None] * len(ts.opt_state.mu)

    def whole(x, d):
        return x if d is None else collectives.all_gather_cat(x, mesh.tp_group, d)

    def rows(x):
        return collectives.all_gather_cat(x, mesh.dp_group, 0)

    return dataclasses.replace(
        ts,
        params=ac.whole_model(ts.params),
        opt_state=optim.AdamState(mu=[whole(m, d) for m, d in zip(ts.opt_state.mu, dims)],
                                  nu=[whole(v, d) for v, d in zip(ts.opt_state.nu, dims)],
                                  count=ts.opt_state.count),
        env_state=ts.env_state.map(rows), obs=rows(ts.obs), mask=rows(ts.mask),
        opp_idx=rows(ts.opp_idx), mesh=None,
    )


def sharded_update(cfg, ts, mesh: Mesh | None = None):
    """One `update_step` with the TrainState on `mesh` (sharded here if it
    is whole).  The game batch must split evenly over dp."""
    from ..train import ppo

    if mesh is not None and ts.mesh is None:
        ts = shard_train_state(ts, mesh)
    return ppo.update_step(cfg, ts)
