"""The actor-critic network: two MLPs 297 -> H -> H -> {45 logits, 1 value}.

Counterpart of `splendax/models/actor_critic.py`.  `ActorCritic` is an
`nn.Module` whose `forward` is the plain PyTorch path; the rollout runs the
fused kernel (`ops.fused_actor_critic`) on `kernel_weights(model)`, the same
weights in the JAX package's [in, out] layout.  The initialisation is
uniform +-1/sqrt(fan_in) for weights and biases, as the JAX package's
`_linear_init` and torch's `nn.Linear` default both draw.

Under tensor parallelism (`shard_model`) each rank's layers hold its shards
of the weights, as `parallel.mesh._param_spec` assigns them: the first
layer column-parallel, the second and the heads row-parallel.  The forward
then runs Megatron-style, with one reduce-scatter between the hidden layers
and one all-reduce of each head's output (`parallel.collectives`).  Kernel A
takes whole weights, so `kernel_weights` of a sharded model gathers them
over the tp group (`gather_full_weights`).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.fused_actor_critic import ACT_DIM, OBS_DIM, masked_logits
from ..parallel import collectives
from ..parallel.mesh import shard, torch_shard_dim

HEADS = ("actor", "critic")


def _mlp(hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(OBS_DIM, hidden), nn.Tanh(),
        nn.Linear(hidden, hidden), nn.Tanh(),
        nn.Linear(hidden, out),
    )


class ActorCritic(nn.Module):
    def __init__(self, hidden: int = 256, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.hidden = hidden
        self.actor = _mlp(hidden, ACT_DIM).to(device)
        self.critic = _mlp(hidden, 1).to(device)
        # Set by `shard_model`: the layers then hold this rank's tp shards.
        self.mesh = None
        self.shard_dims = None  # per parameter, the dim tp shards (None: whole)
        if generator is not None:
            with torch.no_grad():
                for layer in self.linears():
                    bound = 1.0 / math.sqrt(layer.in_features)
                    nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
                    nn.init.uniform_(layer.bias, -bound, bound, generator=generator)

    def linears(self):
        """The six Linear layers: actor 0..2, then critic 0..2."""
        return [m for head in (self.actor, self.critic) for m in head if isinstance(m, nn.Linear)]

    def forward(self, obs: torch.Tensor):
        """obs [B, 297] -> (logits [B, 45], value [B]), in the weights' dtype
        (float32, or float64 after `.double()` for a reference)."""
        x = obs.to(self.actor[0].weight.dtype)
        if self.mesh is not None:
            group = self.mesh.tp_group
            return _tp_head(self.actor, x, group), _tp_head(self.critic, x, group)[:, 0]
        return self.actor(x), self.critic(x)[:, 0]


def _tp_head(head: nn.Sequential, x: torch.Tensor, group) -> torch.Tensor:
    """One MLP on this rank's shards: column-parallel into the hidden dim,
    the partial sums of the second layer reduce-scattered back to this
    rank's hidden columns, the head's partial output all-reduced."""
    l0, l1, l2 = head[0], head[2], head[4]
    h = torch.tanh(F.linear(x, l0.weight, l0.bias))
    h = torch.tanh(collectives.reduce_scatter_fwd(F.linear(h, l1.weight), group) + l1.bias)
    return collectives.all_reduce_fwd(F.linear(h, l2.weight), group) + l2.bias


def shard_model(model: ActorCritic, mesh) -> ActorCritic:
    """A model holding this rank's tp shards of `model`'s whole weights (the
    model itself where tp is 1)."""
    if mesh.tp == 1:
        return model
    if model.mesh is not None:
        raise ValueError("shard_model: the model is already sharded")
    out = ActorCritic(model.hidden, device=model.actor[0].weight.device)
    dims = [torch_shard_dim(p.shape) for p in model.parameters()]
    with torch.no_grad():
        for (name, _), p, d in zip(out.named_parameters(), model.parameters(), dims):
            mod, attr = name.rsplit(".", 1)
            setattr(out.get_submodule(mod), attr, nn.Parameter(shard(p.detach(), d, mesh)))
    for layer in out.linears():
        layer.out_features, layer.in_features = layer.weight.shape
    out.mesh, out.shard_dims = mesh, dims
    return out


def gather_full_weights(model: ActorCritic) -> list:
    """The 12 whole weights and biases in `kernel_weights` layout, on every
    rank: one all-gather of the packed shards over the tp group.  Every rank
    of the group calls it."""
    params = [p.detach() for p in model.parameters()]
    sharded = [i for i, d in enumerate(model.shard_dims) if d is not None]
    flat = torch.cat([params[i].reshape(-1) for i in sharded])
    gathered = collectives.all_gather(flat, model.mesh.tp_group)  # [tp, n]
    whole, off = list(params), 0
    for i in sharded:
        n = params[i].numel()
        pieces = [g[off:off + n].view(params[i].shape) for g in gathered]
        whole[i] = torch.cat(pieces, model.shard_dims[i])
        off += n
    return [w.t().contiguous() if w.dim() == 2 else w.contiguous() for w in whole]


def kernel_weights(model: ActorCritic) -> list:
    """The 12 weights and biases in [in, out] layout, contiguous, as the
    fused forward takes them (and as the JAX package stores them).  For a
    sharded model, a collective: `gather_full_weights`."""
    if model.mesh is not None:
        return gather_full_weights(model)
    out = []
    for layer in model.linears():
        out += [layer.weight.detach().t().contiguous(), layer.bias.detach().contiguous()]
    return out


def gumbel_noise(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel draws f32 `shape`: -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def sample_action(logits: torch.Tensor, mask: torch.Tensor, generator=None, noise=None):
    """Sample from the masked categorical by Gumbel-argmax, as
    `jax.random.categorical` does.  `noise` (f32 [B, 45] Gumbel draws) may be
    passed in; otherwise it is drawn from `generator`.  Returns (action int64
    [B], log-prob f32 [B])."""
    ml = masked_logits(logits, mask)
    if noise is None:
        noise = gumbel_noise(ml.shape, generator, ml.device)
    action = torch.argmax(ml + noise, dim=-1)
    logp = torch.log_softmax(ml, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp


def greedy_action(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Argmax of the masked logits (first index on ties)."""
    return torch.argmax(masked_logits(logits, mask), dim=-1)


def log_prob_entropy(logits: torch.Tensor, mask: torch.Tensor, action: torch.Tensor):
    """Per-sample log-prob of `action` and entropy of the masked categorical
    -> (f32 [B], f32 [B]).  Illegal actions carry probability 0 and add
    nothing to the entropy."""
    logp = torch.log_softmax(masked_logits(logits, mask), dim=-1)
    p = torch.exp(logp)
    ent = -torch.where(p > 0, p * logp, 0.0).sum(-1)
    return logp.gather(-1, action.long()[:, None])[:, 0], ent


def critic_value(model: ActorCritic, obs: torch.Tensor) -> torch.Tensor:
    """obs [B, 297] -> value [B], the critic head alone."""
    return model.critic(obs.to(model.critic[0].weight.dtype))[:, 0]


def export_params_npz(model: ActorCritic, path: str) -> None:
    """Write the params as a flat npz in the JAX package's key layout
    (`actor.0.w` ... `critic.2.b`, weights [in, out])."""
    flat = {}
    for i, layer in enumerate(model.linears()):
        head, j = HEADS[i // 3], i % 3
        flat[f"{head}.{j}.w"] = layer.weight.detach().t().cpu().numpy().copy()
        flat[f"{head}.{j}.b"] = layer.bias.detach().cpu().numpy().copy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def from_kernel_weights(weights: list) -> ActorCritic:
    """An ActorCritic holding the 12 weights of `kernel_weights` layout."""
    flat = {}
    for i, (w, b) in enumerate(zip(weights[0::2], weights[1::2])):
        flat[f"{HEADS[i // 3]}.{i % 3}.w"], flat[f"{HEADS[i // 3]}.{i % 3}.b"] = w, b
    return params_from_jax(flat, device=weights[0].device)


def whole_model(model: ActorCritic) -> ActorCritic:
    """`model` with whole weights on every rank (itself if it is whole)."""
    return model if model.mesh is None else from_kernel_weights(gather_full_weights(model))


def params_from_jax(np_params: dict, device="cuda", mesh=None) -> ActorCritic:
    """An ActorCritic holding flat npz-layout params
    (`{"actor.0.w": [in, out], "actor.0.b": [out], ...}`), numpy arrays or
    tensors; with a `mesh`, this rank's tp shards of them."""
    if mesh is not None:
        return shard_model(params_from_jax(np_params, device), mesh)
    hidden = int(np.shape(np_params["actor.0.w"])[1])
    model = ActorCritic(hidden, device=device)
    with torch.no_grad():
        for i, layer in enumerate(model.linears()):
            head, j = HEADS[i // 3], i % 3
            w, b = np_params[f"{head}.{j}.w"], np_params[f"{head}.{j}.b"]
            layer.weight.copy_(_f32(w).t())
            layer.bias.copy_(_f32(b))
    return model


def _f32(x) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))


def import_params_npz(path: str, device="cuda") -> ActorCritic:
    """Load an npz in the JAX package's `export_params_npz` key layout."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files}, device=device)

