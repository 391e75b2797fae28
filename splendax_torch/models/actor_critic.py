"""The actor-critic network: two MLPs 297 -> H -> H -> {45 logits, 1 value}.

Counterpart of `splendax/models/actor_critic.py`.  `ActorCritic` is an
`nn.Module` whose `forward` is the plain PyTorch path; the rollout runs the
fused kernel (`ops.fused_actor_critic`) on `kernel_weights(model)`, the same
weights in the JAX package's [in, out] layout.  The initialisation is
uniform +-1/sqrt(fan_in) for weights and biases, as the JAX package's
`_linear_init` and torch's `nn.Linear` default both draw.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.fused_actor_critic import ACT_DIM, OBS_DIM, masked_logits

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
        return self.actor(x), self.critic(x)[:, 0]


def kernel_weights(model: ActorCritic) -> list:
    """The 12 weights and biases in [in, out] layout, contiguous, as the
    fused forward takes them (and as the JAX package stores them)."""
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


def params_from_jax(np_params: dict, device="cuda") -> ActorCritic:
    """An ActorCritic holding flat npz-layout params
    (`{"actor.0.w": [in, out], "actor.0.b": [out], ...}`)."""
    hidden = int(np.shape(np_params["actor.0.w"])[1])
    model = ActorCritic(hidden, device=device)
    with torch.no_grad():
        for i, layer in enumerate(model.linears()):
            head, j = HEADS[i // 3], i % 3
            w = np.asarray(np_params[f"{head}.{j}.w"], np.float32)
            layer.weight.copy_(torch.as_tensor(w.T.copy()))
            layer.bias.copy_(torch.as_tensor(np.asarray(np_params[f"{head}.{j}.b"], np.float32)))
    return model


def import_params_npz(path: str, device="cuda") -> ActorCritic:
    """Load an npz in the JAX package's `export_params_npz` key layout."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files}, device=device)

