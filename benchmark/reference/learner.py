"""The plain learner of masked PPO (Schulman et al. 2017, "Proximal Policy
Optimization Algorithms"), as the configurations' recipe states it:
GAE(gamma, lambda), advantages normalised over the batch with the
population standard deviation, the clipped surrogate with a clipped value
loss and an entropy bonus, gradients clipped to a global norm of 0.5, then
Adam (0.9, 0.999, eps 1e-5 added after the bias correction), the learning
rate and the entropy coefficient annealed linearly over the run in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model

MAX_GRAD_NORM = 0.5
B1, B2, EPS = 0.9, 0.999, 1e-5


def anneal(recipe: dict, update_idx: int):
    """(lr, entropy coefficient) of update `update_idx`, in float32."""
    f32 = np.float32
    n_updates = recipe["total_timesteps"] // (recipe["num_envs"] * recipe["num_steps"])
    progress = f32(update_idx) / f32(max(1, n_updates - 1))
    lr = f32(recipe["lr"]) * (f32(1.0) - progress) if recipe["lr_anneal"] else f32(recipe["lr"])
    ent = f32(recipe["ent_coef"]) + (f32(recipe["ent_coef_final"]) - f32(recipe["ent_coef"])) \
        * progress
    return float(lr), float(ent)


def gae(reward, done, value, last_value, gamma: float, lam: float):
    """(advantages, returns) [T, N] in the values' dtype."""
    T = reward.shape[0]
    adv = torch.empty_like(value)
    nonterminal = 1.0 - done.to(value.dtype)
    last = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        delta = reward[t].to(value.dtype) + gamma * next_value * nonterminal[t] - value[t]
        last = delta + gamma * lam * nonterminal[t] * last
        adv[t] = last
        next_value = value[t]
    return adv, adv + value


def normalise(adv: torch.Tensor) -> torch.Tensor:
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def ppo_loss(weights, recipe: dict, ent_coef: float, obs, mask, action, logp_old, value_old,
             adv, returns, prec: str = "f64"):
    """The minibatch loss, its approx-KL and its scale (the sum of its
    terms' magnitudes), each mean over the rows given."""
    logits, value = model.forward(weights, obs, None, prec)
    logp_all = torch.log_softmax(model.masked_logits(logits, mask), dim=-1)
    p = torch.exp(logp_all)
    ent = -torch.where(p > 0, p * logp_all, 0.0).sum(-1)
    new_logp = logp_all.gather(-1, action.long()[:, None])[:, 0]
    ratio = torch.exp(new_logp - logp_old)
    clip = recipe["clip_coef"]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    v_clipped = value_old + torch.clamp(value - value_old, -recipe["vclip"], recipe["vclip"])
    v_loss = 0.5 * torch.maximum((value - returns) ** 2, (v_clipped - returns) ** 2).mean()
    ent_sign = 1.0 if recipe["reference_entropy_quirk"] else -1.0
    terms = (pg, recipe["vf_coef"] * v_loss, ent_coef * ent_sign * ent.mean())
    loss = terms[0] + terms[1] + terms[2]
    return loss, (logp_old - new_logp).mean(), sum(t.detach().abs() for t in terms)


def clip_grads(grads):
    """Scaled to a global norm of 0.5 where it is at or above it."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    if norm < MAX_GRAD_NORM:
        return list(grads)
    return [g / norm.to(g.dtype) * MAX_GRAD_NORM for g in grads]


class Adam:
    """Adam, in place on a list of tensors, from zero moments or from the
    moments and step count given."""

    def __init__(self, params, mu=None, nu=None, count: int = 0):
        self.mu = [torch.zeros_like(p) for p in params] if mu is None else \
            [m.to(p.dtype).clone() for m, p in zip(mu, params)]
        self.nu = [torch.zeros_like(p) for p in params] if nu is None else \
            [v.to(p.dtype).clone() for v, p in zip(nu, params)]
        self.count = count

    @torch.no_grad()
    def step(self, params, grads, lr: float):
        self.count += 1
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            denom = (nu / (1 - B2 ** self.count)).sqrt_().add_(EPS)
            p.addcdiv_(mu, denom, value=-lr / (1 - B1 ** self.count))
