"""The learner's optimizer: global-norm clip, then Adam, with the semantics
of `optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr, eps=1e-5))`
as `splendax/train/ppo.py:make_optimizer` builds it.

Where this differs from `torch.nn.utils.clip_grad_norm_` + `torch.optim.Adam`:
  * the clip scales by `max_norm / g_norm` when `g_norm >= max_norm`, with no
    `+ 1e-6` in the denominator;
  * Adam's `eps` is added to `sqrt(nu_hat)`, after the bias correction of
    both moments;
  * the learning rate is an argument of every step (the trainer anneals it).

The state maps one-to-one onto optax's `ScaleByAdamState`: `mu` and `nu` are
lists in the order of the parameters, `count` is the number of steps taken.
`count` lives on the host: the caller decides on the host whether a step is
taken, so a step that is not taken leaves all of the state untouched.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MAX_GRAD_NORM = 0.5
B1, B2, EPS = 0.9, 0.999, 1e-5


@dataclass
class AdamState:
    mu: list  # first moments, one tensor per parameter
    nu: list  # second moments
    count: int = 0  # steps taken


def init(params) -> AdamState:
    """Zero moments for the given parameter tensors."""
    params = list(params)
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def clip_by_global_norm(grads, max_norm: float = MAX_GRAD_NORM):
    """The gradients, scaled down to a global norm of `max_norm` where it is
    at or above it; the test is made on the device."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


@torch.no_grad()
def step(params, grads, state: AdamState, lr: float,
         max_norm: float = MAX_GRAD_NORM) -> AdamState:
    """One clipped Adam step, in place on `params` and the moments; the
    gradients are clipped to a global norm of `max_norm` first."""
    params, grads = list(params), clip_by_global_norm(list(grads), max_norm)
    count = state.count + 1
    torch._foreach_mul_(state.mu, B1)
    torch._foreach_add_(state.mu, grads, alpha=1 - B1)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1 - B2)
    denom = torch._foreach_div(state.nu, 1 - B2 ** count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_addcdiv_(params, state.mu, denom, value=-lr / (1 - B1 ** count))
    state.count = count
    return state
