"""Opponent policies.

Counterpart of `splendax/selfplay/opponents.py`.  This slice ports only the
uniform random legal action; the heuristic opponents come later.
"""

from __future__ import annotations

import torch


def uniform_legal_action(mask: torch.Tensor, generator=None, u=None) -> torch.Tensor:
    """A uniformly random legal action per row of bool mask [B, 45]: the
    floor(u * n_legal)-th legal action, for u uniform in [0, 1) (drawn from
    `generator` unless given as f32 [B]).  Rows with no legal action give 0."""
    m = mask.to(torch.float32)
    n = m.sum(-1, keepdim=True)
    if u is None:
        u = torch.rand(mask.shape[:-1], generator=generator, device=mask.device)
    # The clamp guards the u just below 1 for which u*n rounds up to n.
    k = torch.minimum(torch.floor(u[..., None] * n), n - 1)
    before = torch.cumsum(m, -1) - m  # legal actions before each action
    hit = mask & (before == k)
    return torch.argmax(hit.to(torch.int32), dim=-1)
