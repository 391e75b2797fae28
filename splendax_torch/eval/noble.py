"""Noble-rush heuristic opponent, on whole batches.

Counterpart of `splendax/eval/noble.py`: an opponent that races the visible
nobles.  Deterministic; it reads the game state.
  1. Buy the visible card that scores best: 10 for each bonus of its colour
     that the closest visible noble still needs, plus its points.
  2. Otherwise buy a reserved card; otherwise the take-3 that covers the
     most needed colours; otherwise take-2, reserve, first legal.
"""

from __future__ import annotations

import torch

from ..engine import rules
from ..selfplay.opponents import DEVICE_POLICIES, choose, first_legal, in_group


def _noble_needs(state, t) -> torch.Tensor:
    """int64 [B, 5]: the bonuses per colour that the visible noble closest
    to the player to move still lacks."""
    vis = state.noble_ids.long()  # [B, 3]
    present = vis >= 0
    req = t.noble_req[vis.clamp(min=0)] * present[..., None]  # [B, 3, 5]
    player = state.to_play.long()[:, None, None].expand(-1, 1, 5)
    bonuses = state.bonuses.long().gather(1, player)  # [B, 1, 5]
    deficit = (req - bonuses).clamp(min=0)
    total = deficit.sum(-1) + torch.where(present, 0, 1_000)
    closest = torch.argmin(total, dim=-1)
    return deficit.gather(1, closest[:, None, None].expand(-1, 1, 5))[:, 0]


def noble_policy(obs, mask, state, generator=None):
    t = rules.tables(mask.device)
    needs = _noble_needs(state, t)  # [B, 5]
    card = t.card7[state.board.reshape(-1, 12).long() + 1]  # [B, 12, cost5|colour|points]
    buy_score = needs.gather(1, card[..., 5]) * 10 + card[..., 6]
    buy_vis = mask[:, 15:27]
    best_vis = torch.argmax(torch.where(buy_vis, buy_score, -1), dim=-1)
    t3 = in_group(mask, "take3")
    overlap = (t.combo[None] * (needs > 0)[:, None, :]).sum(-1)  # [B, 10]
    a_t3 = torch.argmax(torch.where(t3[:, :10], overlap, -1), dim=-1)
    firsts = [in_group(mask, g) for g in ("buy_res", "take2", "reserve")]
    (res, a_res), (t2, a_t2), (rsv, a_rsv) = ((m.any(-1), first_legal(m)) for m in firsts)
    return choose((buy_vis.any(-1), 15 + best_vis), (res, a_res), (t3.any(-1), a_t3),
                  (t2, a_t2), (rsv, a_rsv), default=first_legal(mask))


DEVICE_POLICIES["noble"] = noble_policy
