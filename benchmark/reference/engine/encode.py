"""Observation encoder: GameState [B] -> int32 [B, 297].

The benchmark's frozen copy of `splendax_torch/engine/encode.py` (the rules the
reference holds the port's engine to; it imports nothing of the port).

The layout:

  | offset | size | content                                                  |
  |--------|------|----------------------------------------------------------|
  |   0    |   6  | bank (W,B,G,R,K,gold)                                    |
  |   6    |  13  | current player: tokens(6), bonuses(5), prestige, res_cnt |
  |  19    |  13  | opponent: same summary                                   |
  |  32    | 156  | board: 12 x [present,tier,points,color1hot(5),cost(5)]   |
  | 188    |  42  | own reserved: 3 x 14 (card13 + revealed, always 1)       |
  | 230    |  42  | opp reserved: 3 x 14; ALL-ZERO while reserved blind      |
  | 272    |  18  | nobles: 3 x [present, req(5)]                            |
  | 290    |   3  | deck sizes (tiers 1..3)                                  |
  | 293    |   4  | turn_count, to_play, move_count, round_over_flag         |

A card the opponent reserved blind stays hidden from the player to move.
"""

from __future__ import annotations

import torch

from .rules import tables
from .state import GameState

OBSERVATION_DIM = 297


def _player_summary(state: GameState, ar, p) -> torch.Tensor:
    return torch.cat(
        [
            state.tokens[ar, p],
            state.bonuses[ar, p],
            state.prestige[ar, p][:, None],
            state.reserved_count[ar, p][:, None],
        ],
        1,
    )


def _reserved_block(feat, ids, revealed, count, ar3) -> torch.Tensor:
    """3 x 14 reserved-card block from card features [B, 3, 13]; a slot shows
    only if it holds a card and `revealed` is set, which is also the 14th
    entry."""
    present = (ids >= 0) & (ar3[None] < count[:, None])
    rows = torch.cat([feat, revealed[:, :, None].to(torch.int32)], 2)
    visible = present & (revealed > 0)
    return torch.where(visible[:, :, None], rows, 0).reshape(-1, 42)


def encode_observation(state: GameState) -> torch.Tensor:
    T = tables(state.bank.device)
    B = state.batch_size
    ar = torch.arange(B, device=state.bank.device)
    p = state.to_play.long()
    o = 1 - p

    res_p = state.reserved_ids[ar, p]
    res_o = state.reserved_ids[ar, o]
    all_ids = torch.cat([state.board.reshape(B, 12), res_p, res_o], 1).long() + 1
    feats = T.feat13[all_ids]  # [B, 18, 13]

    own = _reserved_block(
        feats[:, 12:15], res_p, torch.ones_like(res_p), state.reserved_count[ar, p], T.ar3
    )
    opp = _reserved_block(
        feats[:, 15:18], res_o, state.reserved_revealed[ar, o], state.reserved_count[ar, o], T.ar3
    )
    nobles = T.noble6[state.noble_ids.long() + 1].reshape(B, 18)
    round_over = state.game_over & (state.to_play == 0)
    misc = torch.stack(
        [state.turn_count, state.to_play, state.move_count, round_over.to(torch.int32)], 1
    )
    return torch.cat(
        [
            state.bank,
            _player_summary(state, ar, p),
            _player_summary(state, ar, o),
            feats[:, :12].reshape(B, 156),
            own,
            opp,
            nobles,
            state.deck_count,
            misc,
        ],
        1,
    ).to(torch.int32)
