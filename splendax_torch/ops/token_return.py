"""Fast-mode token return: the mover gives back tokens until holding at most
10, each draw returning one token of a uniformly chosen colour among those
held, gold only once no other colour is left.

The draws come from threefry, keyed by a hash of the game state
(`hash_seed`), bit for bit as in the JAX engine's fast mode.
`return_tokens` checks its inputs and runs `return_tokens_plain`, in plain
PyTorch, on the CPU or the card; it is the path of `rules.apply_action_plain`.
On the card in fast mode the ply's kernel (`ops/engine_ply`) draws the same
bits inside its launch (`csrc/token_return.cuh`), and is held against
`return_tokens_plain`.  Parity mode's token return (MT19937) stays in
`engine/rules.py`.
"""

from __future__ import annotations

import torch

from ..engine import data as D
from ..engine.state import NUM_PLAYERS, TOKEN_CAP
from ..engine.threefry import M32, uniform_from_key_words

MAX_RETURNS = 12  # draws per token return; a hand never exceeds 22 tokens


def hash_seed(turn_count: torch.Tensor, to_play: torch.Tensor, tokens_p: torch.Tensor,
              bank: torch.Tensor):
    """The integer seed of the token return, as uint32 words (lo, hi) held
    in int64:

        seed = (turn_count*1315423911) ^ (to_play*2654435761)
             ^ (sum(player tokens)*97531) ^ (sum(bank)*31337)

    turn_count*1315423911 is split into 16-bit limbs exactly as the JAX
    engine does with wrapping uint32 products; the other terms only touch the
    low word."""
    t = turn_count.long() & M32
    a = (t * (1315423911 >> 16)) & M32
    b = (t * (1315423911 & 0xFFFF)) & M32
    lo = ((a << 16) + b) & M32
    hi = ((a + (b >> 16)) & M32) >> 16
    lo = lo ^ ((to_play.long() * 2654435761) & M32)
    lo = lo ^ ((tokens_p.sum(1) & M32) * 97531 & M32)
    lo = lo ^ ((bank.long().sum(1) & M32) * 31337 & M32)
    return lo, hi


def return_tokens_plain(tokens: torch.Tensor, bank: torch.Tensor, to_play: torch.Tensor,
                        turn_count: torch.Tensor):
    """(tokens [B, 2, 6], bank [B, 6]) int32 after the token return; every
    lane runs all 12 draw steps, masked once it is done."""
    B = tokens.shape[0]
    dev = tokens.device
    ar6 = torch.arange(6, device=dev)
    p = to_play.long()
    tok = tokens[torch.arange(B, device=dev), p].long()
    bnk = bank.long()
    k = torch.clamp(tok.sum(1) - TOKEN_CAP, min=0)
    lo, hi = hash_seed(turn_count, to_play, tok, bnk)
    u = uniform_from_key_words(hi, lo, MAX_RETURNS)  # [B, 12] f32
    returned = torch.zeros_like(k)
    for i in range(MAX_RETURNS):
        nonzero = tok[:, :5] > 0
        n = nonzero.sum(1)
        active = (returned < k) & (n > 0)
        # float32 product, truncated, as the JAX engine computes it
        r = torch.minimum((u[:, i] * n.to(torch.float32)).to(torch.int64),
                          torch.clamp(n - 1, min=0))
        cum = torch.cumsum(nonzero, 1)
        color = torch.argmax((cum == (r + 1)[:, None]).to(torch.int32), 1)
        delta = (ar6[None] == color[:, None]) & active[:, None]
        tok = tok - delta.long()
        bnk = bnk + delta.long()
        returned = returned + active.long()
    give = torch.minimum(torch.clamp(k - returned, min=0), tok[:, D.GOLD])
    gold_row = (ar6 == D.GOLD).long()[None]
    tok = tok - gold_row * give[:, None]
    bnk = bnk + gold_row * give[:, None]
    prow = (torch.arange(NUM_PLAYERS, device=dev) == p[:, None])[:, :, None]
    return torch.where(prow, tok[:, None, :].to(torch.int32), tokens), bnk.to(torch.int32)


def return_tokens(tokens: torch.Tensor, bank: torch.Tensor, to_play: torch.Tensor,
                  turn_count: torch.Tensor):
    """The token return of the player to move in each of B games: tokens
    int32 [B, 2, 6], bank int32 [B, 6], to_play (0 or 1) and turn_count int32
    [B], on one device, the CPU or the card -> fresh (tokens [B, 2, 6],
    bank [B, 6]) int32, by `return_tokens_plain`."""
    B = tokens.shape[0] if tokens.dim() else -1
    for name, t, shape in (("tokens", tokens, (B, NUM_PLAYERS, 6)), ("bank", bank, (B, 6)),
                           ("to_play", to_play, (B,)), ("turn_count", turn_count, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != tokens.device:
            raise ValueError(f"return_tokens: {name} must be int32 {list(shape)} on "
                             f"{tokens.device}, got {t.dtype} {list(t.shape)} on {t.device}")
    if tokens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"return_tokens: unsupported device {tokens.device}")
    return return_tokens_plain(tokens, bank, to_play, turn_count)
