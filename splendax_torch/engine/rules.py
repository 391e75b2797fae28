"""Splendor rules on batched tensors: the legal mask and the transition.

Counterpart of `splendax/engine/rules.py`.  Every function takes a batched
`GameState` of B games and works on all of them at once with plain indexing
and `gather`; the one-hot contractions of the JAX engine were TPU workarounds
and are not carried over.  Actions are int tensors [B] in the 45-wide layout
below.

The token return that enforces the 10-token cap draws, in fast mode, its
uniforms from a threefry key derived from the game state (`ops/token_return`)
and, in parity mode, from CPython's MT19937
under the same seed (`mt19937`), bit for bit as in the JAX engine in both
modes.

On the card in fast mode `apply_action` is one launch of the ply's kernel
(`ops/engine_ply`); `apply_action_plain` is the same function in plain
PyTorch, the CPU's and parity mode's path, which the kernel is held against.
"""

from __future__ import annotations

import functools

import torch

from .. import trace
from ..ops import engine_ply, token_return
from . import data as D
from . import mt19937
from .state import GameState, NUM_PLAYERS, TOKEN_CAP, TURN_LIMIT

TAKE3_OFFSET, TAKE3_COUNT = 0, 10
TAKE2_OFFSET, TAKE2_COUNT = 10, 5
BUY_VISIBLE_OFFSET, BUY_VISIBLE_COUNT = 15, 12
RESERVE_VISIBLE_OFFSET, RESERVE_VISIBLE_COUNT = 27, 12
RESERVE_BLIND_OFFSET, RESERVE_BLIND_COUNT = 39, 3
BUY_RESERVED_OFFSET, BUY_RESERVED_COUNT = 42, 3
TOTAL_ACTIONS = 45


class _Tables:
    """The data tables as tensors on one device."""

    def __init__(self, device: torch.device):
        def t(x, dtype=torch.int64):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.combo = t(D.COMBO_MASK)  # [10, 5]
        self.combo_bool = self.combo.bool()
        self.cost = t(D.CARD7_PAD[:, :5])  # [91, 5], row 0 = absent
        self.card7 = t(D.CARD7_PAD)  # [91, 7]
        self.noble_req = t(D.NOBLE_REQ)  # [10, 5]
        self.noble_pts = t(D.NOBLE_POINTS)  # [10]
        self.feat13 = t(D.CARD_FEAT13, torch.int32)  # [91, 13]
        self.noble6 = t(D.NOBLE_FEAT6, torch.int32)  # [11, 6]
        self.ar2 = torch.arange(NUM_PLAYERS, device=device)
        self.ar3 = torch.arange(3, device=device)
        self.ar5 = torch.arange(5, device=device)
        self.ar6 = torch.arange(6, device=device)


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> _Tables:
    return _Tables(torch.device(device))


def _onehot(idx: torch.Tensor, n: int, ar: torch.Tensor) -> torch.Tensor:
    """bool[B, n]; all False where idx lies outside [0, n)."""
    return ar[:n] == idx[:, None]


def _player_row(arr: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """arr[b, p[b]] for a per-player array [B, 2, ...]."""
    return arr[torch.arange(arr.shape[0], device=arr.device), p]


def _gold_shortfall(tokens6, bonuses5, cost):
    """Gold needed to buy each card: cost [B, n, 5] after bonuses and color
    tokens; the card is affordable iff gold >= the shortfall."""
    discounted = torch.clamp(cost - bonuses5[:, None, :], min=0)
    return torch.clamp(discounted - tokens6[:, None, :5], min=0).sum(-1)


def legal_mask(state: GameState) -> torch.Tensor:
    """bool[B, 45] legality mask."""
    T = tables(state.bank.device)
    p = state.to_play.long()
    tokens = _player_row(state.tokens, p).long()
    bonuses = _player_row(state.bonuses, p).long()
    cnt_res = _player_row(state.reserved_count, p)
    bank = state.bank

    # Take-3 with the reduced-color rule: with fewer than 3 colors in the
    # bank, the combos that cover every available color are legal.
    avail = bank[:, :5] >= 1  # [B, 5]
    n_avail = avail.sum(1, keepdim=True)
    combo_sub_avail = ~(T.combo_bool[None] & ~avail[:, None, :]).any(-1)
    avail_sub_combo = ~(avail[:, None, :] & ~T.combo_bool[None]).any(-1)
    take3 = torch.where(n_avail >= 3, combo_sub_avail, (n_avail >= 1) & avail_sub_combo)

    take2 = bank[:, :5] >= 4

    board_flat = state.board.reshape(-1, 12)
    res_ids = _player_row(state.reserved_ids, p)
    cost15 = T.cost[torch.cat([board_flat, res_ids], 1).long() + 1]  # [B, 15, 5]
    short = _gold_shortfall(tokens, bonuses, cost15)
    gold = tokens[:, D.GOLD, None]

    present = board_flat >= 0
    buy_vis = present & (gold >= short[:, :12])
    can_reserve = (cnt_res < 3)[:, None]
    res_vis = can_reserve & present
    res_blind = can_reserve & (state.deck_count > 0)
    in_range = T.ar3[None] < cnt_res[:, None]
    buy_res = in_range & (gold >= short[:, 12:])
    return torch.cat([take3, take2, buy_vis, res_vis, res_blind, buy_res], 1)


def _apply_move(state: GameState, a: torch.Tensor) -> GameState:
    """All six action families at once, each effect gated by its family
    flag.  Exact for legal actions and total (never faults) for illegal ones,
    whose results the caller discards."""
    T = tables(state.bank.device)
    B = a.shape[0]
    ar = torch.arange(B, device=a.device)
    p = state.to_play.long()
    oh_p = _onehot(p, 2, T.ar2)  # [B, 2]
    is_t3 = a < TAKE2_OFFSET
    is_t2 = (a >= TAKE2_OFFSET) & (a < BUY_VISIBLE_OFFSET)
    is_bv = (a >= BUY_VISIBLE_OFFSET) & (a < RESERVE_VISIBLE_OFFSET)
    is_rv = (a >= RESERVE_VISIBLE_OFFSET) & (a < RESERVE_BLIND_OFFSET)
    is_rb = (a >= RESERVE_BLIND_OFFSET) & (a < BUY_RESERVED_OFFSET)
    is_br = a >= BUY_RESERVED_OFFSET

    tokens_p = state.tokens[ar, p].long()
    bonuses_p = state.bonuses[ar, p].long()
    bank = state.bank.long()

    # Token takes.
    take5 = T.combo[a.clamp(0, 9)] * (bank[:, :5] >= 1) * is_t3[:, None]
    take5 = take5 + 2 * _onehot(a - TAKE2_OFFSET, 5, T.ar5) * is_t2[:, None]
    take6 = torch.cat([take5, torch.zeros_like(take5[:, :1])], 1)

    # Visible slot of a buy or reserve from the board.
    vis_active = is_bv | is_rv
    off = torch.where(is_bv, a - BUY_VISIBLE_OFFSET, a - RESERVE_VISIBLE_OFFSET).clamp(0, 11)
    board_flat = state.board.reshape(B, 12).long()
    vis_card = board_flat[ar, off] * vis_active

    # Deck pop: the refill of a visible slot, or a blind reserve.
    has_tier = vis_active | is_rb
    tier = torch.where(vis_active, off // 4, (a - RESERVE_BLIND_OFFSET).clamp(0, 2))
    deck_count_t = state.deck_count.long()[ar, tier]
    cnt = deck_count_t * has_tier
    top = state.deck_perm.long()[ar, tier, torch.clamp(cnt - 1, min=0)] * has_tier
    pop = has_tier & (cnt > 0)
    deck_count = state.deck_count - (_onehot(tier, 3, T.ar3) & pop[:, None]).to(torch.int32)
    refill = torch.where(cnt > 0, top, -1)
    slot_hit = (torch.arange(12, device=a.device) == off[:, None]) & vis_active[:, None]
    board = torch.where(slot_hit, refill[:, None], board_flat).reshape(B, 3, 4)

    # Buy payment, for a visible or a reserved card: color tokens first,
    # the shortfall in gold.
    res_row = state.reserved_ids[ar, p].long()
    res_card = res_row[ar, (a - BUY_RESERVED_OFFSET).clamp(0, 2)] * is_br
    buy_active = is_bv | is_br
    bought = torch.where(is_bv, vis_card, torch.where(is_br, res_card, -1))
    card7 = T.card7[bought + 1]
    discounted = torch.clamp(card7[:, :5] - bonuses_p, min=0)
    spend = torch.minimum(tokens_p[:, :5], discounted)
    gold_spent = (discounted - spend).sum(1, keepdim=True)
    pay6 = torch.cat([spend, gold_spent], 1) * buy_active[:, None]
    bonus_inc = _onehot(card7[:, 5], 5, T.ar5) & buy_active[:, None]
    pts = card7[:, 6] * buy_active

    # Reserve bookkeeping.
    res_active = is_rv | is_rb
    new_res = torch.where(is_rv, vis_card, top)
    cnt_res = state.reserved_count[ar, p].long()
    res_cell = (
        oh_p[:, :, None]
        & _onehot(torch.clamp(cnt_res, max=2), 3, T.ar3)[:, None, :]
        & res_active[:, None, None]
    )
    reserved_ids = torch.where(res_cell, new_res[:, None, None].to(torch.int32), state.reserved_ids)
    reserved_revealed = torch.where(
        res_cell, is_rv[:, None, None].to(torch.int32), state.reserved_revealed
    )
    gold_take = res_active & (bank[:, D.GOLD] > 0)
    gold_take6 = ((T.ar6 == D.GOLD)[None] & gold_take[:, None]).long()

    # Buying a reserved card shifts the later slots left (list-pop order).
    src = torch.where(
        T.ar3[None] >= (a - BUY_RESERVED_OFFSET).clamp(0, 2)[:, None],
        torch.clamp(T.ar3 + 1, max=2)[None],
        T.ar3[None],
    )
    last = T.ar3[None] == 2
    ids_row = reserved_ids[ar, p]
    rev_row = reserved_revealed[ar, p]
    ids_shift = torch.where(last, -1, ids_row.gather(1, src))
    rev_shift = torch.where(last, 0, rev_row.gather(1, src))
    shift_cell = oh_p[:, :, None] & is_br[:, None, None]
    reserved_ids = torch.where(shift_cell, ids_shift[:, None, :], reserved_ids)
    reserved_revealed = torch.where(shift_cell, rev_shift[:, None, :], reserved_revealed)

    player_delta = take6 + gold_take6 - pay6
    ohp = oh_p.to(torch.int64)
    return state.replace(
        tokens=(state.tokens + player_delta[:, None, :] * ohp[:, :, None]).to(torch.int32),
        bank=(bank - take6 - gold_take6 + pay6).to(torch.int32),
        bonuses=(state.bonuses + bonus_inc[:, None, :] * ohp[:, :, None]).to(torch.int32),
        prestige=(state.prestige + pts[:, None] * ohp).to(torch.int32),
        board=board.to(torch.int32),
        deck_count=deck_count,
        reserved_ids=reserved_ids,
        reserved_revealed=reserved_revealed,
        reserved_count=(
            state.reserved_count + ohp * (res_active.long() - is_br.long())[:, None]
        ).to(torch.int32),
    )


def _grant_noble(state: GameState) -> GameState:
    """Grant at most one noble to the player who moved, first in display
    order."""
    T = tables(state.bank.device)
    p = state.to_play.long()
    oh_p = _onehot(p, 2, T.ar2)
    vis = state.noble_ids.long()  # [B, 3]
    bonuses_p = _player_row(state.bonuses, p).long()
    meets_all = (bonuses_p[:, None, :] >= T.noble_req[None]).all(-1)  # [B, 10]
    meets = (vis >= 0) & meets_all.gather(1, vis.clamp(min=0))  # [B, 3]
    any_meets = meets.any(1)
    first = torch.argmax(meets.to(torch.int32), 1)  # first True in display order
    nid = vis.gather(1, first[:, None])[:, 0]
    won_slot = torch.clamp((_player_row(state.player_nobles, p) >= 0).sum(1), max=2)
    won_cell = any_meets[:, None, None] & oh_p[:, :, None] & _onehot(won_slot, 3, T.ar3)[:, None, :]
    pts = T.noble_pts[nid.clamp(min=0)] * any_meets
    taken = _onehot(first, 3, T.ar3) & any_meets[:, None]
    return state.replace(
        noble_ids=torch.where(taken, -1, state.noble_ids),
        prestige=(state.prestige + pts[:, None] * oh_p).to(torch.int32),
        player_nobles=torch.where(won_cell, nid[:, None, None].to(torch.int32), state.player_nobles),
    )


def _return_tokens_mt(tokens, bank, k, lo, hi):
    """The parity-mode token return: CPython's `random.Random(seed)` seeded
    from the state hash, one `_randbelow(n)` per returned token over the n
    colours still held, on the lanes that are over the cap only (setting up
    MT19937 is over a thousand dependent steps).  A lane that is done draws
    no more, so each stream is consumed as the reference engine consumes it.
    Costs one host read for the lanes over the cap and one per round of
    draws.  Returns (tokens, bank, returned)."""
    returned = torch.zeros_like(k)
    over = trace.sync("rules.return_mt", lambda: torch.nonzero(k > 0)[:, 0])
    if over.numel() == 0:
        return tokens, bank, returned
    tok, bnk, need = tokens[over], bank[over], k[over]
    stream = mt19937.init_from_seed_words(lo[over], hi[over])
    done = torch.zeros_like(need)
    ar6 = torch.arange(6, device=k.device)
    while True:
        nonzero = tok[:, :5] > 0
        n = nonzero.sum(1)
        active = (done < need) & (n > 0)
        if not trace.sync("rules.return_mt", active.any().item):
            break
        stream, r = mt19937.randbelow(stream, torch.clamp(n, min=1), active)
        cum = torch.cumsum(nonzero, 1)
        color = torch.argmax((cum == (r + 1)[:, None]).to(torch.int32), 1)  # (r+1)-th held colour
        delta = ((ar6[None] == color[:, None]) & active[:, None]).long()
        tok, bnk, done = tok - delta, bnk + delta, done + active.long()
    tokens, bank = tokens.clone(), bank.clone()
    tokens[over], bank[over], returned[over] = tok, bnk, done
    return tokens, bank, returned


def _auto_return_tokens(state: GameState, p: torch.Tensor, rng_mode: str) -> GameState:
    """Return tokens until the mover holds at most 10: each draw returns one
    token of a uniformly chosen color among those held (gold only when no
    other color is left).  Fast mode draws from threefry seeded by the state
    hash (`ops/token_return`).  Parity mode draws from MT19937 under the same seed
    (`_return_tokens_mt`)."""
    if rng_mode not in ("fast", "parity"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if rng_mode == "fast":
        tokens, bank = token_return.return_tokens(
            state.tokens, state.bank, state.to_play, state.turn_count)
        return state.replace(tokens=tokens, bank=bank)
    T = tables(state.bank.device)
    B = p.shape[0]
    ar = torch.arange(B, device=p.device)
    tokens = state.tokens[ar, p].long()
    bank = state.bank.long()
    k = torch.clamp(tokens.sum(1) - TOKEN_CAP, min=0)
    lo, hi = token_return.hash_seed(state.turn_count, state.to_play, tokens, bank)
    tokens, bank, returned = _return_tokens_mt(tokens, bank, k, lo, hi)
    give = torch.minimum(torch.clamp(k - returned, min=0), tokens[:, D.GOLD])
    gold_row = (T.ar6 == D.GOLD).long()[None]
    tokens = tokens - gold_row * give[:, None]
    bank = bank + gold_row * give[:, None]
    prow = _onehot(p, 2, T.ar2)[:, :, None]
    return state.replace(
        tokens=torch.where(prow, tokens[:, None, :].to(torch.int32), state.tokens),
        bank=bank.to(torch.int32),
    )


def compute_winner(state: GameState) -> torch.Tensor:
    """Winner by (prestige, fewer bonuses, fewer reserved); an exact tie
    gives -1."""
    a = state.prestige
    b = -state.bonuses.sum(2)
    c = -state.reserved_count
    gt = (a[:, 0] > a[:, 1]) | (
        (a[:, 0] == a[:, 1])
        & ((b[:, 0] > b[:, 1]) | ((b[:, 0] == b[:, 1]) & (c[:, 0] > c[:, 1])))
    )
    eq = (a[:, 0] == a[:, 1]) & (b[:, 0] == b[:, 1]) & (c[:, 0] == c[:, 1])
    return torch.where(eq, -1, torch.where(gt, 0, 1)).to(torch.int32)


def apply_action(state: GameState, action: torch.Tensor, rng_mode: str = "fast") -> GameState:
    """The transition for LEGAL actions [B]; total for illegal ones, which
    the env layer filters.  On the card in fast mode one kernel launch
    (`ops/engine_ply`), else `apply_action_plain`."""
    if engine_ply.takes(state.to_play, rng_mode):
        return engine_ply.step(state, action, apply_only=True)[0]
    return apply_action_plain(state, action, rng_mode)


def apply_action_plain(state: GameState, action: torch.Tensor,
                       rng_mode: str = "fast") -> GameState:
    """`apply_action` in plain PyTorch."""
    a = action.long()
    p = state.to_play.long()
    state = _apply_move(state, a)
    state = _grant_noble(state)
    with trace.span("engine.token_return"):
        state = _auto_return_tokens(state, p, rng_mode)

    game_over = state.game_over | (_player_row(state.prestige, p) >= 15)
    move_count = state.move_count + 1
    to_play = (state.to_play + 1) % NUM_PLAYERS
    turn_count = move_count // 2 + 1
    hit_limit = turn_count >= TURN_LIMIT
    finished = game_over & (to_play == 0)
    winner = torch.where(
        hit_limit,
        torch.full_like(state.winner, -1),
        torch.where(finished, compute_winner(state), state.winner),
    )
    return state.replace(
        move_count=move_count,
        to_play=to_play,
        turn_count=turn_count,
        game_over=game_over | hit_limit,
        turn_limit_reached=state.turn_limit_reached | hit_limit,
        winner=winner,
    )


def is_terminal(state: GameState) -> torch.Tensor:
    """Terminal once the round completed after game_over."""
    return state.game_over & (state.to_play == 0)
