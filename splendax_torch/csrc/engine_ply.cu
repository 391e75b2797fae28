// The engine's fast-mode ply on the card: the transition, the observation
// encode and the legal mask, for a batch of games, in one launch.
//
// Two kernels, behind `ops/engine_ply.py`:
//   * `engine_step`: `env/core.step_core` (the action clamp, legality from
//     the given mask or the state's own, `rules.apply_action` with the
//     fast-mode token return, the pick for illegal and no-move rows, the
//     outcome fields), or `rules.apply_action` alone (`APPLY_ONLY`, no
//     legality); a lane may keep its state (`hold`, or `FREEZE_TERMINAL` for
//     a finished game); optionally the next state's observation and legal
//     mask (`& ~terminated` with `MASK_LIVE`);
//   * `engine_observe`: `encode.encode_observation` and `rules.legal_mask`,
//     optionally of `select(done, fresh, state)` (`SELECT`, the carried
//     state written too) and with the mask `& ~done` (`MASK_OFF`).
// Either kernel may read its input rows through a map (`rows[g]`, or
// g / `repeat`): a gather, or the repeated rows of a search's children,
// written out as the output state.
//
// Each equals the plain PyTorch functions it replaces bit for bit; those
// stay the CPU's and parity mode's path, and what the kernels are held
// against.  The token return is `token_return.cuh`'s device function.
//
// Bound on Hopper: bytes.  A game's state is ~194 int32 words over 18
// `[B, ...]` fields (deck_perm's 120 are read once per pop and passed
// through untouched unless the rows move); a full ply reads ~74 words and
// the 45-byte mask and writes ~74 words, a 297-word observation and a 45-byte
// mask, ~1.9 KB a game: 0.005 ms at 8,192 games on 3.35 TB/s.  The plain
// functions spend ~400 kernels of a few us each on it.
//
// Design.  A block carries G = 32 games with 256 threads.  The fields come
// in as one flat loop over (game, record word), UNROLL loads in flight a
// thread, into a per-game record in shared memory, R_STRIDE = 75 words apart
// (odd, so thread t reading word j of game t meets no bank conflict).  One
// thread a game then runs the transition on the records.  The records go
// out the same way, deck_perm rows in 16-byte words.  The views are split by
// segment, not by game: each of the 8 warps takes one segment for all 32
// games, a lane a game, so every lane runs the same code (an entry at a
// time, the branches of a per-entry layout cost 4-5x more) -- warps 0 to 5
// the observation's six segments into rows staged in dynamic shared memory,
// warps 6 and 7 the legal mask's two parts as bits -- and the block then
// stores the staged rows in 16-byte words and the mask four bytes at a time.
// The card and noble tables are packed words in `__constant__` memory
// (`engine_tables.h`, generated from `engine/data.py` with the layout),
// copied into shared memory once a block, since the lanes read them at
// different addresses.  Outputs are fresh tensors: a GameState's fields may
// be shared with other states, so nothing is written in place.

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_tables.h"
#include "token_return.cuh"

namespace {

constexpr int G = 32;         // games a block
constexpr int THREADS = 256;  // threads a block
constexpr int UNROLL = 8;     // loads a thread has in flight in the cooperative loops
constexpr int NA = 45;        // actions
constexpr int OBS = 297;      // observation width
constexpr int DECK = 120;     // deck_perm words a game: 3 tiers x 40
constexpr int N_CARDS = 91;   // the table rows, the absent card first
constexpr int N_NOBLES = 11;

// Options (`flags`).
constexpr int APPLY_ONLY = 1;       // step: apply_action alone, no legality or outcome
constexpr int FREEZE_TERMINAL = 2;  // step: a game already over keeps its state
constexpr int MASK_LIVE = 4;        // step: the next mask & ~terminated
constexpr int SELECT = 8;           // observe: fresh where flag, else the state
constexpr int MASK_OFF = 16;        // observe: the mask & ~flag

// The GameState's fields (`F_*`, N_FIELDS) and a game's record in shared
// memory (`R_*`: the fields but deck_perm, in GameState order, booleans as 0
// or 1) are `engine_tables.h`'s, as are FIELD_W and FIELD_OFF.

}  // namespace

// What a launch reads and writes; every pointer is to a contiguous tensor on
// the card.  Mirrored by `ops/engine_ply._Args`.
struct PlyArgs {
  const void* in[N_FIELDS];     // the input state's fields (bool: 1 byte)
  const void* fresh[N_FIELDS];  // observe with SELECT: the fresh state's fields
  void* out[N_FIELDS];          // the output state's fields, or null (not written)
  const int64_t* action;        // step: int64 [n]
  const uint8_t* mask;          // step: bool [n, 45], the input state's legal mask, or null
  const int64_t* rows;          // output lane g reads input row rows[g], or null
  const uint8_t* flag;          // bool [n]: step's hold; observe's done
  float* reward;                // step: f32 [n]
  uint8_t* terminated;          // step: bool [n]
  uint8_t* illegal;             // step: bool [n]
  uint8_t* draw;                // step: bool [n]
  uint8_t* turn_limit;          // step: bool [n]
  float* final_rewards;         // step: f32 [n, 2]
  int32_t* obs;                 // int32 [n, 297], or null
  uint8_t* mask_out;            // bool [n, 45], or null
  long long n;                  // output lanes
  long long repeat;             // without rows: output lane g reads input row g / repeat
  int flags;
};

namespace {

struct Shared {
  int rec[G * R_STRIDE];   // the input records (observe: the observed state)
  int nxt[G * R_STRIDE];   // step: the next states' records
  int64_t row[G];          // each game's input row
  int64_t action[G];       // step: each game's action
  uint64_t part[2][G];     // each game's output legal mask, in two parts (bit j action j)
  uint8_t sel[G];          // each game's flag
  uint8_t term[G];         // games whose output mask is all False (MASK_LIVE, MASK_OFF)
  uint8_t legal[G * 48];   // step: the given legal mask
  const void* in[N_FIELDS];     // the launch's field pointers, for indexing by field
  const void* fresh[N_FIELDS];
  void* out[N_FIELDS];
  uint8_t word_field[R_WORDS];  // record word -> its field
  uint8_t word_j[R_WORDS];      // record word -> its index in the field's row
  uint8_t word_w[R_WORDS];      // record word -> its field's words a game
  uint32_t card[N_CARDS];
  uint32_t noble[N_NOBLES];
  uint32_t combo[10];
};

__device__ __forceinline__ int nib(uint32_t w, int i) { return (int)((w >> (4 * i)) & 15u); }

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------- records
//
// The block's records go in and out as one flat loop over (game, record
// word), UNROLL loads in flight a thread: record word w of a game is word
// word_j[w] of field word_field[w]'s row, so a warp reads the rows of one or
// two games across all their fields, each field's slice of the block's games
// contiguous in memory.

__device__ __forceinline__ bool is_byte(int f) { return f == F_OVER || f == F_LIMIT; }

// Record words of the block's games from their input rows; with SELECT a
// game whose flag is set reads `fresh`.
__device__ void load_records(const Shared& s, int* rec, bool select, int n) {
  const int total = n * R_WORDS;
  for (int base = threadIdx.x; base < total; base += UNROLL * THREADS) {
    int v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int game = i / R_WORDS, w = i - game * R_WORDS;
        const int f = s.word_field[w];
        const void* p = (select && s.sel[game]) ? s.fresh[f] : s.in[f];
        const int64_t at = s.row[game] * s.word_w[w] + s.word_j[w];
        v[u] = is_byte(f) ? (int)(((const uint8_t*)p)[at] != 0) : ((const int32_t*)p)[at];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int game = i / R_WORDS;
        rec[game * R_STRIDE + i - game * R_WORDS] = v[u];
      }
    }
  }
}

__device__ void store_records(const Shared& s, const int* rec, int64_t g0, int n) {
  if (s.out[F_BANK] == nullptr) return;
  const int total = n * R_WORDS;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int game = i / R_WORDS, w = i - game * R_WORDS;
    const int f = s.word_field[w];
    const int v = rec[game * R_STRIDE + w];
    const int64_t at = (g0 + game) * s.word_w[w] + s.word_j[w];
    if (is_byte(f)) {
      ((uint8_t*)s.out[f])[at] = (uint8_t)(v != 0);
    } else {
      ((int32_t*)s.out[f])[at] = v;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

// deck_perm of the block's games, from their input rows (fresh where SELECT
// picks it), when the output state takes a copy: 16-byte words where every
// pointer allows (a row is 480 bytes), else 4-byte ones.
__device__ void copy_decks(const Shared& s, int32_t* out, const int32_t* cur,
                           const int32_t* fresh, int64_t g0, int n) {
  if (out == nullptr) return;
  if (aligned16(out) && aligned16(cur) && aligned16(fresh)) {
    constexpr int V = DECK / 4;
    const int total = n * V;
    for (int base = threadIdx.x; base < total; base += 4 * THREADS) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * THREADS;
        if (i < total) {
          const int game = i / V, j = i - game * V;
          const int32_t* b = (fresh != nullptr && s.sel[game]) ? fresh : cur;
          v[u] = ((const int4*)b)[s.row[game] * V + j];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * THREADS;
        if (i < total) ((int4*)out)[g0 * V + i] = v[u];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n * DECK; i += THREADS) {
    const int game = i / DECK, j = i - game * DECK;
    const int32_t* base = (fresh != nullptr && s.sel[game]) ? fresh : cur;
    out[g0 * DECK + i] = base[s.row[game] * DECK + j];
  }
}

// ---------------------------------------------------------------- the rules

// The gold a player needs to buy card `id` (-1 absent: row 0) after bonuses
// and colour tokens.
__device__ __forceinline__ int shortfall(const Shared& s, const int* tok, const int* bon, int id) {
  const uint32_t card = s.card[id + 1];
  int need = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c) need += max(max(nib(card, c) - bon[c], 0) - tok[c], 0);
  return need;
}

// `rules.legal_mask` of one game's record, bit j for action j, in two
// parts: the buys from the board (`mask_board_buys`), and the rest.
__device__ uint64_t mask_board_buys(const Shared& s, const int* r) {
  const int p = r[R_TO_PLAY];
  const int* tok = r + R_TOKENS + 6 * p;
  const int* bon = r + R_BONUSES + 5 * p;
  uint64_t m = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int id = r[R_BOARD + i];
    m |= (uint64_t)(id >= 0 && tok[5] >= shortfall(s, tok, bon, id)) << (15 + i);
  }
  return m;
}

__device__ uint64_t mask_rest(const Shared& s, const int* r) {
  const int p = r[R_TO_PLAY];
  const int* bank = r + R_BANK;
  const int* tok = r + R_TOKENS + 6 * p;
  const int* bon = r + R_BONUSES + 5 * p;
  uint32_t avail = 0;
  int n_avail = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const bool a = bank[c] >= 1;
    avail |= (uint32_t)a << c;
    n_avail += a;
  }
  uint64_t m = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {  // take 3, with the reduced-colour rule
    const uint32_t combo = s.combo[i];
    const bool ok = n_avail >= 3 ? (combo & ~avail) == 0 : (n_avail >= 1 && (avail & ~combo) == 0);
    m |= (uint64_t)ok << i;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) m |= (uint64_t)(bank[c] >= 4) << (10 + c);
  const int cnt_res = r[R_RES_CNT + p];
  const bool can_reserve = cnt_res < 3;
#pragma unroll
  for (int i = 0; i < 12; ++i) m |= (uint64_t)(can_reserve && r[R_BOARD + i] >= 0) << (27 + i);
#pragma unroll
  for (int t = 0; t < 3; ++t) m |= (uint64_t)(can_reserve && r[R_DECK_CNT + t] > 0) << (39 + t);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int id = r[R_RES_IDS + 3 * p + j];
    m |= (uint64_t)(j < cnt_res && tok[5] >= shortfall(s, tok, bon, id)) << (42 + j);
  }
  return m;
}

__device__ __forceinline__ uint64_t legal_bits(const Shared& s, const int* r) {
  return mask_rest(s, r) | mask_board_buys(s, r);
}

// The 13 features of card `id` (-1 absent: all zero): [present, tier,
// points, colour one-hot (5), cost (5)].
__device__ __forceinline__ void card_features(const Shared& s, int id, int* o) {
  const uint32_t card = s.card[id + 1];  // row 0, the absent card, is zero
  const bool present = id >= 0;
  const int color = nib(card, 5);
  o[0] = present;
  o[1] = nib(card, 7);
  o[2] = nib(card, 6);
#pragma unroll
  for (int c = 0; c < 5; ++c) o[3 + c] = present && color == c;
#pragma unroll
  for (int c = 0; c < 5; ++c) o[8 + c] = nib(card, c);
}

// A player's summary: tokens (6), bonuses (5), prestige, reserved count.
__device__ __forceinline__ void summary(const int* r, int pl, int* o) {
#pragma unroll
  for (int c = 0; c < 6; ++c) o[c] = r[R_TOKENS + 6 * pl + c];
#pragma unroll
  for (int c = 0; c < 5; ++c) o[6 + c] = r[R_BONUSES + 5 * pl + c];
  o[11] = r[R_PRESTIGE + pl];
  o[12] = r[R_RES_CNT + pl];
}

// Segment `seg` (0 to 5) of `encode.encode_observation` of one game's record
// into its row `o` (297 words): 0 the bank, the summaries, the nobles, the
// decks and the turn; 1 to 3 four board slots each; 4 the mover's reserved
// cards; 5 the opponent's, hidden while reserved blind.
__device__ void obs_segment(const Shared& s, const int* r, int* o, int seg) {
  const int p = r[R_TO_PLAY], q = 1 - p;
  if (seg == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) o[c] = r[R_BANK + c];
    summary(r, p, o + 6);
    summary(r, q, o + 19);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int id = r[R_NOBLES + i];
      const uint32_t req = s.noble[id + 1];  // row 0, the absent noble, is zero
      o[272 + 6 * i] = id >= 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) o[273 + 6 * i + c] = nib(req, c);
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) o[290 + t] = r[R_DECK_CNT + t];
    o[293] = r[R_TURN];
    o[294] = p;
    o[295] = r[R_MOVE];
    o[296] = r[R_OVER] && p == 0;
  } else if (seg <= 3) {
#pragma unroll
    for (int i = 4 * (seg - 1); i < 4 * seg; ++i) card_features(s, r[R_BOARD + i], o + 32 + 13 * i);
  } else {
    const bool own = seg == 4;
    const int pl = own ? p : q;
    const int cnt = r[R_RES_CNT + pl];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int id = r[R_RES_IDS + 3 * pl + i];
      const int revealed = own ? 1 : r[R_RES_REV + 3 * pl + i];
      int* d = o + (own ? 188 : 230) + 14 * i;
      if (id >= 0 && i < cnt && revealed > 0) {
        card_features(s, id, d);
        d[13] = revealed;
      } else {
#pragma unroll
        for (int f = 0; f < 14; ++f) d[f] = 0;
      }
    }
  }
}

// `rules.compute_winner`: prestige, then fewer bonuses, then fewer reserved.
__device__ __forceinline__ int compute_winner(const int* o) {
  int b0 = 0, b1 = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    b0 -= o[R_BONUSES + c];
    b1 -= o[R_BONUSES + 5 + c];
  }
  const int a0 = o[R_PRESTIGE], a1 = o[R_PRESTIGE + 1];
  const int c0 = -o[R_RES_CNT], c1 = -o[R_RES_CNT + 1];
  const bool gt = a0 > a1 || (a0 == a1 && (b0 > b1 || (b0 == b1 && c0 > c1)));
  const bool eq = a0 == a1 && b0 == b1 && c0 == c1;
  return eq ? -1 : (gt ? 0 : 1);
}

// `rules.apply_action` of action a on record r into record o: `_apply_move`
// (every family's effect gated by its flag, total for illegal actions, whose
// results follow the plain version's arithmetic), `_grant_noble`, the token
// return, then the move, turn, game-over, turn-limit and winner updates.
__device__ void apply_action(const Shared& s, const int* r, int* o, int64_t a,
                             const int32_t* deck) {
#pragma unroll 2
  for (int j = 0; j < R_WORDS; ++j) o[j] = r[j];
  const int p = r[R_TO_PLAY];
  const bool t3 = a < 10, t2 = a >= 10 && a < 15, bv = a >= 15 && a < 27;
  const bool rv = a >= 27 && a < 39, rb = a >= 39 && a < 42, br = a >= 42;
  int tok[6], bank[6], take[6], pay[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    tok[c] = r[R_TOKENS + 6 * p + c];
    bank[c] = r[R_BANK + c];
  }
  // Token takes.
  const uint32_t combo = s.combo[clamp64(a, 0, 9)];
#pragma unroll
  for (int c = 0; c < 5; ++c)
    take[c] = (t3 && ((combo >> c) & 1u) && bank[c] >= 1 ? 1 : 0) + (t2 && a - 10 == c ? 2 : 0);
  take[5] = 0;
  // The visible slot of a buy or reserve, and the deck pop that refills it
  // (or a blind reserve's).
  const bool vis = bv || rv;
  const int off = (int)clamp64(bv ? a - 15 : a - 27, 0, 11);
  const int vis_card = vis ? r[R_BOARD + off] : 0;
  const bool has_tier = vis || rb;
  const int tier = vis ? off / 4 : (int)clamp64(a - 39, 0, 2);
  const int cnt = has_tier ? r[R_DECK_CNT + tier] : 0;
  const int top = has_tier ? deck[tier * 40 + max(cnt - 1, 0)] : 0;
  if (has_tier && cnt > 0) o[R_DECK_CNT + tier] -= 1;
  if (vis) o[R_BOARD + off] = cnt > 0 ? top : -1;
  // A buy's payment, for a visible or a reserved card: colour tokens first,
  // the shortfall in gold.
  const int kres = (int)clamp64(a - 42, 0, 2);
  const int res_card = br ? r[R_RES_IDS + 3 * p + kres] : 0;
  const bool buy = bv || br;
  const int bought = bv ? vis_card : (br ? res_card : -1);
  const uint32_t card = s.card[bought + 1];
  int gold_spent = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int disc = max(nib(card, c) - r[R_BONUSES + 5 * p + c], 0);
    const int spend = min(tok[c], disc);
    gold_spent += disc - spend;
    pay[c] = buy ? spend : 0;
  }
  pay[5] = buy ? gold_spent : 0;
  // Reserve bookkeeping.
  const bool res = rv || rb;
  const int slot = min(r[R_RES_CNT + p], 2);
  if (res && slot >= 0) {
    o[R_RES_IDS + 3 * p + slot] = rv ? vis_card : top;
    o[R_RES_REV + 3 * p + slot] = rv;
  }
  const int gold_take = res && bank[5] > 0;
  if (br) {  // buying a reserved card shifts the later slots left
    int ids[3], rev[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ids[j] = o[R_RES_IDS + 3 * p + j];
      rev[j] = o[R_RES_REV + 3 * p + j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int from = j >= kres ? min(j + 1, 2) : j;
      o[R_RES_IDS + 3 * p + j] = j == 2 ? -1 : ids[from];
      o[R_RES_REV + 3 * p + j] = j == 2 ? 0 : rev[from];
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int gt = c == 5 ? gold_take : 0;
    o[R_TOKENS + 6 * p + c] = tok[c] + take[c] + gt - pay[c];
    o[R_BANK + c] = bank[c] - take[c] - gt + pay[c];
  }
  const int color = nib(card, 5);
  if (buy && color < 5) o[R_BONUSES + 5 * p + color] += 1;
  if (buy) o[R_PRESTIGE + p] += nib(card, 6);
  o[R_RES_CNT + p] += (int)res - (int)br;

  // At most one noble, first in display order.
  bool meets[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int id = o[R_NOBLES + j];
    const uint32_t req = s.noble[max(id, 0) + 1];
    bool ok = id >= 0;
#pragma unroll
    for (int c = 0; c < 5; ++c) ok = ok && o[R_BONUSES + 5 * p + c] >= nib(req, c);
    meets[j] = ok;
  }
  if (meets[0] || meets[1] || meets[2]) {
    const int first = meets[0] ? 0 : (meets[1] ? 1 : 2);
    const int nid = o[R_NOBLES + first];
    int won = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) won += o[R_PNOBLES + 3 * p + j] >= 0;
    o[R_PNOBLES + 3 * p + min(won, 2)] = nid;
    o[R_NOBLES + first] = -1;
    o[R_PRESTIGE + p] += nib(s.noble[nid + 1], 5);
  }

  // The token return (`token_return.cuh`).
  int t[6], b[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    t[c] = o[R_TOKENS + 6 * p + c];
    b[c] = o[R_BANK + c];
  }
  token_return_dev::return_tokens(t, b, o[R_TO_PLAY], o[R_TURN]);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    o[R_TOKENS + 6 * p + c] = t[c];
    o[R_BANK + c] = b[c];
  }

  // The move, the turn, the end of the game.
  const bool over = o[R_OVER] || o[R_PRESTIGE + p] >= 15;
  const int move = o[R_MOVE] + 1;
  const int to_play = (o[R_TO_PLAY] + 1) % 2;
  const int turn = move / 2 + 1;
  const bool hit = turn >= 100;  // TURN_LIMIT
  int winner = o[R_WINNER];
  if (hit) {
    winner = -1;
  } else if (over && to_play == 0) {
    winner = compute_winner(o);
  }
  o[R_MOVE] = move;
  o[R_TO_PLAY] = to_play;
  o[R_TURN] = turn;
  o[R_OVER] = over || hit;
  o[R_LIMIT] = o[R_LIMIT] || hit;
  o[R_WINNER] = winner;
}

// The block's set-up: the launch's field pointers, the record's word map
// and the tables, from constant memory into shared memory.
__device__ void set_up_block(Shared& s, const PlyArgs& a) {
  if (threadIdx.x < N_FIELDS) {
    const int f = threadIdx.x;
    s.in[f] = a.in[f];
    s.fresh[f] = a.fresh[f];
    s.out[f] = a.out[f];
    if (f != F_DECK) {
      for (int j = 0; j < FIELD_W[f]; ++j) {
        s.word_field[FIELD_OFF[f] + j] = (uint8_t)f;
        s.word_j[FIELD_OFF[f] + j] = (uint8_t)j;
        s.word_w[FIELD_OFF[f] + j] = (uint8_t)FIELD_W[f];
      }
    }
  }
  for (int i = threadIdx.x; i < N_CARDS + N_NOBLES + 10; i += THREADS) {
    if (i < N_CARDS) {
      s.card[i] = CARD_PACKED[i];
    } else if (i < N_CARDS + N_NOBLES) {
      s.noble[i - N_CARDS] = NOBLE_PACKED[i - N_CARDS];
    } else {
      s.combo[i - N_CARDS - N_NOBLES] = COMBO_BITS[i - N_CARDS - N_NOBLES];
    }
  }
}

// The block's games' input rows and flags.
__device__ void load_rows(Shared& s, const PlyArgs& a, int64_t g0, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int64_t g = g0 + i;
    s.row[i] = a.rows != nullptr ? a.rows[g] : g / a.repeat;
    s.sel[i] = a.flag != nullptr ? a.flag[g] != 0 : 0;
    s.action[i] = a.action != nullptr ? a.action[g] : 0;
  }
}

// The observation and the legal mask of the block's records (after a
// barrier behind them): each warp takes one segment for all the block's
// games, a lane a game, so its code is the same in every lane -- warps 0 to
// 5 the observation's six segments into `stage` (a row of 297 words a game,
// the block's slice of the output), warps 6 and 7 the mask's two parts.
// `live[g]` false leaves game g's mask all False.
__device__ void compute_views(Shared& s, const int* rec, int* stage, bool with_obs,
                              bool with_mask, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane >= n) return;
  const int* r = rec + lane * R_STRIDE;
  if (warp < 6) {
    if (with_obs) obs_segment(s, r, stage + lane * OBS, warp);
  } else if (with_mask) {
    s.part[warp - 6][lane] = warp == 6 ? mask_rest(s, r) : mask_board_buys(s, r);
  }
}

// The staged observation rows out in 16-byte words (the block's slice
// starts 16-byte aligned: 32 x 297 words), and the mask's bytes four at a
// time, all False where `off[g]`.
__device__ void write_views(const Shared& s, const int* stage, int32_t* obs, uint8_t* mask,
                            const uint8_t* off, int64_t g0, int n) {
  if (obs != nullptr) {
    const int total = n * OBS;
    int32_t* o = obs + g0 * OBS;
    if (aligned16(o)) {
      for (int q = threadIdx.x; 4 * q + 4 <= total; q += THREADS)
        ((int4*)o)[q] = ((const int4*)stage)[q];
      for (int i = (total & ~3) + threadIdx.x; i < total; i += THREADS) o[i] = stage[i];
    } else {
      for (int i = threadIdx.x; i < total; i += THREADS) o[i] = stage[i];
    }
  }
  if (mask != nullptr) {
    const int total = n * NA;
    const bool vec = ((uintptr_t)mask & 3u) == 0;
    for (int q = threadIdx.x; 4 * q < total; q += THREADS) {
      uint32_t v = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * q + u;
        const int game = i / NA;
        if (i < total && !off[game]) {
          const uint64_t bits = s.part[0][game] | s.part[1][game];
          v |= (uint32_t)((bits >> (i - game * NA)) & 1u) << (8 * u);
        }
      }
      uint8_t* o = mask + g0 * NA + 4 * q;
      if (vec && 4 * q + 4 <= total) {
        *(uint32_t*)o = v;
      } else {
        for (int u = 0; u < 4 && 4 * q + u < total; ++u) o[u] = (uint8_t)(v >> (8 * u));
      }
    }
  }
}

// ---------------------------------------------------------------- kernels

constexpr int STAGE_BYTES = G * OBS * 4;  // dynamic shared memory: the observation's rows
static_assert(THREADS == 256 && G == 32, "compute_views: 8 warps, a lane a game");

__global__ void __launch_bounds__(THREADS) engine_step_kernel(const PlyArgs a) {
  __shared__ Shared s;
  extern __shared__ int4 dyn[];
  int* stage = (int*)dyn;
  const int64_t g0 = (int64_t)blockIdx.x * G;
  const int n = (int)min((long long)G, a.n - g0);
  const bool apply_only = a.flags & APPLY_ONLY;
  set_up_block(s, a);
  load_rows(s, a, g0, n);
  __syncthreads();
  load_records(s, s.rec, false, n);
  if (!apply_only && a.mask != nullptr) {
    const int total = n * NA;
    for (int base = threadIdx.x; base < total; base += UNROLL * THREADS) {
      uint8_t v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        v[u] = i < total ? a.mask[g0 * NA + i] : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < total) {
          const int game = i / NA;
          s.legal[game * 48 + i - game * NA] = v[u] != 0;
        }
      }
    }
  }
  __syncthreads();

  if (threadIdx.x < n) {
    const int game = threadIdx.x;
    const int64_t g = g0 + game;
    const int* r = s.rec + game * R_STRIDE;
    int* o = s.nxt + game * R_STRIDE;
    const int32_t* deck = (const int32_t*)a.in[F_DECK] + s.row[game] * DECK;
    bool term = false;
    if (apply_only) {
      apply_action(s, r, o, s.action[game], deck);
    } else {
      // `core.step_core`.
      const int act = (int)clamp64(s.action[game], 0, NA - 1);
      uint64_t given = 0;
      if (a.mask != nullptr) {  // 45 bytes of 0 or 1, four to a word, into bits
        const uint32_t* m = (const uint32_t*)(s.legal + game * 48);
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const uint32_t w = j < 11 ? m[j] : m[j] & 0xFFu;  // bytes 45-47 are not the mask's
          given |= (uint64_t)(((w * 0x01020408u) >> 24) & 15u) << (4 * j);
        }
      } else {
        given = legal_bits(s, r);
      }
      const bool any = given != 0;
      const bool legal = ((given >> act) & 1u) && any;
      if (legal) {
        apply_action(s, r, o, act, deck);
      } else {
#pragma unroll 2
        for (int j = 0; j < R_WORDS; ++j) o[j] = r[j];
      }
      if (!any) {  // no legal move: a draw
        o[R_OVER] = 1;
        o[R_WINNER] = -1;
        o[R_TO_PLAY] = 0;
      }
      term = o[R_OVER] && o[R_TO_PLAY] == 0;
      const int w = o[R_WINNER];
      const bool limit = o[R_LIMIT];
      const int just_moved = (o[R_TO_PLAY] + 1) % 2;  // (to_play - 1) mod 2
      const float win_reward =
          (w < 0 && limit) ? -0.1f : (w < 0 ? 0.0f : (w == just_moved ? 1.0f : -1.0f));
      a.reward[g] = !any ? 0.0f : (legal ? (term ? win_reward : 0.0f) : -0.01f);
      a.terminated[g] = term;
      a.illegal[g] = any && !legal;
      a.draw[g] = !any;
      a.turn_limit[g] = term && limit;
      const float draw_r = limit ? -0.1f : 0.0f;
      a.final_rewards[2 * g] = term ? (w < 0 ? draw_r : (w == 0 ? 1.0f : -1.0f)) : 0.0f;
      a.final_rewards[2 * g + 1] = term ? (w < 0 ? draw_r : (w == 1 ? 1.0f : -1.0f)) : 0.0f;
    }
    // The next mask is all False once over with MASK_LIVE.
    s.term[game] = (a.flags & MASK_LIVE) && term;
    // A held lane, or a game over before the ply, keeps its state.
    const bool keep = s.sel[game] || ((a.flags & FREEZE_TERMINAL) && r[R_OVER] && r[R_TO_PLAY] == 0);
    if (keep) {
#pragma unroll 2
      for (int j = 0; j < R_WORDS; ++j) o[j] = r[j];
    }
  }
  __syncthreads();

  store_records(s, s.nxt, g0, n);
  copy_decks(s, (int32_t*)a.out[F_DECK], (const int32_t*)a.in[F_DECK], nullptr, g0, n);
  compute_views(s, s.nxt, stage, a.obs != nullptr, a.mask_out != nullptr, n);
  __syncthreads();
  write_views(s, stage, a.obs, a.mask_out, s.term, g0, n);
}

__global__ void __launch_bounds__(THREADS) engine_observe_kernel(const PlyArgs a) {
  __shared__ Shared s;
  extern __shared__ int4 dyn[];
  int* stage = (int*)dyn;
  const int64_t g0 = (int64_t)blockIdx.x * G;
  const int n = (int)min((long long)G, a.n - g0);
  const bool select = a.flags & SELECT;
  set_up_block(s, a);
  load_rows(s, a, g0, n);
  __syncthreads();
  load_records(s, s.rec, select, n);
  if (threadIdx.x < n) s.term[threadIdx.x] = (a.flags & MASK_OFF) && s.sel[threadIdx.x];
  __syncthreads();
  store_records(s, s.rec, g0, n);
  copy_decks(s, (int32_t*)a.out[F_DECK], (const int32_t*)a.in[F_DECK],
             select ? (const int32_t*)a.fresh[F_DECK] : nullptr, g0, n);
  compute_views(s, s.rec, stage, a.obs != nullptr, a.mask_out != nullptr, n);
  __syncthreads();
  write_views(s, stage, a.obs, a.mask_out, s.term, g0, n);
}

int launch(bool step, const PlyArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const long long blocks = (args->n + G - 1) / G;
  if (blocks > 0x7FFFFFFFLL || args->repeat < 1) return (int)cudaErrorInvalidValue;
  const int dyn = args->obs != nullptr ? STAGE_BYTES : 0;
  if (step) {
    engine_step_kernel<<<(unsigned)blocks, THREADS, dyn, (cudaStream_t)stream>>>(*args);
  } else {
    engine_observe_kernel<<<(unsigned)blocks, THREADS, dyn, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Lets both kernels take the observation's staging rows in dynamic shared
// memory beyond the default 48 KB a block; call once before any launch (and
// outside a stream capture).  Returns the CUDA error.
extern "C" int engine_ply_init() {
  cudaError_t err = cudaFuncSetAttribute(engine_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(engine_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_BYTES);
  }
  return (int)err;
}

// One launch of the transition (`engine_step`) or the observation
// (`engine_observe`) over args->n output lanes on `stream`; the outputs must
// not alias the inputs.  Returns cudaGetLastError().
extern "C" int engine_step(const PlyArgs* args, void* stream) { return launch(true, args, stream); }

extern "C" int engine_observe(const PlyArgs* args, void* stream) {
  return launch(false, args, stream);
}

// sizeof(PlyArgs), so the binding can check its mirror of the layout.
extern "C" long long engine_ply_args_size() { return (long long)sizeof(PlyArgs); }
