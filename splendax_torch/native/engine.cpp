// splendax native host engine: single-game Splendor rules in C++.
//
// Purpose: the latency-bound HOST path (interactive gym stepping, game
// logging, scripted verification) where per-step XLA dispatch dominates.
// The batched throughput path stays in JAX/XLA (splendax/engine/rules.py);
// this file mirrors those semantics bit-for-bit, including CPython-MT19937
// deck shuffles and deterministic token returns, so native and JAX engines
// are trajectory-identical (tests/test_native.py).
//
// Reference semantics ported from splendor_gym/engine/{state,rules,encode}.py
// (same citations as splendax/engine/rules.py docstrings).
//
// Build: g++ -O2 -shared -fPIC -o libspxengine.so engine.cpp   (see build.py)

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

// ---------------------------------------------------------------------------
// CPython-compatible MT19937 (_random.Random core + Lib/random.py helpers)
// ---------------------------------------------------------------------------

struct PyRandom {
  uint32_t mt[624];
  int mti;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < 624; mti++)
      mt[mti] = 1812433253u * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + (uint32_t)mti;
  }

  void init_by_array(const uint32_t *key, int key_length) {
    init_genrand(19650218u);
    int i = 1, j = 0;
    int k = 624 > key_length ? 624 : key_length;
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u)) + key[j] +
              (uint32_t)j;
      i++; j++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = 623; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) -
              (uint32_t)i;
      i++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
    }
    mt[0] = 0x80000000u;
    mti = 624;
  }

  // random.Random(seed) for a non-negative int seed < 2**64:
  // key = little-endian 32-bit words of seed (Lib/random.py seed(a, version=2)
  // -> _random.Random.seed(int) -> init_by_array of the int's digits).
  void seed_int(uint64_t seed) {
    uint32_t key[2] = {(uint32_t)(seed & 0xFFFFFFFFu), (uint32_t)(seed >> 32)};
    init_by_array(key, key[1] ? 2 : 1);
  }

  uint32_t genrand() {
    if (mti >= 624) {
      static const uint32_t MAG[2] = {0u, 0x9908B0DFu};
      int kk;
      for (kk = 0; kk < 624 - 397; kk++) {
        uint32_t y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7FFFFFFFu);
        mt[kk] = mt[kk + 397] ^ (y >> 1) ^ MAG[y & 1u];
      }
      for (; kk < 623; kk++) {
        uint32_t y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7FFFFFFFu);
        mt[kk] = mt[kk + (397 - 624)] ^ (y >> 1) ^ MAG[y & 1u];
      }
      uint32_t y = (mt[623] & 0x80000000u) | (mt[0] & 0x7FFFFFFFu);
      mt[623] = mt[396] ^ (y >> 1) ^ MAG[y & 1u];
      mti = 0;
    }
    uint32_t y = mt[mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9D2C5680u;
    y ^= (y << 15) & 0xEFC60000u;
    return y ^ (y >> 18);
  }

  // getrandbits(k) for 0 < k <= 32 (random_getrandbits fast path).
  uint32_t getrandbits(int k) { return genrand() >> (32 - k); }

  // Random._randbelow_with_getrandbits(n), n >= 1.
  int randbelow(int n) {
    if (n <= 1) return 0;
    int k = 0;
    for (int t = n; t; t >>= 1) k++;  // n.bit_length()
    uint32_t r = getrandbits(k);
    while (r >= (uint32_t)n) r = getrandbits(k);
    return (int)r;
  }

  // random.shuffle(x): Fisher-Yates from the top (Lib/random.py shuffle).
  void shuffle(int32_t *x, int n) {
    for (int i = n - 1; i > 0; i--) {
      int j = randbelow(i + 1);
      int32_t t = x[i]; x[i] = x[j]; x[j] = t;
    }
  }
};

// ---------------------------------------------------------------------------
// Card / noble tables (injected once from Python; data-file order ids)
// ---------------------------------------------------------------------------

constexpr int NUM_CARDS = 90, NUM_NOBLES = 10, MAX_DECK = 40;
constexpr int TIER_SIZES[3] = {40, 30, 20};
constexpr int TIER_OFFSETS[3] = {0, 40, 70};
constexpr int GOLD = 5, TOKEN_CAP = 10, TURN_LIMIT = 100;

static int32_t g_cost[NUM_CARDS][5];
static int32_t g_color[NUM_CARDS];
static int32_t g_points[NUM_CARDS];
static int32_t g_tier[NUM_CARDS];
static int32_t g_noble_req[NUM_NOBLES][5];
static int32_t g_noble_pts[NUM_NOBLES];
static int32_t g_combo[10][5];
static int32_t g_default_bank[6];

// ---------------------------------------------------------------------------
// Flat state layout — must match splendax/native/__init__.py STATE_LAYOUT
// ---------------------------------------------------------------------------

struct State {
  int32_t bank[6];
  int32_t tokens[2][6];
  int32_t bonuses[2][5];
  int32_t prestige[2];
  int32_t reserved_ids[2][3];
  int32_t reserved_revealed[2][3];
  int32_t reserved_count[2];
  int32_t player_nobles[2][3];
  int32_t noble_ids[3];
  int32_t board[3][4];
  int32_t deck_perm[3][MAX_DECK];
  int32_t deck_count[3];
  int32_t to_play;
  int32_t turn_count;
  int32_t move_count;
  int32_t game_over;
  int32_t winner;
  int32_t turn_limit_reached;
};
static_assert(sizeof(State) == 194 * 4, "flat state layout drifted");

// Action layout (reference encode.py:12-32).
constexpr int TAKE2_OFF = 10, BUY_VIS_OFF = 15, RES_VIS_OFF = 27,
              RES_BLIND_OFF = 39, BUY_RES_OFF = 42, TOTAL_ACTIONS = 45;

int gold_needed(const State &s, int p, int card_id) {
  int need = 0;
  for (int c = 0; c < 5; c++) {
    int disc = g_cost[card_id][c] - s.bonuses[p][c];
    if (disc < 0) disc = 0;
    int short_ = disc - s.tokens[p][c];
    if (short_ > 0) need += short_;
  }
  return need;
}

void legal_mask(const State &s, int8_t *mask) {
  std::memset(mask, 0, TOTAL_ACTIONS);
  int p = s.to_play;
  int avail[5], n_avail = 0;
  for (int c = 0; c < 5; c++) { avail[c] = s.bank[c] >= 1; n_avail += avail[c]; }
  // Take-3 with the reduced-color rule (rules.py:45-58).
  for (int i = 0; i < 10; i++) {
    bool ok;
    if (n_avail >= 3) {
      ok = true;
      for (int c = 0; c < 5; c++) if (g_combo[i][c] && !avail[c]) { ok = false; break; }
    } else if (n_avail >= 1) {
      ok = true;
      for (int c = 0; c < 5; c++) if (avail[c] && !g_combo[i][c]) { ok = false; break; }
    } else ok = false;
    mask[i] = ok;
  }
  for (int c = 0; c < 5; c++) mask[TAKE2_OFF + c] = s.bank[c] >= 4;
  int gold = s.tokens[p][GOLD];
  for (int i = 0; i < 12; i++) {
    int id = s.board[i / 4][i % 4];
    if (id >= 0) {
      mask[BUY_VIS_OFF + i] = gold >= gold_needed(s, p, id);
      mask[RES_VIS_OFF + i] = s.reserved_count[p] < 3;
    }
  }
  for (int t = 0; t < 3; t++)
    mask[RES_BLIND_OFF + t] = (s.reserved_count[p] < 3) && (s.deck_count[t] > 0);
  for (int i = 0; i < 3; i++)
    if (i < s.reserved_count[p])
      mask[BUY_RES_OFF + i] = gold >= gold_needed(s, p, s.reserved_ids[p][i]);
}

void pay_for_card(State &s, int p, int id) {
  for (int c = 0; c < 5; c++) {
    int disc = g_cost[id][c] - s.bonuses[p][c];
    if (disc < 0) disc = 0;
    int spend = disc < s.tokens[p][c] ? disc : s.tokens[p][c];
    int gold_spent = disc - spend;
    s.tokens[p][c] -= spend;
    s.bank[c] += spend;
    s.tokens[p][GOLD] -= gold_spent;
    s.bank[GOLD] += gold_spent;
  }
  s.bonuses[p][g_color[id]] += 1;
  s.prestige[p] += g_points[id];
}

void refill_slot(State &s, int t, int slot) {
  if (s.deck_count[t] > 0) {
    s.board[t][slot] = s.deck_perm[t][--s.deck_count[t]];
  } else {
    s.board[t][slot] = -1;
  }
}

void take_gold_if_any(State &s, int p) {
  if (s.bank[GOLD] > 0) { s.bank[GOLD]--; s.tokens[p][GOLD]++; }
}

void grant_noble(State &s, int p) {
  // Exactly one noble, first match in display order (rules.py:132-147).
  for (int i = 0; i < 3; i++) {
    int nid = s.noble_ids[i];
    if (nid < 0) continue;
    bool meets = true;
    for (int c = 0; c < 5; c++)
      if (s.bonuses[p][c] < g_noble_req[nid][c]) { meets = false; break; }
    if (meets) {
      s.noble_ids[i] = -1;
      s.prestige[p] += g_noble_pts[nid];
      int slot = 0;
      while (slot < 2 && s.player_nobles[p][slot] >= 0) slot++;
      s.player_nobles[p][slot] = nid;
      return;
    }
  }
}

void auto_return_tokens(State &s, int p) {
  // Deterministic pseudo-random return to the cap (rules.py:150-193).
  int total = 0;
  for (int c = 0; c < 6; c++) total += s.tokens[p][c];
  int k = total - TOKEN_CAP;
  if (k <= 0) return;
  uint64_t seed = ((uint64_t)(uint32_t)s.turn_count * 1315423911ull) ^
                  ((uint64_t)(uint32_t)s.to_play * 2654435761ull);
  // Python int ^: independent on 32-bit words; the later terms are < 2**32
  // so they only touch the low word.
  uint32_t lo = (uint32_t)seed, hi = (uint32_t)(seed >> 32);
  uint32_t sum_tok = 0, sum_bank = 0;
  for (int c = 0; c < 6; c++) { sum_tok += (uint32_t)s.tokens[p][c]; sum_bank += (uint32_t)s.bank[c]; }
  lo ^= sum_tok * 97531u;
  lo ^= sum_bank * 31337u;
  PyRandom rng;
  rng.seed_int(((uint64_t)hi << 32) | lo);
  int remaining = k;
  while (remaining > 0) {
    int choices[5], n = 0;
    for (int c = 0; c < 5; c++) if (s.tokens[p][c] > 0) choices[n++] = c;
    if (n == 0) break;
    int idx = choices[rng.randbelow(n)];  // rng.choice(choices)
    s.tokens[p][idx]--; s.bank[idx]++; remaining--;
  }
  if (remaining > 0 && s.tokens[p][GOLD] > 0) {
    int give = remaining < s.tokens[p][GOLD] ? remaining : s.tokens[p][GOLD];
    s.tokens[p][GOLD] -= give;
    s.bank[GOLD] += give;
  }
}

int compute_winner(const State &s) {
  // (prestige, fewer bonuses, fewer reserved); exact tie -> -1 (rules.py:290-303).
  int b0 = 0, b1 = 0;
  for (int c = 0; c < 5; c++) { b0 += s.bonuses[0][c]; b1 += s.bonuses[1][c]; }
  long a0 = s.prestige[0], a1 = s.prestige[1];
  if (a0 != a1) return a0 > a1 ? 0 : 1;
  if (b0 != b1) return b0 < b1 ? 0 : 1;
  if (s.reserved_count[0] != s.reserved_count[1])
    return s.reserved_count[0] < s.reserved_count[1] ? 0 : 1;
  return -1;
}

void apply_action(State &s, int a) {
  int p = s.to_play;
  if (a < TAKE2_OFF) {
    // Take-3 (reduced): only colors in the combo AND available (rules.py:201-210).
    for (int c = 0; c < 5; c++)
      if (g_combo[a][c] && s.bank[c] >= 1) { s.bank[c]--; s.tokens[p][c]++; }
  } else if (a < BUY_VIS_OFF) {
    int c = a - TAKE2_OFF;
    s.bank[c] -= 2; s.tokens[p][c] += 2;
  } else if (a < RES_VIS_OFF) {
    int off = a - BUY_VIS_OFF, t = off / 4, slot = off % 4;
    pay_for_card(s, p, s.board[t][slot]);
    refill_slot(s, t, slot);
  } else if (a < RES_BLIND_OFF) {
    int off = a - RES_VIS_OFF, t = off / 4, slot = off % 4;
    int cnt = s.reserved_count[p];
    s.reserved_ids[p][cnt] = s.board[t][slot];
    s.reserved_revealed[p][cnt] = 1;
    s.reserved_count[p]++;
    take_gold_if_any(s, p);
    refill_slot(s, t, slot);
  } else if (a < BUY_RES_OFF) {
    int t = a - RES_BLIND_OFF;
    int cnt = s.reserved_count[p];
    s.reserved_ids[p][cnt] = s.deck_perm[t][--s.deck_count[t]];
    s.reserved_revealed[p][cnt] = 0;  // hidden (rules.py:245-246)
    s.reserved_count[p]++;
    take_gold_if_any(s, p);
  } else {
    int idx = a - BUY_RES_OFF;
    int id = s.reserved_ids[p][idx];
    for (int i = idx; i < 2; i++) {  // list pop-with-shift (rules.py:253-254)
      s.reserved_ids[p][i] = s.reserved_ids[p][i + 1];
      s.reserved_revealed[p][i] = s.reserved_revealed[p][i + 1];
    }
    s.reserved_ids[p][2] = -1;
    s.reserved_revealed[p][2] = 0;
    s.reserved_count[p]--;
    pay_for_card(s, p, id);
  }

  // End-of-turn procedure (rules.py:259-287).
  grant_noble(s, p);
  auto_return_tokens(s, p);

  if (s.prestige[p] >= 15) s.game_over = 1;
  s.move_count += 1;
  s.to_play = (s.to_play + 1) % 2;
  s.turn_count = s.move_count / 2 + 1;
  if (s.turn_count >= TURN_LIMIT) {
    s.game_over = 1;
    s.turn_limit_reached = 1;
    s.winner = -1;
  } else if (s.game_over && s.to_play == 0) {
    s.winner = compute_winner(s);
  }
}

void encode_card13(int id, int32_t *out) {
  if (id < 0) { std::memset(out, 0, 13 * 4); return; }
  out[0] = 1; out[1] = g_tier[id]; out[2] = g_points[id];
  for (int c = 0; c < 5; c++) out[3 + c] = (g_color[id] == c);
  for (int c = 0; c < 5; c++) out[8 + c] = g_cost[id][c];
}

void encode_obs(const State &s, int32_t *obs) {
  int p = s.to_play, o = (p + 1) % 2;
  int32_t *w = obs;
  for (int c = 0; c < 6; c++) *w++ = s.bank[c];
  for (int q : {p, o}) {
    for (int c = 0; c < 6; c++) *w++ = s.tokens[q][c];
    for (int c = 0; c < 5; c++) *w++ = s.bonuses[q][c];
    *w++ = s.prestige[q];
    *w++ = s.reserved_count[q];
  }
  for (int i = 0; i < 12; i++) { encode_card13(s.board[i / 4][i % 4], w); w += 13; }
  // Own reserved: always visible, revealed flag forced 1 (encode.py:151-155).
  for (int i = 0; i < 3; i++) {
    int id = (i < s.reserved_count[p]) ? s.reserved_ids[p][i] : -1;
    encode_card13(id, w);
    w[13] = id >= 0 ? 1 : 0;
    w += 14;
  }
  // Opponent reserved: censored unless revealed (encode.py:157-168).
  for (int i = 0; i < 3; i++) {
    int id = (i < s.reserved_count[o]) ? s.reserved_ids[o][i] : -1;
    bool vis = id >= 0 && s.reserved_revealed[o][i];
    encode_card13(vis ? id : -1, w);
    w[13] = vis ? 1 : 0;
    w += 14;
  }
  for (int i = 0; i < 3; i++) {
    int nid = s.noble_ids[i];
    *w++ = nid >= 0;
    for (int c = 0; c < 5; c++) *w++ = nid >= 0 ? g_noble_req[nid][c] : 0;
  }
  for (int t = 0; t < 3; t++) *w++ = s.deck_count[t];
  *w++ = s.turn_count;
  *w++ = s.to_play;
  *w++ = s.move_count;
  *w++ = (s.game_over && s.to_play == 0) ? 1 : 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void spx_init_tables(const int32_t *cost, const int32_t *color,
                     const int32_t *points, const int32_t *tier,
                     const int32_t *noble_req, const int32_t *noble_pts,
                     const int32_t *combo, const int32_t *default_bank) {
  std::memcpy(g_cost, cost, sizeof(g_cost));
  std::memcpy(g_color, color, sizeof(g_color));
  std::memcpy(g_points, points, sizeof(g_points));
  std::memcpy(g_tier, tier, sizeof(g_tier));
  std::memcpy(g_noble_req, noble_req, sizeof(g_noble_req));
  std::memcpy(g_noble_pts, noble_pts, sizeof(g_noble_pts));
  std::memcpy(g_combo, combo, sizeof(g_combo));
  std::memcpy(g_default_bank, default_bank, sizeof(g_default_bank));
}

int spx_state_size(void) { return (int)(sizeof(State) / 4); }

// CPython-parity initial state (reference state.py:181-211).
void spx_initial_state(int64_t seed, int32_t *state_out) {
  State s;
  std::memset(&s, 0, sizeof(s));
  for (int c = 0; c < 6; c++) s.bank[c] = g_default_bank[c];
  for (int q = 0; q < 2; q++)
    for (int i = 0; i < 3; i++) { s.reserved_ids[q][i] = -1; s.player_nobles[q][i] = -1; }
  for (int t = 0; t < 3; t++)
    for (int i = 0; i < MAX_DECK; i++) s.deck_perm[t][i] = -1;
  s.winner = -1;
  s.turn_count = 1;

  PyRandom rng;
  rng.seed_int((uint64_t)seed);
  for (int t = 0; t < 3; t++) {
    int n = TIER_SIZES[t];
    int32_t ids[MAX_DECK];
    for (int i = 0; i < n; i++) ids[i] = TIER_OFFSETS[t] + i;
    rng.shuffle(ids, n);
    for (int slot = 0; slot < 4; slot++) s.board[t][slot] = ids[n - 1 - slot];
    for (int i = 0; i < n - 4; i++) s.deck_perm[t][i] = ids[i];
    s.deck_count[t] = n - 4;
  }
  int32_t nobles[NUM_NOBLES];
  for (int i = 0; i < NUM_NOBLES; i++) nobles[i] = i;
  rng.shuffle(nobles, NUM_NOBLES);
  for (int i = 0; i < 3; i++) s.noble_ids[i] = nobles[i];

  std::memcpy(state_out, &s, sizeof(s));
}

void spx_legal_mask(const int32_t *state, int8_t *mask_out) {
  legal_mask(*(const State *)state, mask_out);
}

void spx_apply_action(int32_t *state, int32_t action) {
  apply_action(*(State *)state, action);
}

void spx_encode_obs(const int32_t *state, int32_t *obs_out) {
  encode_obs(*(const State *)state, obs_out);
}

int spx_is_terminal(const int32_t *state) {
  const State &s = *(const State *)state;
  return s.game_over && s.to_play == 0;
}

// Full env transition with the reference edge-case contract
// (splendor_env.py:51-88).  Returns flags bitmask:
//   1 = terminated, 2 = illegal_action, 4 = draw(stalemate), 8 = turn_limit.
int spx_env_step(int32_t *state, int32_t action, int32_t *obs_out,
                 int8_t *mask_out, double *reward_out) {
  State &s = *(State *)state;
  int8_t mask[TOTAL_ACTIONS];
  legal_mask(s, mask);
  int any_legal = 0;
  for (int i = 0; i < TOTAL_ACTIONS; i++) any_legal |= mask[i];

  int flags = 0;
  double reward = 0.0;
  if (!any_legal) {  // stalemate -> draw (splendor_env.py:56-61)
    s.game_over = 1; s.winner = -1; s.to_play = 0;
    flags |= 1 | 4;
  } else if (action < 0 || action >= TOTAL_ACTIONS || !mask[action]) {
    reward = -0.01;  // illegal no-op (splendor_env.py:64-66)
    flags |= 2;
  } else {
    apply_action(s, action);
    if (s.game_over && s.to_play == 0) {
      flags |= 1;
      int just_moved = (s.to_play + 1) % 2;  // (to_play - 1) mod 2
      if (s.winner < 0)
        reward = s.turn_limit_reached ? -0.1 : 0.0;
      else
        reward = s.winner == just_moved ? 1.0 : -1.0;
      if (s.turn_limit_reached) flags |= 8;
    }
  }
  encode_obs(s, obs_out);
  if (flags & 1) std::memset(mask_out, 0, TOTAL_ACTIONS);
  else legal_mask(s, mask_out);
  *reward_out = reward;
  return flags;
}

// Final rewards for both players (splendor_env.py:92-115).
void spx_final_rewards(const int32_t *state, double *out2) {
  const State &s = *(const State *)state;
  if (s.winner < 0) {
    double r = s.turn_limit_reached ? -0.1 : 0.0;
    out2[0] = r; out2[1] = r;
  } else {
    out2[0] = s.winner == 0 ? 1.0 : -1.0;
    out2[1] = s.winner == 1 ? 1.0 : -1.0;
  }
}

// Play a whole uniform-random-legal game; returns plies played.  Used by the
// throughput smoke and fuzz tests (rng for ACTION CHOICE is a plain LCG —
// distinct from the engine's deterministic MT parity streams).
int spx_random_game(int64_t seed, int max_plies, int32_t *final_state) {
  State s;
  spx_initial_state(seed, (int32_t *)&s);
  uint64_t lcg = (uint64_t)seed * 6364136223846793005ull + 1442695040888963407ull;
  int8_t mask[TOTAL_ACTIONS];
  int32_t obs[297];
  double reward;
  int plies = 0;
  while (plies < max_plies) {
    legal_mask(s, mask);
    int legal[TOTAL_ACTIONS], n = 0;
    for (int i = 0; i < TOTAL_ACTIONS; i++) if (mask[i]) legal[n++] = i;
    int a = 0;
    if (n > 0) {
      lcg = lcg * 6364136223846793005ull + 1442695040888963407ull;
      a = legal[(lcg >> 33) % (uint64_t)n];
    }
    int flags = spx_env_step((int32_t *)&s, a, obs, mask, &reward);
    plies++;
    if (flags & 1) break;
  }
  std::memcpy(final_state, &s, sizeof(s));
  return plies;
}

// ---- Batched host API: N independent games per call -------------------
// Each lane runs the same single-game code as the per-game entry points,
// so batched results are bit-identical to looping them; OpenMP spreads the
// lanes across host threads when available (compiled with -fopenmp).

void spx_initial_state_batch(const int64_t *seeds, int n, int32_t *states_out) {
  const size_t SW = sizeof(State) / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < n; i++)
    spx_initial_state(seeds[i], states_out + (size_t)i * SW);
}

void spx_legal_mask_batch(const int32_t *states, int n, int8_t *masks_out) {
  const size_t SW = sizeof(State) / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < n; i++)
    legal_mask(*(const State *)(states + (size_t)i * SW),
               masks_out + (size_t)i * TOTAL_ACTIONS);
}

void spx_encode_obs_batch(const int32_t *states, int n, int32_t *obs_out) {
  const size_t SW = sizeof(State) / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < n; i++)
    encode_obs(*(const State *)(states + (size_t)i * SW),
               obs_out + (size_t)i * 297);
}

// Env-step every lane with the reference contract (see spx_env_step), except
// lanes with reset_lane[i] != 0, which are REPLACED by a fresh game seeded
// from reset_seeds[i] (their action is ignored, reward 0, flags 0) — the
// gymnasium NEXT_STEP autoreset convention in one call.  reset_lane/
// reset_seeds may be null (no lane resets).  final_rewards_out is [n][2],
// zeros except where a lane terminates this step.
void spx_env_step_batch(int32_t *states, const int32_t *actions,
                        const int8_t *reset_lane, const int64_t *reset_seeds,
                        int n, int32_t *obs_out, int8_t *masks_out,
                        double *rewards_out, int32_t *flags_out,
                        double *final_rewards_out) {
  const size_t SW = sizeof(State) / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < n; i++) {
    int32_t *st = states + (size_t)i * SW;
    int32_t *obs = obs_out + (size_t)i * 297;
    int8_t *mask = masks_out + (size_t)i * TOTAL_ACTIONS;
    final_rewards_out[2 * i] = final_rewards_out[2 * i + 1] = 0.0;
    if (reset_lane && reset_lane[i]) {
      spx_initial_state(reset_seeds[i], st);
      encode_obs(*(const State *)st, obs);
      legal_mask(*(const State *)st, mask);
      rewards_out[i] = 0.0;
      flags_out[i] = 0;
      continue;
    }
    double reward = 0.0;
    int flags = spx_env_step(st, actions[i], obs, mask, &reward);
    rewards_out[i] = reward;
    flags_out[i] = flags;
    if (flags & 1) spx_final_rewards(st, final_rewards_out + 2 * i);
  }
}

}  // extern "C"
