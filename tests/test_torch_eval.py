"""The port's heuristic opponents (`selfplay.opponents`, `eval.noble`) and
eval suite (`eval.suite`) against the JAX package: the deterministic
heuristics exactly, the random ones by their tie sets, `summarize` on the
same arrays, and whole matches from identical deals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.engine.types import GameState as JGameState
from splendax.env import core as jcore
from splendax.eval import noble as jnoble  # noqa: F401  (registers "noble")
from splendax.eval import suite as jsuite
from splendax.selfplay import opponents as jopp
from splendax_torch.engine import rules, state as S
from splendax_torch.engine.encode import encode_observation
from splendax_torch.env import core
from splendax_torch.eval import suite
from splendax_torch.models import actor_critic as ac
from splendax_torch.selfplay import opponents as opp


def jax_state(st):
    return JGameState(**{k: jnp.asarray(v) for k, v in S.to_numpy(st).items()})


@pytest.fixture(scope="module")
def positions():
    """Observations, masks and states from 96 lockstep games played with
    uniformly random legal actions, every 3rd ply of the first 150 (both
    players to move, openings to endgames), finished games left out."""
    B = 96
    gen = torch.Generator().manual_seed(11)
    st, obs, mask = core.reset(B, gen, "cpu")
    keep = []
    for ply in range(150):
        if ply % 3 == 0:
            live = ~st.game_over
            keep.append((obs[live], mask[live], st.map(lambda x: x[live])))
        st, out = core.step(st, opp.uniform_legal_action(mask, gen), mask=mask)
        obs, mask = out.obs, out.action_mask
    obs = torch.cat([k[0] for k in keep])
    mask = torch.cat([k[1] for k in keep])
    state = S.GameState(**{f: torch.cat([getattr(k[2], f) for k in keep]) for f in S.FIELDS})
    assert obs.shape[0] > 2000
    return obs, mask, state


def jax_actions(name, obs, mask, state, key=0):
    fn = jopp.DEVICE_POLICIES[name]
    keys = jax.random.split(jax.random.PRNGKey(key), obs.shape[0])
    return np.asarray(jax.jit(jax.vmap(fn))(
        jnp.asarray(obs.numpy()), jnp.asarray(mask.numpy()), jax_state(state), keys))


@pytest.mark.parametrize("name", ["greedy_v1", "greedy_v2", "noble"])
def test_deterministic_heuristics_equal_jax(positions, name):
    """Exact: the batched policy against `jax.vmap` of the JAX policy on
    the collected positions, plus rows with an empty mask and with only one
    action family legal."""
    obs, mask, state = positions
    extra = mask[:300].clone()
    extra[:50] = False
    for i, (lo, hi) in enumerate(((0, 10), (10, 15), (15, 27), (27, 42), (42, 45))):
        rows = slice(50 + 50 * i, 100 + 50 * i)
        only = torch.zeros(45, dtype=torch.bool)
        only[lo:hi] = True
        extra[rows] &= only
    obs = torch.cat([obs, obs[:300]])
    mask = torch.cat([mask, extra])
    state = S.GameState(**{f: torch.cat([v, v[:300]]) for f, v in state.items()})
    got = suite.heuristic_policy(name)[0](None, obs, mask, state, None)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_actions(name, obs, mask, state))
    # every priority class of the policy was exercised
    groups = np.digitize(got.numpy(), [10, 15, 27, 42])
    assert len(set(groups.tolist())) >= 4


def basic_tie_sets(obs, mask):
    """bool [B, 45]: the actions `basic` may return, by the rule of the JAX
    policy: the visible buys with the most points, else the reserved buys,
    else take-3, take-2, reserve; a row with no legal action gives 0."""
    obs, mask = obs.numpy(), mask.numpy()
    out = np.zeros_like(mask)
    for b in range(mask.shape[0]):
        vis = [a for a in range(15, 27) if mask[b, a]]
        if vis:
            pts = {a: obs[b, 32 + (a - 15) * 13 + 2] for a in vis}
            out[b, [a for a in vis if pts[a] == max(pts.values())]] = True
            continue
        for lo, hi in ((42, 45), (0, 10), (10, 15), (27, 42)):
            if mask[b, lo:hi].any():
                out[b, lo:hi] = mask[b, lo:hi]
                break
        else:
            out[b, 0] = True
    return out


@pytest.mark.parametrize("name", ["random", "basic"])
def test_random_heuristics_stay_in_the_tie_set_and_cover_it(positions, name):
    """The action always lies in the tie set (which the JAX policy's own
    actions lie in too), and over 600 draws a position every member of its
    tie set occurs."""
    obs, mask, state = positions
    ties = mask.numpy().copy() if name == "random" else basic_tie_sets(obs, mask)
    empty = ~mask.numpy().any(1)
    ties[empty, 0] = True
    ja = jax_actions(name, obs, mask, state, key=5)
    assert ties[np.arange(len(ja)), ja].all()
    gen = torch.Generator().manual_seed(2)
    fn = suite.heuristic_policy(name)[0]
    got = fn(None, obs, mask, state, gen).numpy()
    assert ties[np.arange(len(got)), got].all()
    rows = np.r_[0:20, 1000:1020, len(got) - 20:len(got)]
    assert (ties[rows].sum(1) > 1).sum() > 20
    rep = torch.as_tensor(np.repeat(rows, 600))
    draws = fn(None, obs[rep], mask[rep], state.map(lambda x: x[rep]), gen).numpy()
    seen = np.zeros((len(rows), 45), bool)
    seen[np.repeat(np.arange(len(rows)), 600), draws] = True
    np.testing.assert_array_equal(seen, ties[rows])


def test_privileged_flags_and_registry():
    assert set(opp.DEVICE_POLICIES) >= {"random", "greedy_v1", "basic", "greedy_v2"}
    assert suite.is_privileged(suite.heuristic_policy("greedy_v2"))
    for name in ("random", "greedy_v1", "basic", "noble"):
        assert not suite.is_privileged(suite.heuristic_policy(name)), name
    assert "noble" in opp.DEVICE_POLICIES
    model = ac.ActorCritic(8, torch.Generator().manual_seed(0), "cpu")
    assert not suite.is_privileged(suite.model_greedy_policy(model))


def test_summarize_equals_jax():
    rng = np.random.RandomState(0)
    n = 200
    arrays = (rng.choice([1.0, -1.0, -0.1, 0.0], n).astype(np.float32), rng.randint(10, 100, n),
              rng.randint(0, 22, n), rng.randint(0, 2, n), rng.randint(10, 100, n))
    assert suite.summarize(*map(torch.from_numpy, arrays)) == jsuite.summarize(*arrays)
    assert suite.summarize(*arrays) == jsuite.summarize(*arrays)


@pytest.mark.parametrize("agent,opponent", [("greedy_v1", "noble"), ("greedy_v2", "greedy_v1")])
def test_play_matches_equal_jax_from_identical_deals(agent, opponent):
    """Exact: 32 games between deterministic policies from the deals the JAX
    harness makes from its key, handed to the port's harness as a state:
    final rewards, turn counts, last mover's prestige, illegal and check
    counts."""
    n, key = 32, jax.random.PRNGKey(3)
    k_reset, _ = jax.random.split(key)
    jstate, _, _ = jax.vmap(jcore.reset)(jax.random.split(k_reset, n))
    ja, jo = jsuite.heuristic_policy(agent), jsuite.heuristic_policy(opponent)
    want = jsuite._play_matches(ja[0], ja[1], jo[0], jo[1], n, key, "fast")
    pa, po = suite.heuristic_policy(agent), suite.heuristic_policy(opponent)
    state = S.from_numpy({k: np.array(getattr(jstate, k)) for k in S.FIELDS}, device="cpu")
    got = suite._play_matches(pa[0], pa[1], po[0], po[1], n, torch.Generator().manual_seed(0),
                              "fast", state=state)
    assert not np.asarray(want[5]).any() and not got[5].any()
    for name, g, w in zip(("final_r", "turns", "prestige", "illegal", "checks"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert len(set(np.asarray(want[0]).tolist())) > 1  # both sides won games


def test_head_to_head_mirror_is_exactly_half():
    """A policy against itself on paired mirrored deals: 0.5 +- 0, for a
    deterministic heuristic and for a sampling network."""
    model = ac.ActorCritic(16, torch.Generator().manual_seed(1), "cpu")
    for spec in (suite.heuristic_policy("greedy_v1"), suite.model_sampling_policy(model)):
        res = suite.head_to_head(spec, spec, n_games=24, seed=4, device="cpu")
        assert res["score"] == 0.5 and res["score_ci95"] == 0.0
        assert res["n"] == 48 and res["n_pairs"] == 24 and res["paired_deals"]
        assert res["first_seat"]["a_wins"] == res["second_seat"]["a_losses"]
    want_keys = {"n", "n_pairs", "paired_deals", "score", "score_ci95", "wins", "draws", "losses",
                 "win_rate", "privileged", "first_seat", "second_seat"}
    assert set(res) == want_keys


def test_evaluation_suite_and_round_robin_on_cpu():
    """Result dicts keep the JAX package's keys; the greedy model makes no
    illegal move; basic beats random."""
    model = ac.ActorCritic(16, torch.Generator().manual_seed(2), "cpu")
    res = suite.run_evaluation_suite(model, n_games=16, seed=0, device="cpu")
    assert list(res) == ["random", "greedy_v1", "basic", "self"]
    keys = {"n", "wins", "losses", "draws", "win_rate", "win_rate_ci95", "avg_turns",
            "avg_prestige", "illegal_action_rate", "privileged"}
    for r in res.values():
        assert set(r) == keys and r["n"] == 16 and r["illegal_action_rate"] == 0.0
        assert r["wins"] + r["losses"] + r["draws"] == 16
    rr = suite.bot_round_robin([("basic", "random"), ("random", "noble")], n_games=48, device="cpu")
    assert set(rr) == {"basic:random", "random:noble"}
    assert rr["basic:random"]["win_rate"] > 0.7
    seeded = [suite.eval_vs_opponent(suite.heuristic_policy("random"),
                                     suite.heuristic_policy("basic"), 16, seed=9, device="cpu")
              for _ in range(2)]
    assert seeded[0] == seeded[1]


def test_encode_and_mask_of_a_handed_state(positions):
    """`_play_matches(state=...)` starts from the handed state's own obs and
    mask."""
    obs, mask, state = positions
    part = state.map(lambda x: x[:64])
    assert torch.equal(encode_observation(part), obs[:64])
    assert torch.equal(rules.legal_mask(part), mask[:64])
