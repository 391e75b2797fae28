"""Search distillation in the port (`splendax_torch.train.distill`) against
the JAX package's (`splendax.train.distill`) on the CPU.

The tests of `tests/test_distill.py`, mirrored on the port; then the
generation loop in lockstep with JAX's `_generate` on JAX's deals and JAX's
own draws (derived from its keys with `test_torch_search`'s helpers), with
JAX's played actions fed through `play=`; `build_targets` and `distill_fit`
on JAX's dataset and JAX's initial params; the CLI's flags, and its files
read by the other package.

Tolerances.  obs, mask, z and weight are exact (the engine is bit-exact and
the games play the same actions); q on legal actions and the root logits
within rtol/atol 1e-5 (a net of hidden 32 in another order of f32 sums), -inf
exactly where JAX has it; the recorded search argmax equal except where
JAX's two best legal q lie within 2e-5.  `build_targets` is exact;
`distill_fit`'s per-epoch losses within rtol 1e-4 and its params within
rtol/atol 1e-4."""

import argparse
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.models.actor_critic import init_params
from splendax.train import checkpoint as jcheckpoint
from splendax.train import distill as jd
from splendax_torch.engine import state as S
from splendax_torch.models import actor_critic as ac
from splendax_torch.train import distill
from test_torch_search import det_uniforms, playout_draws

A, H = 45, 32
TERMINAL_ALPHABET = [-1.0, -0.1, 0.0, 1.0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The generation loop is thousands of eager ops on a few hundred lanes:
    one intra-op thread runs it faster than many, and far faster while
    other test processes hold the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_net(seed):
    return ac.ActorCritic(H, generator=torch.Generator().manual_seed(seed), device="cpu")


def flat_of(jparams):
    return {f"{h}.{i}.{k}": np.asarray(jparams[h][i][k])
            for h in ("actor", "critic") for i in range(3) for k in ("w", "b")}


def legal_and_argmax(data):
    """The dataset contract on the weighted rows: legal recorded actions,
    outcomes from the terminal alphabet, q -inf exactly on illegal actions,
    its argmax the recorded action."""
    n = data["obs"].shape[0]
    w = data["weight"] > 0
    assert data["mask"][np.arange(n), data["action"]][w].all()
    assert np.isin(np.round(data["z"][w], 2), TERMINAL_ALPHABET).all()
    assert np.isneginf(data["q"][w][~data["mask"][w]]).all()
    assert np.isfinite(data["q"][w][data["mask"][w]]).all()
    assert (data["q"][w].argmax(-1) == data["action"][w]).all()


@pytest.fixture(scope="module")
def tiny_dataset():
    params = port_net(0)
    data, stats = distill.generate_search_games(
        params, torch.Generator().manual_seed(1), n_games=4, rollouts=2, horizon=2, max_plies=100)
    return params, data, stats


# ---- the tests of tests/test_distill.py, on the port --------------------------

def test_generate_shapes_and_targets(tiny_dataset):
    _, data, stats = tiny_dataset
    n = data["obs"].shape[0]
    assert n == 4 * 100
    want = {"obs": ((297,), np.int32), "mask": ((45,), np.bool_), "q": ((45,), np.float32),
            "logits": ((45,), np.float32), "action": ((), np.int32), "z": ((), np.float32),
            "weight": ((), np.float32)}
    assert {k: (v.shape[1:], v.dtype) for k, v in data.items()} == want
    assert stats["n_samples"] > 0, "no game finished within the ply budget"
    assert stats["n_samples"] == data["weight"].sum()
    legal_and_argmax(data)


def test_generate_censored_teacher(tiny_dataset):
    """`censored=True` swaps the teacher for the information-set search:
    the same dataset contract."""
    params, _, _ = tiny_dataset
    data, stats = distill.generate_search_games(
        params, torch.Generator().manual_seed(2), n_games=4, rollouts=2, horizon=2,
        max_plies=100, censored=True)
    assert stats["n_samples"] > 0
    legal_and_argmax(data)
    assert np.isneginf(data["q"][~data["mask"]]).all()


def test_build_targets_modes(tiny_dataset):
    _, data, _ = tiny_dataset
    w = data["weight"] > 0
    for mode, kw in [("gumbel", {}), ("soft", {"tau": 0.2}), ("hard", {})]:
        t = distill.build_targets(data, target=mode, **kw)[w]
        assert t.shape == (int(w.sum()), 45)
        np.testing.assert_allclose(t.sum(-1), 1.0, rtol=1e-5)
        assert (t[~data["mask"][w]] == 0).all(), f"{mode} leaks onto illegal"
    hard = distill.build_targets(data, target="hard")[w]
    assert (hard.argmax(-1) == data["action"][w]).all() and (hard.max(-1) == 1).all()
    soft = distill.build_targets(data, target="soft", tau=0.1)[w]
    assert (soft.argmax(-1) == data["action"][w]).all()
    # With c_scale=0 the gumbel target IS the actor's own masked softmax.
    prior = distill.build_targets(data, target="gumbel", c_scale=0.0)[w]
    ml = np.where(data["mask"][w], data["logits"][w], -1e9)
    ref = np.exp(ml - ml.max(-1, keepdims=True))
    np.testing.assert_allclose(prior, ref / ref.sum(-1, keepdims=True), atol=1e-5)
    with pytest.raises(ValueError, match="unknown target"):
        distill.build_targets(data, target="nope")


def test_generate_weights_are_per_game_prefixes(tiny_dataset):
    """A finished game contributes exactly its live plies: its weight column
    is 1s then 0s, never interleaved."""
    _, data, _ = tiny_dataset
    w = data["weight"].reshape(-1, 4)
    for g in range(4):
        col = w[:, g]
        if col.sum() == 0:
            continue
        last_live = np.max(np.nonzero(col)[0])
        assert col[: last_live + 1].all() and not col[last_live + 1:].any()


def test_distill_moves_actor_toward_search(tiny_dataset):
    params, data, _ = tiny_dataset
    w = data["weight"] > 0
    obs = torch.as_tensor(data["obs"][w])
    mask = torch.as_tensor(data["mask"][w])

    def agreement(model):
        with torch.no_grad():
            pred = ac.greedy_action(model(obs)[0], mask).numpy()
        return (pred == data["action"][w]).mean()

    before = [p.detach().clone() for p in params.parameters()]
    new_params, history = distill.distill_fit(params, data, epochs=4, minibatch=64, lr=1e-3,
                                              seed=0, target="hard")
    assert agreement(new_params) > agreement(params)
    assert history[-1]["ce"] < history[0]["ce"]
    assert history[-1]["v_loss"] < history[0]["v_loss"]
    # The fit trains a copy: the incumbent is left as it was, as the gate needs.
    assert all(torch.equal(a, b) for a, b in zip(before, params.parameters()))


def test_distill_gumbel_target_trains(tiny_dataset):
    params, data, _ = tiny_dataset
    _, history = distill.distill_fit(params, data, epochs=3, minibatch=64, lr=1e-3, seed=0,
                                     target="gumbel")
    assert history[-1]["ce"] < history[0]["ce"]
    assert history[-1]["v_loss"] < history[0]["v_loss"]
    assert set(history[0]) == {"loss", "ce", "v_loss", "agreement"}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CLI on 2 games with `--save-data`: (out dir, src npz)."""
    tmp = tmp_path_factory.mktemp("distill_cli")
    src = tmp / "src.npz"
    ac.export_params_npz(port_net(2), str(src))
    out = tmp / "out"
    distill.main(["--npz", str(src), "--out", str(out), "--games", "2", "--rollouts", "2",
                  "--horizon", "2", "--max-plies", "100", "--epochs", "1", "--minibatch", "32",
                  "--save-data", str(tmp / "data.npz")], device="cpu")
    return out, src


def test_distill_cli_smoke(cli_run):
    out, src = cli_run
    assert (out / "distilled_params.npz").exists()
    res = json.loads((out / "results.json").read_text())
    assert set(res) == {"iterations", "source_npz", "accepted", "config"}
    assert res["source_npz"] == str(src) and res["accepted"] == 1
    (it,) = res["iterations"]
    assert set(it) == {"iter", "generation", "fit_history", "promoted"}
    assert len(it["fit_history"]) == 1 and it["promoted"] is True


def test_generate_chunked_and_sampled(tiny_dataset):
    """gen_batch chunking and opening-move sampling: chunks concatenate;
    sampling changes only the PLAYED actions, so the recorded actions stay
    the search argmax and legal."""
    params, _, _ = tiny_dataset
    data, stats = distill.generate_search_games(
        params, torch.Generator().manual_seed(5), n_games=4, rollouts=2, horizon=2,
        max_plies=80, sample_plies=6, gen_batch=2, drop_dead=True)
    n = data["obs"].shape[0]
    assert n == stats["n_samples"] > 0
    assert (data["weight"] > 0).all()
    assert data["mask"][np.arange(n), data["action"]].all()
    assert (data["q"].argmax(-1) == data["action"]).all()


def test_distill_fit_rejects_empty_dataset(tiny_dataset):
    params, data, _ = tiny_dataset
    dead = {k: (np.zeros_like(v) if k == "weight" else v) for k, v in data.items()}
    with pytest.raises(ValueError, match="no usable samples"):
        distill.distill_fit(params, dead, epochs=1, minibatch=32)
    with pytest.raises(ValueError, match="no usable samples"):
        distill.distill_fit(params, {k: v[:0] for k, v in data.items()}, epochs=1)


def test_distill_cli_gated_loop(tmp_path):
    """--iters with --gate-games: every iteration records a seat-averaged
    gate eval and a promoted flag; the final artifact exists either way."""
    src = tmp_path / "src.npz"
    ac.export_params_npz(port_net(3), str(src))
    out = tmp_path / "out"
    distill.main(["--npz", str(src), "--out", str(out), "--games", "2", "--rollouts", "2",
                  "--horizon", "2", "--max-plies", "80", "--epochs", "1", "--minibatch", "32",
                  "--iters", "2", "--gate-games", "8", "--sample-plies", "4"], device="cpu")
    res = json.loads((out / "results.json").read_text())
    assert len(res["iterations"]) == 2
    for it in res["iterations"]:
        assert "promoted" in it
        assert 0.0 <= it["gate"]["score"] <= 1.0 and it["gate"]["n"] == 16
    assert res["accepted"] == sum(it["promoted"] for it in res["iterations"])
    assert (out / "distilled_params.npz").exists()


@pytest.mark.parametrize("h2h,gate_min,want", [
    ({"score": 0.522, "score_ci95": 0.024}, 0.52, False),  # threshold inside the CI
    ({"score": 0.58, "score_ci95": 0.03}, 0.55, True),  # genuinely better
    ({"score": 0.60, "score_ci95": 0.15}, 0.55, False),  # too few games
    ({"score": 0.5, "score_ci95": 0.0}, 0.5, False),  # mirror-exact
    ({"score": 0.56, "score_ci95": 0.05}, 0.55, True),
    ({"score": 0.54, "score_ci95": 0.01}, 0.55, False),  # below gate_min
])
def test_gate_passes_requires_ci_excluding_half(h2h, gate_min, want):
    assert distill.gate_passes(h2h, gate_min) is want
    assert jd.gate_passes(h2h, gate_min) is want


# ---- lockstep with the JAX package ------------------------------------------------

N_GAMES, K, HZ, PLIES = 4, 2, 2, 100
C_SCALE = 10.0


@functools.lru_cache(maxsize=None)
def jax_net():
    return init_params(jax.random.PRNGKey(0), hidden=H)


@functools.lru_cache(maxsize=None)
def jax_generation(censored, sample_plies):
    """JAX's `_generate` on 4 games -> (its data as numpy [P, B, ...], its
    stats, its key)."""
    key = jax.random.PRNGKey(7 + censored + sample_plies)
    data, stats = jd._generate(jax_net(), key, N_GAMES, K, HZ, PLIES, "fast", True,
                               sample_plies, C_SCALE, censored)
    return ({k: np.asarray(v) for k, v in data.items()},
            {k: float(v) for k, v in stats.items()}, key)


def jax_hooks(censored, sample_plies):
    """JAX's deals, per-ply teacher draws and sampling noise, and the
    actions its games played (the recorded argmax, or on a sampled ply the
    categorical of the recorded scores)."""
    from splendax.env import core as jcore

    data, _, key = jax_generation(censored, sample_plies)
    k_reset, k_run = jax.random.split(key)
    jstate, _, _ = jax.vmap(jcore.reset)(jax.random.split(k_reset, N_GAMES))
    state0 = S.from_numpy({k: np.array(getattr(jstate, k)) for k in S.FIELDS}, device="cpu")
    draws, noise, play = [], [], []
    for ply, k in enumerate(jax.random.split(k_run, PLIES)):
        if censored:
            k_det, k_play = jax.random.split(k)
            draws.append({"det": det_uniforms(jax.random.split(k_det, N_GAMES * K)),
                          "playout": playout_draws(k_play, HZ, N_GAMES * K * A, True)})
        else:
            draws.append(playout_draws(k, HZ, N_GAMES * A * K, True))
        k_sample = jax.random.fold_in(k, 7)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(k_sample, (N_GAMES, A)))))
        a = data["action"][ply]
        if ply < sample_plies:
            mask = jnp.asarray(data["mask"][ply])
            scores = jnp.where(mask, jnp.asarray(data["logits"][ply])
                               + C_SCALE * jnp.where(mask, jnp.asarray(data["q"][ply]), 0.0),
                               -jnp.inf)
            a = np.asarray(jax.random.categorical(k_sample, scores))
        play.append(torch.as_tensor(np.array(a), dtype=torch.int64))
    return state0, draws, noise, play


@pytest.mark.parametrize("censored,sample_plies", [(False, 0), (True, 0), (False, 6)])
def test_generate_matches_jax_in_lockstep(censored, sample_plies):
    want, want_stats, _ = jax_generation(censored, sample_plies)
    state0, draws, noise, play = jax_hooks(censored, sample_plies)
    model = ac.params_from_jax(flat_of(jax_net()), device="cpu")
    data, stats = distill._generate(model, None, N_GAMES, K, HZ, PLIES, "fast", True,
                                    sample_plies, C_SCALE, censored, state0=state0, draws=draws,
                                    noise=noise, play=play)
    got = {k: v.numpy() for k, v in data.items()}
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    for k in ("obs", "mask", "z", "weight"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["weight"].sum() > 0
    legal = want["mask"]
    np.testing.assert_array_equal(np.isneginf(got["q"]), np.isneginf(want["q"]))
    assert np.isneginf(want["q"][~legal]).all()
    np.testing.assert_allclose(got["q"][legal], want["q"][legal], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
    # The search argmax: equal off near ties of JAX's two best legal q.
    top2 = np.sort(np.where(legal, want["q"], -np.inf), axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 2e-5
    differ = got["action"] != want["action"]
    print(f"lockstep (censored={censored}, sample_plies={sample_plies}): {int(near.sum())} "
          f"near-tie plies of {near.size}, {int(differ.sum())} recorded actions differ")
    assert not (differ & ~near).any()
    for k in want_stats:
        assert stats[k].item() == pytest.approx(want_stats[k], rel=1e-6), k


@pytest.mark.parametrize("target", ["gumbel", "soft", "hard"])
def test_build_targets_equal_jax(target):
    data, _, _ = jax_generation(False, 0)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}
    np.testing.assert_array_equal(distill.build_targets(flat, target),
                                  jd.build_targets(flat, target))


def test_distill_fit_matches_jax():
    """2 epochs of minibatch 32 on JAX's dataset from JAX's params, on the
    same numpy permutations: every epoch's losses and the params after."""
    data, _, _ = jax_generation(False, 0)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}
    jparams, jhist = jd.distill_fit(jax_net(), flat, epochs=2, minibatch=32, seed=3)
    model = ac.params_from_jax(flat_of(jax_net()), device="cpu")
    new, hist = distill.distill_fit(model, flat, epochs=2, minibatch=32, seed=3)
    for got, want in zip(hist, jhist):
        for k in ("loss", "ce", "v_loss"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), (k, got, want)
    want = flat_of(jparams)
    for i, layer in enumerate(new.linears()):
        head, j = ac.HEADS[i // 3], i % 3
        np.testing.assert_allclose(layer.weight.detach().numpy().T, want[f"{head}.{j}.w"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(layer.bias.detach().numpy(), want[f"{head}.{j}.b"],
                                   rtol=1e-4, atol=1e-4)


# ---- the CLI and its files ---------------------------------------------------------

class _Parsed(Exception):
    pass


def test_cli_flags_and_defaults_equal_the_jax_cli(monkeypatch):
    """Both CLIs build their parser inside `main`: catch each at parse time."""
    seen = []

    def grab(self, argv=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for fn in (lambda: jd.main([]), lambda: distill.main([], device="cpu")):
        with pytest.raises(_Parsed):
            fn()
    monkeypatch.undo()

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.required,
                         None if a.choices is None else tuple(a.choices), type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    want, got = table(seen[0]), table(seen[1])
    assert got == want


def test_cli_files_load_in_the_other_package(cli_run, tmp_path):
    """A `--save-data` dataset and a `distilled_params.npz` written by either
    package load in the other."""
    out, src = cli_run
    # The port's files in the JAX package: its params, and its dataset
    # through the JAX CLI's --load-data.
    jp = jcheckpoint.import_params_npz(str(out / "distilled_params.npz"))
    mine = ac.import_params_npz(str(out / "distilled_params.npz"), device="cpu")
    np.testing.assert_array_equal(np.asarray(jp["actor"][0]["w"]),
                                  mine.actor[0].weight.detach().numpy().T)
    jout = tmp_path / "jax_out"
    jd.main(["--npz", str(src), "--out", str(jout), "--load-data", str(out.parent / "data.npz"),
             "--epochs", "1", "--minibatch", "32"])
    res = json.loads((jout / "results.json").read_text())
    with np.load(out.parent / "data.npz") as loaded:
        assert res["iterations"][0]["generation"] == json.loads(str(loaded["_stats"]))
    # The JAX package's files in the port: a dataset saved as its CLI saves
    # one, and its distilled params.
    data, stats, _ = jax_generation(False, 0)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}
    np.savez_compressed(tmp_path / "jdata.npz", _stats=json.dumps(stats), **flat)
    pout = tmp_path / "port_out"
    distill.main(["--npz", str(jout / "distilled_params.npz"), "--out", str(pout),
                  "--load-data", str(tmp_path / "jdata.npz"), "--epochs", "1",
                  "--minibatch", "32"], device="cpu")
    res = json.loads((pout / "results.json").read_text())
    assert res["iterations"][0]["generation"] == stats
    assert res["iterations"][0]["fit_history"][0]["loss"] > 0
    jparams = jcheckpoint.import_params_npz(str(jout / "distilled_params.npz"))
    port = ac.import_params_npz(str(jout / "distilled_params.npz"), device="cpu")
    for i, layer in enumerate(port.linears()):
        head, j = ac.HEADS[i // 3], i % 3
        np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                      np.asarray(jparams[head][j]["w"]))


def test_cli_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distill.main(["--npz", "x.npz", "--out", str(tmp_path)])
