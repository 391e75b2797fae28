"""The plain reference at tiny sizes: hand-worked cases, and the frozen engine
and search against the port on the CPU."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import learner, model, search
from benchmark.reference.engine import core as ref_core
from benchmark.reference.engine import encode as ref_encode
from benchmark.reference.engine import ring as ref_ring
from benchmark.reference.engine import rules as ref_rules
from benchmark.reference.engine import state as ref_state

RECIPE = harness.read_json(os.path.join(harness.ROOT, "benchmark", "configs",
                                        "ac_h768.json"))["recipe"]


def test_gae_by_hand():
    """T=2, one game that ends at the first turn: the second turn's delta
    bootstraps from the last value, the first's stops at the end."""
    reward = torch.tensor([[1.0], [0.5]])
    done = torch.tensor([[True], [False]])
    value = torch.tensor([[0.2], [0.3]], dtype=torch.float64)
    last = torch.tensor([0.4], dtype=torch.float64)
    adv, ret = learner.gae(reward, done, value, last, gamma=0.9, lam=0.5)
    a1 = 0.5 + 0.9 * 0.4 - 0.3
    a0 = 1.0 - 0.2  # nonterminal 0 cuts both the bootstrap and the trace
    assert adv[:, 0].tolist() == pytest.approx([a0, a1])
    assert ret[:, 0].tolist() == pytest.approx([a0 + 0.2, a1 + 0.3])
    n = learner.normalise(torch.tensor([1.0, 3.0], dtype=torch.float64))
    assert n.tolist() == pytest.approx([-1 / (1 + 1e-8), 1 / (1 + 1e-8)])


def test_clip_and_adam_by_hand():
    g = [torch.tensor([3.0, 4.0], dtype=torch.float64)]  # norm 5, clipped to 0.5
    clipped = learner.clip_grads(g)
    assert clipped[0].tolist() == pytest.approx([0.3, 0.4])
    p = [torch.zeros(2, dtype=torch.float64)]
    opt = learner.Adam(p)
    opt.step(p, clipped, lr=0.1)
    # Step 1: mu_hat = g, nu_hat = g^2, so each moves by lr * g / (|g| + eps).
    assert p[0].tolist() == pytest.approx([-0.1 * 0.3 / (0.3 + 1e-5), -0.1 * 0.4 / (0.4 + 1e-5)])
    assert learner.clip_grads([torch.tensor([0.1, 0.1])])[0].tolist() == pytest.approx([0.1, 0.1])


def test_anneal_matches_the_committed_log_at_update_3400():
    lr, ent = learner.anneal(RECIPE, 3400)
    assert lr == pytest.approx(2.707840576476883e-05, rel=1e-6)
    assert ent == pytest.approx(0.03 + (0.01 - 0.03) * 3400 / 3813, rel=1e-6)


def test_forward_by_hand():
    """H = 2: weights chosen so each layer's output is known."""
    H = 2
    aw0 = torch.zeros(297, H, dtype=torch.float64)
    aw0[0, 0] = 1.0
    ab0 = torch.zeros(H, dtype=torch.float64)
    aw1 = torch.eye(H, dtype=torch.float64)
    ab1 = torch.zeros(H, dtype=torch.float64)
    aw2 = torch.zeros(H, 45, dtype=torch.float64)
    aw2[0, 3] = 2.0
    ab2 = torch.zeros(45, dtype=torch.float64)
    cw0, cb0, cw1, cb1 = aw0.clone(), ab0.clone(), aw1.clone(), ab1.clone()
    cw2 = torch.zeros(H, 1, dtype=torch.float64)
    cw2[0, 0] = -1.0
    cb2 = torch.full((1,), 0.5, dtype=torch.float64)
    w = [aw0, ab0, aw1, ab1, aw2, ab2, cw0, cb0, cw1, cb1, cw2, cb2]
    obs = torch.zeros(1, 297, dtype=torch.int32)
    obs[0, 0] = 1
    mask = torch.zeros(1, 45, dtype=torch.bool)
    mask[0, 3] = mask[0, 7] = True
    logits, value = model.forward(w, obs, mask)
    h = math.tanh(math.tanh(1.0))
    assert float(logits[0, 3]) == pytest.approx(2 * h)
    assert float(logits[0, 7]) == 0.0 and float(logits[0, 0]) == -1e9
    assert float(value[0]) == pytest.approx(0.5 - h)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000002])
    got = model.round_tf32(x).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


def test_the_frozen_engine_plays_as_the_port(seed=5):
    """Random legal play on 64 games for 80 plies with the ring's autoreset:
    every field, observation, mask and reward equal to the port's."""
    from splendax_torch.env import core, ring
    from splendax_torch.selfplay.opponents import uniform_legal_action

    B = 64
    g_port = torch.Generator().manual_seed(seed)
    g_ref = torch.Generator().manual_seed(seed)
    st_p, obs_p, mask_p = core.reset(B, g_port, "cpu")
    st_r = ref_state.initial_state(B, g_ref, "cpu")
    ring_p = ring.make_ring(2 * B, g_port, "cpu", window=B)
    ring_r = ref_ring.make_ring(2 * B, g_ref, "cpu", window=B)
    assert torch.equal(ring_p.packed, ring_r.packed)
    u = torch.Generator().manual_seed(seed + 1)
    for _ in range(80):
        a = uniform_legal_action(mask_p, u)
        st_p, out_p, obs_p, mask_p, ring_p = ring.step_autoreset_ring(st_p, a, ring_p)
        st_r, out_r, obs_r, mask_r, ring_r = ref_ring.step_autoreset_ring(st_r, a, ring_r)
        for k, v in st_p.items():
            assert torch.equal(v, getattr(st_r, k)), k
        assert torch.equal(obs_p, obs_r) and torch.equal(mask_p, mask_r)
        assert torch.equal(out_p.reward, out_r.reward)
        assert torch.equal(out_p.terminated, out_r.terminated)
        assert torch.equal(obs_r, ref_encode.encode_observation(st_r))
        assert torch.equal(mask_r, ref_rules.legal_mask(st_r))
    assert int(ring_r.ptr) > 0  # games ended and were replaced


def test_the_reference_search_in_float32_chooses_as_the_port():
    """The port's Gumbel search on the CPU (plain float32 forwards) and the
    reference's in float32, from one generator state, pick the same moves;
    in float64 nearly all of them."""
    from splendax_torch.env import core
    from splendax_torch.models.actor_critic import import_params_npz, kernel_weights
    from splendax_torch.search.gumbel import gumbel_search_fn

    npz = os.path.join(harness.ROOT, "runs", "ppo_splendor_2b_h768", "ppo_splendor_params.npz")
    B = 12
    st, obs, mask = core.reset(B, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(11)
    u = torch.Generator().manual_seed(12)
    from splendax_torch.selfplay.opponents import uniform_legal_action

    for _ in range(6):  # some plies in, so the boards differ
        st, out = core.step(st, uniform_legal_action(mask, u))
        obs, mask = out.obs, out.action_mask
    state0 = g.get_state()
    fn = gumbel_search_fn(m=8, k0=4, horizon=2, greedy_final=True)
    port = fn(kernel_weights(import_params_npz(npz, "cpu")), obs, mask, st, g)
    w = model.load_npz(npz, "cpu")
    st_ref = ref_state.GameState(**dict(st.items()))
    picks = {}
    for prec in ("f32", "f64"):
        g.set_state(state0)
        picks[prec] = search.gumbel_search(
            lambda o, m, v, p=prec: model.forward(w, o, m, p, v), obs, mask, st_ref, g, 8, 4, 2,
            greedy_final=True)
    assert torch.equal(picks["f32"], port)
    assert int((picks["f64"] != port).sum()) <= 1
    assert bool(mask.gather(1, port[:, None]).all())


def test_gumbel_noise_is_the_ports():
    from splendax_torch.models.actor_critic import gumbel_noise

    a = gumbel_noise((5, 45), torch.Generator().manual_seed(1), "cpu")
    b = model.gumbel_noise((5, 45), torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a, b) and np.isfinite(b.numpy()).all()


def test_the_frozen_core_step_flags_an_illegal_move():
    st = ref_state.initial_state(2, torch.Generator().manual_seed(0), "cpu")
    mask = ref_rules.legal_mask(st)
    bad = torch.tensor([15, 15])  # buy a visible card with no tokens
    assert not bool(mask[:, 15].any())
    nxt, out = ref_core.step(st, bad)
    assert out.illegal_action.all() and torch.equal(out.reward, torch.full((2,), -0.01))
    assert torch.equal(nxt.bank, st.bank)
