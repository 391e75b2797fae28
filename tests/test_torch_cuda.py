"""The port's CUDA kernels on the card, against their plain versions, and the
rollout through them.  Every test here needs a CUDA device: each carries the
`cuda` marker and skips without one.  This file imports no JAX, so on a GPU
host without JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import engine_ply as ep
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt
from splendax_torch.ops import token_return as tr
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


def numpy_params(rng, hidden):
    out = {}
    for head, n_out in (("actor", 45), ("critic", 1)):
        for i, (fi, fo) in enumerate(((297, hidden), (hidden, hidden), (hidden, n_out))):
            bound = 1.0 / np.sqrt(fi)
            out[f"{head}.{i}.w"] = rng.uniform(-bound, bound, (fi, fo)).astype(np.float32)
            out[f"{head}.{i}.b"] = rng.uniform(-bound, bound, (fo,)).astype(np.float32)
    return out


def check_fused(w, obs, mask):
    """Kernel A with and without value within rtol/atol 1e-5 (f32 accuracy;
    sums in another order) of its plain version; one launch per call."""
    lp, vp = fac.fused_masked_forward_plain(w, obs, mask)
    lp_only, _ = fac.fused_masked_forward_plain(w, obs, mask, with_value=False)
    before = fac.launches
    lk, vk = fac.fused_masked_forward(w, obs, mask)
    lo, vo = fac.fused_masked_forward(w, obs, mask, with_value=False)
    assert fac.launches == before + 2
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lo, lp_only, rtol=1e-5, atol=1e-5)
    assert vo is None and torch.equal(lo, lk)  # the critic does not touch the logits
    return lk


@pytest.mark.cuda
@pytest.mark.parametrize("H", [37, 64, 100, 256, 768, 1024, 1280, 2048])
@pytest.mark.parametrize("B", [1, 17, 31, 33, 257, 2048, 4096, 4097, 4127])
def test_fused_kernel_matches_plain(cuda, H, B):
    """Kernel A against its plain version across the row-tile edges and
    ragged hidden widths (37: padding in K and N; 100: a part pass), with a
    row that has no legal action.  H <= 768 takes the wgmma route, wider
    nets (1024, 1280, 2048) the wide route.  The wgmma route takes 64-row
    tiles and the wide route 128-row ones, ragged at every B here but 2048
    and 4096."""
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    lk = check_fused(w, obs, mask)
    assert (lk[0] > -1e8).all()


@pytest.mark.cuda
def test_fused_kernel_zero_weights(cuda):
    """All-zero weights: logits 0 where legal, -1e9 where not, 0 throughout
    the row with no legal action; value 0."""
    w = [torch.zeros_like(t) for t in ac.kernel_weights(
        ac.params_from_jax(numpy_params(np.random.RandomState(1), 100), device=cuda))]
    rng = np.random.RandomState(2)
    obs = torch.as_tensor(rng.randint(0, 8, size=(33, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(33, 45) < 0.4, device=cuda)
    mask[0] = False
    logits, value = fac.fused_masked_forward(w, obs, mask)
    assert torch.equal(logits, torch.where(mask | ~mask.any(1, keepdim=True), 0.0, -1e9))
    assert torch.equal(value, torch.zeros_like(value))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [257, 4127])
def test_fused_kernel_obs_beyond_tf32(cuda, B):
    """An obs of 4097 is not exact in TF32, so the kernel takes layer 1's
    third product for that block; dropping it would miss by 1 x 1e-3 in the
    first layer.  B = 257 runs 16-row tiles, 4127 32-row tiles."""
    rng = np.random.RandomState(3)
    flat = numpy_params(rng, 256)
    for head in ("actor", "critic"):
        flat[f"{head}.0.w"][0] = rng.uniform(-1e-3, 1e-3, 256).astype(np.float32)
    w = ac.kernel_weights(ac.params_from_jax(flat, device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    obs[B - 57::7, 0] = 4097  # the blocks of the last 57 rows only
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    check_fused(w, obs, mask)


@pytest.mark.cuda
def test_fused_kernel_rejects_bad_input(cuda):
    """A CUDA tensor goes to the kernel or raises; it never falls back."""
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(np.random.RandomState(0), 64), device=cuda))
    obs = torch.zeros((4, 297), dtype=torch.int64, device=cuda)
    mask = torch.ones((4, 45), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fac.fused_masked_forward(w, obs, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("p_done", [0.03, 0.5, 1.0])
def test_ring_take_kernel_matches_plain(cuda, p_done):
    """Exact: kernel B against its plain version, odd B, W=512 (p_done=1.0
    overflows the window)."""
    rng = np.random.RandomState(0)
    W, R, B = 512, 1024, 1023
    packed = torch.as_tensor(rng.randint(-1, 90, size=(R + W, 135)).astype(np.int8), device=cuda)
    done = torch.as_tensor(rng.rand(B) < p_done, device=cuda)
    rank = torch.cumsum(done, 0) - done.long()
    ptr = torch.tensor(700, device=cuda)
    before = rt.launches
    got = rt.take_rows(packed, ptr, rank, W)
    assert rt.launches == before + 1
    assert torch.equal(got, rt.take_rows_plain(packed, ptr, rank, W))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 65, 1000, 8191])
@pytest.mark.parametrize("ptr0", [0, 1, 5, 13, 700, 1023])
def test_ring_take_kernel_edges(cuda, B, ptr0):
    """Exact: kernel B with sources at every 16-byte phase (ptr0), ragged
    last stores and blocks (B), and past the window (all done at B > W = 512
    overflows it)."""
    rng = np.random.RandomState(B + ptr0)
    W, R = 512, 1024
    packed = torch.as_tensor(rng.randint(-1, 90, size=(R + W, 135)).astype(np.int8), device=cuda)
    ptr = torch.tensor(ptr0, device=cuda)
    for p_done in (0.03, 0.5, 1.0):
        done = torch.as_tensor(rng.rand(B) < p_done, device=cuda)
        rank = torch.cumsum(done, 0) - done.long()
        assert torch.equal(rt.take_rows(packed, ptr, rank, W), rt.take_rows_plain(packed, ptr, rank, W))


@pytest.mark.cuda
def test_ring_take_kernel_gathers_any_rank(cuda):
    """Exact for ranks that are no prefix sum and for a `packed` view that is
    not 16-byte aligned; a width other than 135 raises."""
    rng = np.random.RandomState(4)
    W, R, B = 512, 1024, 777
    full = torch.as_tensor(rng.randint(-1, 90, size=(R + W + 1, 135)).astype(np.int8), device=cuda)
    rank = torch.as_tensor(rng.randint(0, 2 * W, size=B), device=cuda)
    ptr = torch.tensor(300, device=cuda)
    for packed in (full[:-1], full[1:]):
        assert torch.equal(rt.take_rows(packed, ptr, rank, W), rt.take_rows_plain(packed, ptr, rank, W))
    with pytest.raises(ValueError, match="135"):
        rt.take_rows(full[:, :134].contiguous(), ptr, rank, W)


@pytest.mark.cuda
def test_rollout_runs_through_both_kernels(cuda):
    cfg = PPOConfig(num_envs=256, num_steps=8, hidden=64, pool_size=3)
    ts = ppo.init_train_state(cfg, device=cuda)
    a0, b0 = fac.launches, rt.launches
    ts, traj = ppo.rollout(cfg, ts)
    assert fac.launches > a0 and rt.launches - b0 == cfg.num_steps
    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    assert bool((legal | ~traj.mask.any(-1)).all())
    assert int(traj.overflow) == 0


@pytest.mark.cuda
def test_fused_kernel_at_the_eval_shape(cuda):
    """Kernel A at the eval suite's shape: B=256 (the league recipe's
    eval_games), H=768, no value."""
    rng = np.random.RandomState(6)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, 768), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(256, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(256, 45) < 0.4, device=cuda)
    check_fused(w, obs, mask)


@pytest.mark.cuda
def test_ppo_loss_gradients_on_the_card_match_float64(cuda):
    """The loss and its 12 gradients on the card in float32 against the CPU
    in float64: rtol 1e-4, atol 1e-5 of each tensor's largest entry."""
    import copy

    rng = np.random.RandomState(7)
    B = 2048
    model = ac.params_from_jax(numpy_params(rng, 256), device=cuda)
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    mask[1:, 0] |= ~mask[1:].any(1)
    action = torch.argmax(mask.int() * torch.as_tensor(rng.rand(B, 45), device=cuda), dim=-1)
    with torch.no_grad():
        logp, _ = ac.log_prob_entropy(model(obs)[0], mask, action)
    floats = [logp + torch.as_tensor(0.3 * rng.randn(B), dtype=torch.float32, device=cuda)] + [
        torch.as_tensor(rng.randn(B), dtype=torch.float32, device=cuda) for _ in range(3)]
    cfg = PPOConfig()
    loss, aux = ppo.ppo_loss(cfg, 0.02, model, obs, mask, action, *floats)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    model64 = copy.deepcopy(model).cpu().double()
    loss64, aux64 = ppo.ppo_loss(cfg, 0.02, model64, obs.cpu(), mask.cpu(), action.cpu(),
                                 *[f.cpu().double() for f in floats])
    grads64 = torch.autograd.grad(loss64, list(model64.parameters()))
    for got, want in zip((loss, *aux, *grads), (loss64, *aux64, *grads64)):
        torch.testing.assert_close(got.detach().cpu().double(), want.detach(), rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_update_step_on_the_card(cuda):
    """One whole update on the card: the rollout and the bootstrap value go
    through kernel A, the autoreset through kernel B, the params move, and
    the first minibatch's approx-KL (kernel log-probs against the autograd
    forward's) stays below 1e-4 at lr 0."""
    cfg = PPOConfig(num_envs=256, num_steps=8, hidden=64, pool_size=3, minibatch_size=512,
                    update_epochs=2, total_timesteps=256 * 8 * 4)
    ts = ppo.init_train_state(cfg, device=cuda)
    before = [p.detach().clone() for p in ts.params.parameters()]
    a0, b0 = fac.launches, rt.launches
    ts, m = ppo.update_step(cfg, ts)
    assert fac.launches - a0 >= cfg.num_steps + 1 and rt.launches - b0 == cfg.num_steps
    assert all(torch.isfinite(v).item() and v.is_cuda for v in m.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, ts.params.parameters()))
    assert ts.update_idx == 1 and ts.opt_state.count > 0
    probe = cfg.replace(lr=0.0, update_epochs=1, minibatch_size=cfg.batch_size)
    ts, m = ppo.update_step(probe, ts)
    assert abs(m["approx_kl"].item()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 768])
def test_fused_kernel_at_the_search_lane_batch(cuda, H):
    """Kernel A at the league slot's lane batch, B = 1024 rows x m=8 x k0=4 =
    32768, with value (the leaves) and without (the playout moves)."""
    rng = np.random.RandomState(8)
    B = 32768
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[5] = False
    check_fused(w, obs, mask)


def _midgame(B, plies, seed):
    """B games after `plies` uniformly random legal plies, on the CPU."""
    from splendax_torch.env import core
    from splendax_torch.selfplay.opponents import uniform_legal_action

    g = torch.Generator().manual_seed(seed)
    st, obs, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        st, out = core.step(st, uniform_legal_action(mask, g), mask=mask)
        obs, mask = out.obs, out.action_mask
    return st, obs, mask


@pytest.mark.cuda
@pytest.mark.parametrize("censored", [False, True])
def test_gumbel_search_on_the_card_equals_the_cpu(cuda, censored):
    """Without a network, on the same draws: actions and mean values of the
    Gumbel search (m=8 k0=2 horizon 2) on the card equal the CPU's exactly."""
    from splendax_torch.search import gumbel, ismc

    B, m, k0, hz = 64, 8, 2, 2
    g = torch.Generator().manual_seed(3)
    st, obs, mask = _midgame(B, 41, 4)
    rounds = m.bit_length() - 1
    draws = {"g": gumbel.gumbel_noise((B, 45), g, "cpu"),
             "playout": [[torch.rand(B * m * k0, generator=g) for _ in range(hz)]
                         for _ in range(rounds)],
             "det": [torch.rand((B * (m * k0 // (m >> r)), 3, ismc.EXT), generator=g)
                     for r in range(rounds)]}
    on_card = {"g": draws["g"].to(cuda), "playout": [[u.to(cuda) for u in r] for r in draws["playout"]],
               "det": [u.to(cuda) for u in draws["det"]]}
    fn = gumbel.gumbel_search_fn(m=m, k0=k0, horizon=hz,
                                 determinize_fn=ismc.determinize if censored else None)
    info_c, info_g = {}, {}
    a_c = fn(None, obs, mask, st, draws=draws, info=info_c)
    a_g = fn(None, obs.to(cuda), mask.to(cuda), st.map(lambda x: x.to(cuda)), draws=on_card,
             info=info_g)
    assert torch.equal(a_c, a_g.cpu()) and torch.equal(info_c["q_hat"], info_g["q_hat"].cpu())
    assert bool((mask.gather(1, a_c[:, None])[:, 0] | ~mask.any(1)).all())


@pytest.mark.cuda
def test_league_update_on_the_card(cuda):
    """One update with the static league slot on the card: per turn kernel A
    runs for the agent, for 1 to 3 pool slots, and 1 + rounds * (horizon + 1)
    times in the search; kernel B once; the metrics are finite."""
    cfg = PPOConfig(num_envs=256, num_steps=8, hidden=64, pool_size=3, minibatch_size=512,
                    update_epochs=1, total_timesteps=256 * 8 * 4, search_opponent=True,
                    search_static=True, p_search=0.125, search_m=4, search_k0=2, search_horizon=2)
    ts = ppo.init_train_state(cfg, device=cuda)
    a0, b0 = fac.launches, rt.launches
    ts, m = ppo.update_step(cfg, ts)
    per_search = 1 + 2 * (cfg.search_horizon + 1)
    T = cfg.num_steps
    assert T * (2 + per_search) + 1 <= fac.launches - a0 <= T * (4 + per_search) + 1
    assert rt.launches - b0 == T
    assert all(torch.isfinite(v).item() for v in m.values())
    assert int((ts.opp_idx == cfg.pool_size + 1).sum()) == cfg.n_search_static == 32


@pytest.mark.cuda
def test_parity_mode_on_the_card_equals_the_cpu(cuda):
    """The engine in parity mode (MT19937 token return) on the card against
    the CPU: 60 plies x 128 games, every field exact, with token returns."""
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state_parity
    from splendax_torch.env import core

    B = 128
    st_c = initial_state_parity(range(B), "cpu")
    st_g = st_c.map(lambda x: x.to(cuda))
    rng = np.random.RandomState(9)
    returns = 0
    for ply in range(60):
        mask = rules.legal_mask(st_c)
        m = mask.numpy()
        a = torch.as_tensor(np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0))
        held = st_c.tokens[torch.arange(B), st_c.to_play.long()].sum(1)
        returns += int(((held == 10) & (a < 15) & mask.any(1)).sum())
        st_c, _ = core.step(st_c, a, rng_mode="parity", mask=mask)
        st_g, _ = core.step(st_g, a.to(cuda), rng_mode="parity")
        for name, x in st_c.items():
            assert torch.equal(x, getattr(st_g, name).cpu()), f"{name} at ply {ply}"
    assert returns > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 255, 8192, 36000])
def test_token_return_kernel_matches_plain(cuda, B):
    """Exact: the step kernel's token return (`csrc/token_return.cuh`)
    against `return_tokens_plain` on fuzzed hands (`_token_hands`: every k
    from 0 to 12 at the larger B, gold-only hands, colours that run out,
    hands past 22 that use up all 12 draws, either player to move, turns up
    to 2**20).  Each hand's game reserves a visible card with no gold in the
    bank, a move that leaves the tokens as they are, so the kernel's return
    is of the fuzzed hand itself; the whole next state equals
    `apply_action_plain`'s.  One launch, nothing written in place."""
    from _token_hands import fuzzed_hands
    from splendax_torch.engine import data as D
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state

    h = {k: torch.from_numpy(v).to(cuda) for k, v in fuzzed_hands(np.random.RandomState(B), B).items()}
    h["bank"][:, D.GOLD] = 0
    st = initial_state(B, torch.Generator(device=cuda).manual_seed(B), cuda).replace(**h)
    keep = st.map(lambda x: x.clone())
    a = torch.full((B,), rules.RESERVE_VISIBLE_OFFSET, dtype=torch.int64, device=cuda)
    want = tr.return_tokens_plain(**h)
    before = ep.launches["step"]
    got = rules.apply_action(st, a)
    assert ep.launches["step"] == before + 1
    assert torch.equal(got.tokens, want[0]) and torch.equal(got.bank, want[1])
    _same_state(got, rules.apply_action_plain(st, a), "a reserve over fuzzed hands")
    _same_state(st, keep, "the input")  # nothing written in place
    if B >= 8192:
        k = (h["tokens"][torch.arange(B, device=cuda), h["to_play"].long()].sum(1) - 10).clamp(min=0)
        assert set(range(13)) <= set(k.tolist()) and int((k > 12).sum()) > 0


@pytest.mark.cuda
def test_fast_mode_on_the_card_equals_the_cpu(cuda):
    """The engine in fast mode (threefry token return; on the card the ply's
    kernel) on the card against the CPU: 60 plies x 128 games, every field
    exact, with token returns, and one kernel launch a ply (the ply's, which
    draws the token return itself)."""
    from splendax_torch.engine.state import initial_state
    from splendax_torch.engine import rules
    from splendax_torch.env import core

    B = 128
    st_c = initial_state(B, torch.Generator().manual_seed(9), "cpu")
    st_g = st_c.map(lambda x: x.to(cuda))
    rng = np.random.RandomState(9)
    returns = 0
    before_ply = ep.launches["step"]
    for ply in range(60):
        mask = rules.legal_mask(st_c)
        m = mask.numpy()
        a = torch.as_tensor(np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0))
        held = st_c.tokens[torch.arange(B), st_c.to_play.long()].sum(1)
        returns += int(((held == 10) & (a < 15) & mask.any(1)).sum())
        st_c, _ = core.step(st_c, a, mask=mask)
        st_g, _ = core.step(st_g, a.to(cuda))
        for name, x in st_c.items():
            assert torch.equal(x, getattr(st_g, name).cpu()), f"{name} at ply {ply}"
    assert returns > 0
    assert ep.launches["step"] - before_ply == 60


@pytest.mark.cuda
def test_ring_autoreset_on_the_card_equals_the_cpu(cuda):
    """`env/ring.step_autoreset_ring` in fast mode on the card (the step
    kernel with the next state's obs, then the observe kernel's select: two
    launches a ply) against the CPU's plain functions: 150 plies x 256 games
    through the ring, the carried state, every output field (the terminal
    obs and mask too), the next obs and mask and the ring's pointer exact,
    with games ending."""
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import ring as ring_lib

    B, plies = 256, 150
    gen = torch.Generator().manual_seed(4)
    cpu_ring = ring_lib.make_ring(4 * B, gen, "cpu", window=B)
    st_c = initial_state(B, gen, "cpu")
    gpu_ring = cpu_ring.replace(**{k: getattr(cpu_ring, k).to(cuda)
                                   for k in ("packed", "mask0", "ptr", "overflow")})
    st_g = st_c.map(lambda x: x.to(cuda))
    rng = np.random.RandomState(4)
    mask_c, finished = rules.legal_mask(st_c), 0
    launched = dict(ep.launches)
    for ply in range(plies):
        m = mask_c.numpy()
        a = torch.as_tensor(np.where(m.any(1), (rng.rand(B, 45) * m).argmax(1), 0))
        st_c, out_c, obs_c, mask_c, cpu_ring = ring_lib.step_autoreset_ring(st_c, a, cpu_ring)
        st_g, out_g, obs_g, mask_g, gpu_ring = ring_lib.step_autoreset_ring(
            st_g, a.to(cuda), gpu_ring)
        _same_state(st_g.map(lambda x: x.cpu()), st_c, f"carry at ply {ply}")
        for k in vars(out_c):
            assert torch.equal(getattr(out_g, k).cpu(), getattr(out_c, k)), f"{k} at ply {ply}"
        assert torch.equal(obs_g.cpu(), obs_c) and torch.equal(mask_g.cpu(), mask_c), ply
        assert torch.equal(gpu_ring.ptr.cpu(), cpu_ring.ptr), ply
        finished += int(out_c.terminated.sum())
    assert finished > 0
    assert ep.launches == {"step": launched["step"] + plies, "observe": launched["observe"] + plies}


@pytest.mark.cuda
def test_token_return_launches_once_per_fast_apply(cuda, monkeypatch):
    """Each fast-mode `apply_action` on the card is one launch of the ply's
    step kernel, which draws the token return itself, over one league update
    with the static search slot (the plies, the search's children and
    playouts); a parity update launches neither."""
    calls = []
    inner = ep.step

    def counted(state, *args, **kw):
        calls.append(state.to_play.shape[0] > 0)
        return inner(state, *args, **kw)

    monkeypatch.setattr(ep, "step", counted)
    for mode, extra in (("fast", dict(search_opponent=True, search_static=True)),
                        ("parity", dict(rng_mode="parity"))):
        cfg = PPOConfig(num_envs=256, num_steps=4, hidden=64, pool_size=3, minibatch_size=512,
                        update_epochs=1, total_timesteps=256 * 4 * 4, search_m=4, search_k0=2,
                        search_horizon=2, **extra)
        ts = ppo.init_train_state(cfg, device=cuda)
        calls.clear()
        before = ep.launches["step"]
        ppo.update_step(cfg, ts)
        assert ep.launches["step"] - before == sum(calls)
        if mode == "fast":
            assert ep.launches["step"] - before > 2 * cfg.num_steps
        else:
            assert len(calls) == 0


def check_wgmma(w, obs, mask, route="wgmma"):
    """Kernel A with and without value within rtol/atol 1e-5 of the plain
    forward in float64; one launch a call, on `route`, and one weight
    preparation a call."""
    w64 = [t.double() for t in w]
    before = (dict(fac.launches_by_route), fac.prep_launches)
    outs = [fac.fused_masked_forward(w, obs, mask, with_value=v) for v in (True, False)]
    torch.cuda.synchronize()
    n_prep = 2
    assert fac.launches_by_route[route] == before[0][route] + 2
    assert fac.prep_launches == before[1] + n_prep
    for (lk, vk), v in zip(outs, (True, False)):
        lr, vr = fac.fused_masked_forward_plain(w64, obs, mask, with_value=v)
        torch.testing.assert_close(lk.double(), lr, rtol=1e-5, atol=1e-5)
        if v:
            torch.testing.assert_close(vk.double(), vr, rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0][0], outs[1][0])  # the critic does not touch the logits
    return outs[0][0]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [37, 100, 256, 768])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 4097, 32768])
def test_wgmma_route_matches_float64(cuda, H, B):
    """The wgmma route against the float64 plain forward at rtol/atol 1e-5
    around its 64-row tile (63, 64, 65) and at the search's 32768 rows, at
    ragged widths (37, 100) and the committed nets' (256, 768)."""
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    lk = check_wgmma(w, obs, mask)
    assert (lk[0] > -1e8).all()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [100, 768])
def test_wgmma_route_obs_beyond_tf32(cuda, H):
    """Obs of 4097 are not exact in TF32: their tiles take layer 1's third
    product (lo hi), which would miss by 1 x 1e-3 in the first layer."""
    rng = np.random.RandomState(H)
    flat = numpy_params(rng, H)
    for head in ("actor", "critic"):
        flat[f"{head}.0.w"][0] = rng.uniform(-1e-3, 1e-3, H).astype(np.float32)
    w = ac.kernel_weights(ac.params_from_jax(flat, device=cuda))
    B = 4127
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    obs[B - 100::9, 0] = 4097  # the last two tiles only
    obs[5, 3] = -3000
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    check_wgmma(w, obs, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [37, 768])
def test_wgmma_route_zero_weights(cuda, H):
    """All-zero weights: logits 0 where legal, -1e9 where not, 0 throughout
    the row with no legal action; value 0."""
    w = [torch.zeros_like(t) for t in ac.kernel_weights(
        ac.params_from_jax(numpy_params(np.random.RandomState(1), H), device=cuda))]
    rng = np.random.RandomState(2)
    obs = torch.as_tensor(rng.randint(0, 8, size=(65, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(65, 45) < 0.4, device=cuda)
    mask[0] = False
    logits, value = fac.fused_masked_forward(w, obs, mask)
    assert torch.equal(logits, torch.where(mask | ~mask.any(1, keepdim=True), 0.0, -1e9))
    assert torch.equal(value, torch.zeros_like(value))


@pytest.mark.cuda
@pytest.mark.parametrize("with_value", [True, False])
@pytest.mark.parametrize("H", [37, 64, 100, 256, 768, 769, 1024, 1280, 2048])
def test_prep_kernel_equals_plain_bit_for_bit(cuda, H, with_value):
    """The prep kernel's split and transpose equals `prepare_weights_plain`
    bit for bit (without the critic, on the actor's half, which is all the
    kernel writes then), at the wgmma route's widths and the wide route's,
    ragged (37, 100, 769: 4-byte loads) and 16-byte aligned; one launch a
    call."""
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(np.random.RandomState(H), H),
                                             device=cuda))
    before = fac.prep_launches
    got = fac.prepare_weights(w, with_value)
    assert fac.prep_launches == before + 1
    want = fac.prepare_weights_plain(w, with_value)
    n = want.numel() if with_value else fac.prepared_layout(H)[2][0]
    assert torch.equal(got[:n], want[:n])


@pytest.mark.cuda
def test_prep_kernel_on_a_misaligned_weight(cuda):
    """A weight 4 bytes off 16-byte alignment takes the kernel's 4-byte
    loads, to the same bits."""
    H = 256
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(np.random.RandomState(3), H),
                                             device=cuda))
    w[2] = torch.empty(H * H + 1, device=cuda)[1:].view(H, H).copy_(w[2])
    assert w[2].data_ptr() % 16 == 4
    assert torch.equal(fac.prepare_weights(w), fac.prepare_weights_plain(w))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 768, 1024])
def test_prepared_handle_on_the_card(cuda, H):
    """A forward on a `PreparedWeights` handle equals the forward on its
    plain list bit for bit, with and without value and in every mode of
    its route; the handle prepares once, and again after an in-place write
    to a weight it read; on another stream it waits for its preparation."""
    rng = np.random.RandomState(H)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    h = fac.PreparedWeights(w)
    obs = torch.as_tensor(rng.randint(0, 8, size=(1000, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(1000, 45) < 0.4, device=cuda)
    r = fac.route(H)
    modes = fac.launches_by_mode if r == "wgmma" else fac.launches_by_wide_mode
    before = fac.prep_launches
    for step in range(2):
        for with_value in (True, False):
            for m in modes:
                got = fac._launch(r, h, obs, mask, with_value, mode=m)
                want = fac._launch(r, w, obs, mask, with_value, mode=m)
                assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, want))
        assert h.preparations == step + 1
        w[2].add_(1e-3)  # aw1, in place
    assert fac.prep_launches == before + 2 + 2 * 2 * len(modes)
    side = torch.cuda.Stream()
    w[0].mul_(0.5)
    torch.cuda.synchronize()  # all but the preparation below is done
    h.buffer()  # prepared on the current stream
    with torch.cuda.stream(side):
        got = fac.fused_masked_forward(h, obs, mask)
    torch.cuda.synchronize()
    want = fac.fused_masked_forward(w, obs, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 768])
def test_wgmma_rows_do_not_depend_on_b(cuda, H):
    """Rows split into calls as a dp rank or a pool slot splits them (1000 +
    7192, 4096 + 4096), and across the cluster mode's threshold and its
    tiles' edges (1 + 8191, 64 + 8128, 512 + 7680, 2048 + 6144, 4095 + 4097:
    a small call in cluster mode, the rest in tile mode), equal the B=8192
    call bit for bit."""
    rng = np.random.RandomState(H)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(8192, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(8192, 45) < 0.4, device=cuda)
    whole = fac.fused_masked_forward(w, obs, mask)
    before = dict(fac.launches_by_mode)
    for cut in (1000, 4096, 1, 64, 512, 2048, 4095):
        parts = [fac.fused_masked_forward(w, obs[a:b].contiguous(), mask[a:b].contiguous())
                 for a, b in ((0, cut), (cut, 8192))]
        for j in (0, 1):
            assert torch.equal(torch.cat([p[j] for p in parts]), whole[j])
    assert all(fac.launches_by_mode[m] > before[m] for m in before)  # both modes ran


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 100, 256, 768])
@pytest.mark.parametrize("B", [1, 63, 65, 1000, 4097])
def test_wgmma_modes_agree_bit_for_bit(cuda, H, B):
    """The tile and the cluster mode, forced on the same rows, give the same
    bits, with and without value, at widths of one pass (1, 100), of two
    (256) and of six (768), on ragged tiles; one launch each, counted by
    mode; within rtol/atol 1e-5 of the float64 plain forward."""
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    obs[B // 2, 7] = 4097  # a tile that takes layer 1's third product
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    w64 = [t.double() for t in w]
    for with_value in (True, False):
        before = dict(fac.launches_by_mode)
        tile = fac._launch("wgmma", w, obs, mask, with_value, mode="tile")
        cluster = fac._launch("wgmma", w, obs, mask, with_value, mode="cluster")
        torch.cuda.synchronize()
        assert {m: fac.launches_by_mode[m] - before[m] for m in before} == {"tile": 1, "cluster": 1}
        ref = fac.fused_masked_forward_plain(w64, obs, mask, with_value)
        for a, b, r in zip(tile, cluster, ref):
            if r is None:
                assert a is None and b is None
                continue
            assert torch.equal(a, b)
            torch.testing.assert_close(a.double(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_refused_cluster_launch_raises(cuda, tmp_path):
    """A cluster-mode launch that the card refuses (a build that asks for
    more shared memory than a block may have) raises through the wrapper,
    and nothing else runs in its place: no counter moves and the outputs of
    a forward that did not run are never returned."""
    import ctypes

    from splendax_torch.ops import _build

    lib = tmp_path / "libwgmma_refused.so"
    _build.compile_many({"refused": (_build.CSRC / "fused_actor_critic_wgmma.cu", lib,
                                     ("-DPROBE_SMEM_EXTRA=65536",))})
    refused = fac.bind(ctypes.CDLL(str(lib)))
    rng = np.random.RandomState(5)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, 768), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(256, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(256, 45) < 0.4, device=cuda)
    prepared = fac.prepare_weights(w)
    counts = fac.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fac._launch("wgmma", w, obs, mask, True, prepared, lib=refused, mode="cluster")
    torch.cuda.synchronize()
    assert fac.launch_counts() == counts
    # The same build's tile mode, and the library's own cluster mode, still run.
    tile = fac._launch("wgmma", w, obs, mask, True, prepared, lib=refused, mode="tile")
    assert torch.equal(tile[0], fac._launch("wgmma", w, obs, mask, True, mode="cluster")[0])


def wide_net(cuda, H, source):
    """Kernel A's weights at width H: the committed h1024 net, or seeded
    random ones."""
    if source == "h1024":
        path = os.path.join(ROOT, "runs/ppo_splendor_2b_h1024/ppo_splendor_params.npz")
        return ac.kernel_weights(ac.import_params_npz(path, device=cuda))
    return ac.kernel_weights(ac.params_from_jax(numpy_params(np.random.RandomState(H), H),
                                                device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("H, source", [(1024, "h1024"), (1024, "random"), (1280, "random")])
def test_wide_net_takes_the_wide_route(cuda, H, source):
    """Past the wgmma route's 768 the wide route takes every forward, held to
    the same float64 contract, with one weight preparation a call: engine-
    like obs around the row tile's edges, and obs of 4097 in the last tiles
    (layer 1's third product)."""
    w = wide_net(cuda, H, source)
    assert w[0].shape[1] == H and fac.route(H) == "wide"
    rng = np.random.RandomState(H)
    for B in (1, 63, 65, 257, 4127):
        obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
        obs[max(B - 100, 0)::9, 0] = 4097
        mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
        mask[0] = False
        lk = check_wgmma(w, obs, mask, route="wide")
        assert (lk[0] > -1e8).all()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1024, 2048])
def test_wide_route_back_to_back_on_one_scratch(cuda, H, monkeypatch):
    """Launches in a row on one scratch: the wrapper's chunks (WIDE_MAX_ROWS
    cut to 64 and to 1000) at many B, on different rows each, within
    rtol/atol 1e-5 of the float64 plain forward and bit-equal to the call in
    one chunk: each launch's layer 1 overwrites h1 while nothing may still
    read the chunk before's, and each layer 2 must read the h1 its own
    layer 1 wrote (a missing order between the stores and the TMA loads of
    h1 would show as stale rows now and then)."""
    w = wide_net(cuda, H, "random")
    w64 = [t.double() for t in w]
    rng = np.random.RandomState(7)
    for B in (1, 64, 65, 1000, 2049, 8192):
        for _ in range(3):
            obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
            mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
            whole = fac._launch("wide", w, obs, mask, True)
            lr, vr = fac.fused_masked_forward_plain(w64, obs, mask)
            for rows in (64, 1000):
                monkeypatch.setattr(fac, "WIDE_MAX_ROWS", rows)
                lk, vk = fac._launch("wide", w, obs, mask, True)
                monkeypatch.undo()
                torch.testing.assert_close(lk.double(), lr, rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(vk.double(), vr, rtol=1e-5, atol=1e-5)
                assert torch.equal(lk, whole[0]) and torch.equal(vk, whole[1])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [769, 1024, 1100, 1280, 2048])
@pytest.mark.parametrize("B", [1, 16, 127, 129, 1024, 4097])
def test_wide_modes_agree_bit_for_bit(cuda, H, B):
    """The wide route's pass and half modes, forced on the same rows, give
    the same bits, with and without value, on ragged tiles and at widths
    whose last pass is part padding (769, 1100); one launch each, counted
    by mode; within rtol/atol 1e-5 of the float64 plain forward."""
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    obs[B // 2, 7] = 4097  # a tile that takes layer 1's third product
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    w64 = [t.double() for t in w]
    for with_value in (True, False):
        before = dict(fac.launches_by_wide_mode)
        full = fac._launch("wide", w, obs, mask, with_value, mode="pass")
        half = fac._launch("wide", w, obs, mask, with_value, mode="half")
        torch.cuda.synchronize()
        assert {m: fac.launches_by_wide_mode[m] - before[m] for m in before} == {"pass": 1,
                                                                                 "half": 1}
        ref = fac.fused_masked_forward_plain(w64, obs, mask, with_value)
        for a, b, r in zip(full, half, ref):
            if r is None:
                assert a is None and b is None
                continue
            assert torch.equal(a, b)
            torch.testing.assert_close(a.double(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wide_rows_do_not_depend_on_b(cuda, monkeypatch):
    """Rows split into calls (1 + 8191, 1000 + 7192, 4095 + 4097) and the
    wrapper's chunks (WIDE_MAX_ROWS cut to 1000 and to 64) equal the B=8192
    call bit for bit."""
    H = 1280
    w = wide_net(cuda, H, "random")
    rng = np.random.RandomState(H)
    obs = torch.as_tensor(rng.randint(0, 8, size=(8192, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(8192, 45) < 0.4, device=cuda)
    whole = fac.fused_masked_forward(w, obs, mask)
    for cut in (1, 1000, 4095):
        parts = [fac.fused_masked_forward(w, obs[a:b].contiguous(), mask[a:b].contiguous())
                 for a, b in ((0, cut), (cut, 8192))]
        for j in (0, 1):
            assert torch.equal(torch.cat([p[j] for p in parts]), whole[j])
    for rows in (1000, 64):
        monkeypatch.setattr(fac, "WIDE_MAX_ROWS", rows)
        chunked = fac.fused_masked_forward(w, obs, mask)
        assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])


@pytest.mark.cuda
def test_refused_wide_launch_raises(cuda, tmp_path):
    """A wide-route launch that the card refuses (a build whose layer 2
    asks for more shared memory than a block may have) raises through the
    wrapper, and nothing runs in its place: no counter moves."""
    import ctypes

    from splendax_torch.ops import _build

    lib = tmp_path / "libwide_refused.so"
    _build.compile_many({"refused": (_build.CSRC / "fused_actor_critic_wgmma.cu", lib,
                                     ("-DPROBE_SMEM_EXTRA=131072",))})
    refused = fac.bind(ctypes.CDLL(str(lib)))
    w = wide_net(cuda, 1024, "random")
    rng = np.random.RandomState(5)
    obs = torch.as_tensor(rng.randint(0, 8, size=(256, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(256, 45) < 0.4, device=cuda)
    prepared = fac.prepare_weights(w)
    counts = fac.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fac._launch("wide", w, obs, mask, True, prepared, lib=refused)
    torch.cuda.synchronize()
    assert fac.launch_counts() == counts


# Kernel A's critic alone (H, B, mode): tile mode at the league slot's leaves
# (1,024 games x m 8 x k0 4) and the eval's Gumbel lanes (100 x 16 x 6);
# cluster mode at a 1,024-game bootstrap and the eval's 100 games; the wide
# route's pass and half modes at H = 1024; ragged last tiles (4127 and 65
# rows in 64-row tiles, 129 in the wide route's 128).
CRITIC_CASES = [(768, 32768, "tile"), (768, 9600, "tile"), (768, 1024, "cluster"),
                (768, 100, "cluster"), (1024, 8192, "pass"), (1024, 8192, "half"),
                (1024, 1024, "pass"), (1024, 1024, "half"), (768, 4127, "tile"),
                (768, 4127, "cluster"), (100, 65, "tile"), (100, 65, "cluster"),
                (1280, 129, "pass"), (1280, 129, "half")]


@pytest.mark.cuda
@pytest.mark.parametrize("H, B, mode", CRITIC_CASES)
def test_critic_alone_equals_the_two_head_value(cuda, H, B, mode):
    """Kernel A without the mask runs the critic alone: no logits, and the
    value of the call with both heads bit for bit, forced into each mode of
    the route, with a last tile of obs past 2048 (layer 1's third product)
    beside exact ones; one launch, counted as the critic's and in the mode
    given.  `fused_value_forward` (a list or a handle) takes the mode the
    two-head call derives and equals its value too."""
    r = fac.route(H)
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    obs[B - 1, 3] = 4097
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    _, both = fac._launch(r, w, obs, mask, True, mode=mode)

    def modes():
        return fac.launches_by_mode if r == "wgmma" else fac.launches_by_wide_mode

    n0, m0, c0 = fac.launches, modes(), fac.critic_launches
    logits, value = fac._launch(r, w, obs, None, True, mode=mode)
    torch.cuda.synchronize()
    assert logits is None and torch.equal(value, both)
    assert (fac.launches, fac.critic_launches) == (n0 + 1, c0 + 1)
    assert {m: n - m0[m] for m, n in modes().items()} == {m: int(m == mode) for m in m0}
    derived = fac.fused_masked_forward(w, obs, mask)[1]
    assert torch.equal(derived, both)
    for weights in (w, fac.PreparedWeights(w)):
        assert torch.equal(fac.fused_value_forward(weights, obs), derived)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [768, 1024])
def test_critic_alone_on_no_rows(cuda, H):
    """B = 0 on either route: an empty float32 value on the card, nothing
    launched or prepared."""
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(np.random.RandomState(H), H),
                                             device=cuda))
    counts = fac.launch_counts()
    v = fac.fused_value_forward(w, torch.zeros((0, 297), dtype=torch.int32, device=cuda))
    assert v.shape == (0,) and v.dtype == torch.float32 and v.is_cuda
    assert fac.launch_counts() == counts


@pytest.mark.cuda
def test_static_slot_search_runs_the_critic_alone(cuda, monkeypatch):
    """One search call of the league recipe's static slot (Gumbel m 8, k0
    4, horizon 2 on 1,024 games of the committed h768 net, 32,768 lanes in
    tile mode): `rounds` forwards of the critic alone, one leaf evaluation
    a halving round, and none with both heads; on the same draws its moves
    and values equal those of the search whose leaves take the two-head
    forward's value."""
    from splendax_torch import bench
    from splendax_torch.search import gumbel, mc

    cfg = bench.league_config("static")
    B, m, k0, hz = cfg.n_search_static, cfg.search_m, cfg.search_k0, cfg.search_horizon
    rounds, lanes = m.bit_length() - 1, B * m * k0
    assert fac.wgmma_mode(lanes, cfg.hidden) == "tile"
    st, obs, mask = _midgame(B, 41, 4)
    st, obs, mask = st.map(lambda x: x.to(cuda)), obs.to(cuda), mask.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    draws = {"g": gumbel.gumbel_noise((B, 45), g, cuda),
             "playout": [[gumbel.gumbel_noise((lanes, 45), g, cuda) for _ in range(hz)]
                         for _ in range(rounds)]}
    path = os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz")
    ctx = fac.PreparedWeights(ac.kernel_weights(ac.import_params_npz(path, device=cuda)))
    fn = ppo.gumbel_search_fn(m=m, k0=k0, horizon=hz, greedy_final=True)
    fn(ctx, obs, mask, st, draws=draws)  # the handle's preparation
    calls, launch = [], fac._launch

    def kept(r, weights, obs, mask, with_value, *args, **kw):
        calls.append((obs.shape[0], mask is not None, with_value))
        return launch(r, weights, obs, mask, with_value, *args, **kw)

    monkeypatch.setattr(fac, "_launch", kept)
    c0, info = fac.critic_launches, {}
    got = fn(ctx, obs, mask, st, draws=draws, info=info)
    torch.cuda.synchronize()
    assert fac.critic_launches - c0 == rounds
    assert calls.count((lanes, False, True)) == rounds
    assert not any(actor and value for _, actor, value in calls), calls
    every = torch.ones((lanes, 45), dtype=torch.bool, device=cuda)
    monkeypatch.setattr(mc, "fused_value_forward",
                        lambda w, o: fac.fused_masked_forward(w, o, every[:o.shape[0]])[1])
    want_info = {}
    want = fn(ctx, obs, mask, st, draws=draws, info=want_info)
    assert torch.equal(got, want)
    for k in ("q_hat", "final", "alive"):
        assert torch.equal(info[k], want_info[k]), k


@pytest.mark.cuda
def test_ladder_pair_card_plays_the_cpu_games(cuda):
    """The ladder pair noble vs ppo_1750m_wallmatch (H=256), whose replayed
    score lay farthest from the committed one: on the card's deals of the
    ladder's seed for it and of seeds 1-3, the card and the CPU, handed the
    same deals as a state, play every game the same in both seat orders.
    Prints noble's points of 200 in `suite.head_to_head` on the card at the
    ladder's seed and at seeds 1-16, the spread a far score is read against."""
    from splendax_torch.engine import state as S
    from splendax_torch.env import core
    from splendax_torch.eval import ladder, suite

    a, b, n = "noble", "ppo_1750m_wallmatch", 100
    entries = ladder.roster_entries(include_search=False)
    labels = [label for label, _, _ in entries]
    ladder_seed = 1000 * labels.index(a) + labels.index(b)
    spec = dict((label, (kind, path)) for label, kind, path in entries)

    def policies(device):
        nets = {b: ac.import_params_npz(spec[b][1], device=device)}
        return [ladder.build_policy(l, *spec[l], nets, device) for l in (a, b)]

    devs = {"card": cuda, "cpu": torch.device("cpu")}
    pols = {d: policies(dev) for d, dev in devs.items()}
    for seed in (ladder_seed, 1, 2, 3):
        st, _, _ = core.reset(n, torch.Generator(device=cuda).manual_seed(seed), cuda)
        states = {"card": st, "cpu": S.from_numpy(S.to_numpy(st), device="cpu")}
        for order in (0, 1):
            final = {}
            for d, dev in devs.items():
                p0, p1 = pols[d] if order == 0 else pols[d][::-1]
                gen = torch.Generator(device=dev).manual_seed(0)
                final[d] = suite._play_matches(p0[0], p0[1], p1[0], p1[1], n, gen, "fast",
                                               state=states[d])[0].cpu()
            assert torch.equal(final["card"], final["cpu"]), (seed, order)
    points = [(lambda r: r["wins"] + 0.5 * r["draws"])(
        suite.head_to_head(*pols["card"], n, seed=s, device=cuda))
        for s in (ladder_seed, *range(1, 17))]
    print(f"{a}:{b} on the card, {a}'s points of {2 * n}: seed {ladder_seed} {points[0]}, "
          f"seeds 1-16 {points[1:]}")


def unrouted_syncs(fn) -> dict:
    """Run `fn()` under CUDA's synchronisation debug mode -> {port file:line:
    count} of the synchronising calls (device-to-host reads, pageable
    host-to-device copies, stream synchronisations) made outside
    `splendax_torch.trace.sync`, each at the innermost frame of the port."""
    import traceback
    import warnings

    trace_py = os.path.join("splendax_torch", "trace.py")
    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "prototype" in str(message):  # the mode's one note that it is a prototype
            return
        stack = traceback.extract_stack()
        if any(f.name == "sync" and f.filename.endswith(trace_py) for f in stack):
            return
        port = [f for f in stack if os.sep + "splendax_torch" + os.sep in f.filename]
        key = (f"{os.path.relpath(port[-1].filename, ROOT)}:{port[-1].lineno}" if port
               else str(message)[:80])
        found[key] = found.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


SYNC_PATHS = {
    "static": dict(search_opponent=True, search_static=True),
    "bernoulli": dict(search_opponent=True, p_search=0.25),
    "noslot": dict(),
    "parity": dict(rng_mode="parity"),
    "no_ring": dict(reset_ring_mult=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", [*SYNC_PATHS, "eval"])
def test_every_blocking_read_goes_through_trace_sync(cuda, path):
    """Every synchronising call of an update (each slot mode, parity mode,
    the ring-less reset) and of a Gumbel eval, after a first run that makes
    the cached tables, goes through `trace.sync`, so the per-update records
    count every place the host waits on the device."""
    from splendax_torch.eval import suite
    from splendax_torch.search import gumbel

    if path == "eval":
        params = ac.ActorCritic(64, torch.Generator(device=cuda).manual_seed(0), cuda)
        bot = gumbel.gumbel_search_policy(m=4, k0=2, horizon=2,
                                          params=fac.PreparedWeights(ac.kernel_weights(params)))
        opp = suite.model_greedy_policy(params)

        def run():
            suite.eval_vs_opponent(bot, opp, 16, seed=1, device=cuda)
    else:
        cfg = PPOConfig(num_envs=256, num_steps=4, hidden=64, update_epochs=1,
                        minibatch_size=256, snapshot_every_updates=1, target_kl=0.02,
                        total_timesteps=256 * 4 * 8, **SYNC_PATHS[path])
        state = [ppo.init_train_state(cfg, device=cuda)]

        def run():
            state[0], _ = ppo.update_step(cfg, state[0])

    run()
    torch.cuda.synchronize()
    found = unrouted_syncs(run)
    print(f"{path}: synchronising calls outside trace.sync {found}")
    assert found == {}


# ---- the engine's call sites on the card ------------------------------------

def _fuzzed_states(B: int, seed: int, cuda):
    """B games on the card after 0 to 199 uniformly random legal plies each
    (eager): token returns, nobles, reserves, games over, turn-limit draws."""
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import core
    from splendax_torch.selfplay.opponents import uniform_legal_action

    g = torch.Generator(device=cuda).manual_seed(seed)
    st = initial_state(B, g, cuda)
    stop = torch.randint(0, 200, (B,), generator=g, device=cuda)
    for ply in range(200):
        mask = rules.legal_mask(st)
        nxt, _ = core.step(st, uniform_legal_action(mask, g), mask=mask)
        st = core.select(stop > ply, nxt, st)
    return st, g


def _site_calls(B: int, st, g, cuda) -> dict:
    """{site: (fn, inputs of 3 calls)} at lane batch B: the dual turn's
    plies and reset, the Gumbel search's children (m 8, or 16 at B = 9,600)
    and lanes, a playout step; each call on other games, ~3% of the actions
    illegal."""
    from splendax_torch.engine import rules
    from splendax_torch.search import gumbel, mc
    from splendax_torch.selfplay import dual
    from splendax_torch.selfplay.opponents import uniform_legal_action

    m = 16 if B == 9600 else 8

    def games(n):
        rows = torch.randint(0, B, (n,), generator=g, device=cuda)
        return st.map(lambda x: x[rows])

    def actions(mask):
        a = uniform_legal_action(mask, g)
        wild = torch.rand(a.shape, generator=g, device=cuda) < 0.03
        return torch.where(wild, torch.randint(0, 45, a.shape, generator=g, device=cuda), a)

    sites = {}
    calls = {k: [] for k in ("dual.agent", "dual.opponent", "dual.reset", "gumbel.children",
                             "gumbel.lanes", "mc.playout")}
    for _ in range(3):
        s = games(B)
        mask = rules.legal_mask(s)
        a = actions(mask)
        calls["dual.agent"].append((s, a, mask))
        s1, out = dual._agent_ply(s, a, mask)
        calls["dual.opponent"].append((s1, actions(out.action_mask), out.action_mask,
                                       out.terminated, out.reward, out.final_rewards,
                                       out.turn_limit))
        calls["dual.reset"].append((torch.rand(B, generator=g, device=cuda) < 0.1, games(B), s))
        root = games(B // m)
        calls["gumbel.children"].append((root, torch.randint(0, 45, (B // m, m), generator=g,
                                                             device=cuda)))
        calls["gumbel.lanes"].append((s, torch.randint(0, B, (B,), generator=g, device=cuda)))
        calls["mc.playout"].append((s, a, mask))
    fns = {"dual.agent": dual._agent_ply, "dual.opponent": dual._opponent_ply,
           "dual.reset": dual._reset, "gumbel.children": gumbel.children,
           "gumbel.lanes": gumbel._lanes, "mc.playout": mc.playout_step}
    return {k: (fns[k], calls[k]) for k in fns}


def _to(x, device):
    """x's tensors (in tuples and `GameState`s) on `device`."""
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.map(lambda t: t.to(device)) if hasattr(x, "map") else x.to(device)


def _same(got, want, where: str) -> None:
    """got (on the card) and want (on the CPU) hold the same structure
    (tensors, None, tuples, dataclasses) and their tensors the same dtypes
    and bits."""
    import dataclasses

    if isinstance(got, torch.Tensor):
        assert isinstance(want, torch.Tensor) and got.dtype == want.dtype, where
        assert torch.equal(got.cpu(), want), where
    elif isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want), where
        for i, (x, y) in enumerate(zip(got, want)):
            _same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(got):
        assert type(got) is type(want), where
        for f in dataclasses.fields(got):
            _same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    else:
        assert got is None and want is None, where


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8192, 32768, 9600])
def test_sites_on_the_card_equal_the_cpu(cuda, B):
    """At the dual turn's B (8,192), the static slot's search lanes (32,768)
    and the eval's (9,600), on fuzzed games: each engine site (the dual
    turn's plies and reset, the Gumbel search's children and lanes, a
    playout step) on the card is one launch of the ply's kernels and equals
    the same function on a CPU copy of its inputs bit for bit, every state
    field, obs, mask and field."""
    st, g = _fuzzed_states(B, B, cuda)
    for site, (fn, calls) in _site_calls(B, st, g, cuda).items():
        for i, args in enumerate(calls):
            before = sum(ep.launches.values())
            out = fn(*args)
            assert sum(ep.launches.values()) - before == 1, site
            _same(out, fn(*_to(args, "cpu")), f"{site} call {i}")


@pytest.mark.cuda
def test_each_site_call_is_one_kernel_launch(cuda, monkeypatch):
    """In a league update with the static slot and in a Gumbel eval, every
    call of an engine site (the dual turn's plies, observation and reset,
    the search's children, lanes and playout steps) launches exactly one
    step or observe kernel, and a second update or eval launches as many as
    the first."""
    from splendax_torch.eval import suite
    from splendax_torch.search import gumbel, mc
    from splendax_torch.selfplay import dual

    per_call = {}

    def counted(name, fn):
        def site(*args, **kw):
            before = sum(ep.launches.values())
            out = fn(*args, **kw)
            per_call.setdefault(name, []).append(sum(ep.launches.values()) - before)
            return out
        return site

    for mod, name in ((dual, "_agent_ply"), (dual, "_opponent_ply"), (dual, "_observe"),
                      (dual, "_reset"), (gumbel, "children"), (gumbel, "_lanes"),
                      (mc, "playout_step"), (mc, "observe")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))

    def launched(run):
        per_call.clear()
        before = sum(ep.launches.values())
        run()
        assert all(n == [1] * len(n) for n in per_call.values()), per_call
        return sum(ep.launches.values()) - before, {k: len(n) for k, n in per_call.items()}

    cfg = PPOConfig(num_envs=256, num_steps=4, hidden=64, pool_size=3, minibatch_size=512,
                    update_epochs=1, total_timesteps=256 * 4 * 8, search_opponent=True,
                    search_static=True, search_m=4, search_k0=2, search_horizon=2)
    ts = [ppo.init_train_state(cfg, device=cuda)]

    def update():
        ts[0], _ = ppo.update_step(cfg, ts[0])

    first = launched(update)
    assert set(first[1]) == {"_agent_ply", "_opponent_ply", "_reset", "children", "_lanes",
                             "playout_step"}, first
    assert first[1]["_agent_ply"] == cfg.num_steps and first[0] >= sum(first[1].values())
    assert launched(update) == first

    params = ac.ActorCritic(64, torch.Generator(device=cuda).manual_seed(0), cuda)
    bot = gumbel.gumbel_search_policy(m=4, k0=2, horizon=2,
                                      params=fac.PreparedWeights(ac.kernel_weights(params)))
    opp = suite.model_greedy_policy(params)
    first = launched(lambda: suite.eval_vs_opponent(bot, opp, 16, seed=1, device=cuda))
    assert set(first[1]) == {"_agent_ply", "_opponent_ply", "_observe", "children", "_lanes",
                             "playout_step"}, first
    assert launched(lambda: suite.eval_vs_opponent(bot, opp, 16, seed=1, device=cuda)) == first


# ---- the fast-mode ply's kernels (ops/engine_ply) ---------------------------

def _edge_games(B: int, seed: int, cuda):
    """B games on the card played by the plain functions 0 to 199 random
    legal plies deep, then edited so that every edge case of the ply occurs:
    games on their last moves before the turn limit, exhausted decks, movers
    holding 8 to 10 tokens (a take returns some), games already over (with
    either player to move) and games with no legal move (an empty bank,
    three unaffordable reserved cards, no bonuses)."""
    from splendax_torch.engine import rules
    from splendax_torch.engine.state import initial_state
    from splendax_torch.env import core
    from splendax_torch.selfplay.opponents import uniform_legal_action

    g = torch.Generator(device=cuda).manual_seed(seed)
    st = initial_state(B, g, cuda)
    stop = torch.randint(0, 200, (B,), generator=g, device=cuda)
    for ply in range(200):
        mask = rules.legal_mask(st)
        nxt, _ = core.step_plain(st, uniform_legal_action(mask, g), mask=mask)
        st = core.select(stop > ply, nxt, st)

    def rows(p):
        return torch.rand(B, generator=g, device=cuda) < p

    ar, p = torch.arange(B, device=cuda), st.to_play.long()
    late = rows(0.05)
    move = torch.where(late, torch.randint(195, 199, (B,), generator=g, device=cuda)
                       .to(torch.int32), st.move_count)
    deck_count = torch.where(rows(0.08)[:, None] & (torch.rand(B, 3, generator=g, device=cuda)
                                                      < 0.6), 0, st.deck_count)
    tokens, bank = st.tokens.clone(), st.bank.clone()
    bonuses, res_cnt, res_ids = st.bonuses.clone(), st.reserved_count.clone(), st.reserved_ids.clone()
    full = rows(0.15)
    draws = torch.randint(0, 6, (B, 10), generator=g, device=cuda)
    kept = torch.arange(10, device=cuda)[None] < torch.randint(8, 11, (B, 1), generator=g,
                                                               device=cuda)
    hand = (torch.nn.functional.one_hot(draws, 6) * kept[..., None]).sum(1).to(torch.int32)
    tokens[ar[full], p[full]] = hand[full]
    stuck = rows(0.03)
    bank[stuck, :5] = 0
    bank[stuck, 5] = 0
    tokens[ar[stuck], p[stuck]] = 0
    bonuses[ar[stuck], p[stuck]] = 0
    res_cnt[ar[stuck], p[stuck]] = 3
    res_ids[ar[stuck], p[stuck]] = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    over = rows(0.04)
    return st.replace(move_count=move, turn_count=move // 2 + 1, deck_count=deck_count,
                      tokens=tokens, bank=bank, bonuses=bonuses, reserved_count=res_cnt,
                      reserved_ids=res_ids, game_over=st.game_over | over), g


def _fuzzed_actions(mask, g, cuda):
    """Legal actions, a fifth replaced by any action and 2% by ones outside
    [0, 45) (the step clamps them)."""
    from splendax_torch.selfplay.opponents import uniform_legal_action

    a = uniform_legal_action(mask, g)
    n = a.shape[0]
    any_a = torch.randint(0, 45, (n,), generator=g, device=cuda)
    out_a = torch.randint(-6, 52, (n,), generator=g, device=cuda)
    r = torch.rand(n, generator=g, device=cuda)
    return torch.where(r < 0.02, out_a, torch.where(r < 0.2, any_a, a))


def _same_state(got, want, what):
    for name, x in want.items():
        y = getattr(got, name)
        assert y.dtype == x.dtype and torch.equal(y, x), f"{what}: {name}"


def _same_fields(got, want, what):
    assert set(got) == set(want), what
    for k, x in want.items():
        assert got[k].dtype == x.dtype and torch.equal(got[k], x), f"{what}: {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 100, 8192, 32768])
def test_engine_step_kernel_equals_the_plain_functions(cuda, B):
    """The transition kernel bit for bit against the plain functions on the
    same games on the card (and, at B <= 8192, on the CPU, the token return
    in plain PyTorch too), on fuzzed legal, illegal and out-of-range actions
    over `_edge_games`: `step_core` from the given mask (some rows all
    False; with the next obs alone, as the ring's step takes it) and from
    its own; `step` with its obs and live mask; a hold;
    frozen lanes with their obs and mask; `apply_action` alone on every
    action, on repeated rows with the children's obs and mask and on the
    games themselves.  At the large B every action kind is played legally, and
    nobles, exhausted decks, token returns, the turn limit, finished games
    and rows without a legal move all occur.  One launch a call."""
    from splendax_torch.engine import rules
    from splendax_torch.env import core
    from splendax_torch.search.mc import repeat_rows

    st, g = _edge_games(max(B, 64), B, cuda)
    st = st.map(lambda x: x[:B])
    mask = rules.legal_mask(st)
    mask = mask & ~(torch.rand(B, generator=g, device=cuda) < 0.03)[:, None]
    a = _fuzzed_actions(mask, g, cuda)
    launched = ep.launches["step"]

    got_s, got_f, got_obs, none = ep.step(st, a, mask, with_obs=True)
    want_s, want_f = core.step_core_plain(st, a, mask=mask)
    _same_state(got_s, want_s, "step_core, given mask")
    _same_fields(got_f, want_f, "step_core, given mask")
    assert none is None and torch.equal(got_obs, encode(want_s))
    assert got_s.deck_perm.data_ptr() == st.deck_perm.data_ptr()

    got_s, got_out = core.step(st, a)  # the dispatch: the kernel
    want_s, want_out = core.step_plain(st, a)
    _same_state(got_s, want_s, "step")
    for k in vars(want_out):
        assert torch.equal(getattr(got_out, k), getattr(want_out, k)), f"step: {k}"

    hold = torch.rand(B, generator=g, device=cuda) < 0.5
    got_s, got_f, _, _ = ep.step(st, a, mask, hold=hold)
    want_s, want_f = core.step_core_plain(st, a, mask=mask)
    held = core.select(hold, st, want_s)
    _same_state(got_s, held, "hold")
    _same_fields(got_f, dict(want_f, to_play=held.to_play), "hold")

    term = rules.is_terminal(st)
    got_s, _, got_obs, got_m = ep.step(st, a, mask, freeze_terminal=True, with_obs=True,
                                       with_mask=True)
    frozen = core.select(term, st, core.step_core_plain(st, a, mask=mask)[0])
    _same_state(got_s, frozen, "frozen lanes")
    assert torch.equal(got_obs, encode(frozen)) and torch.equal(got_m, rules.legal_mask(frozen))

    r = 3
    acts = torch.randint(0, 45, (B * r,), generator=g, device=cuda)
    acts[:min(45, B * r)] = torch.arange(min(45, B * r), device=cuda)
    kids, _, k_obs, k_mask = ep.step(st, acts, apply_only=True, repeat=r, with_obs=True,
                                     with_mask=True)
    want_k = rules.apply_action_plain(repeat_rows(st, r), acts)
    _same_state(kids, want_k, "apply_action, repeated rows")
    assert torch.equal(k_obs, encode(want_k)) and torch.equal(k_mask, rules.legal_mask(want_k))
    got_k = ep.step(st, acts[:B], apply_only=True)[0]
    _same_state(got_k, rules.apply_action_plain(st, acts[:B]), "apply_action")
    assert ep.launches["step"] - launched == 6

    if B <= 8192:  # the same on the CPU
        st_c, a_c, m_c = st.map(lambda x: x.cpu()), a.cpu(), mask.cpu()
        want_s, want_f = core.step_core(st_c, a_c, mask=m_c)
        got_s, got_f, _, _ = ep.step(st, a, mask)
        _same_state(got_s.map(lambda x: x.cpu()), want_s, "step_core against the CPU")
        _same_fields({k: v.cpu() for k, v in got_f.items()}, want_f, "step_core against the CPU")
        _same_state(kids.map(lambda x: x.cpu()),
                    rules.apply_action(repeat_rows(st_c, r), acts.cpu()), "apply against the CPU")
    if B >= 8192:
        legal = mask.gather(1, a.clamp(0, 44)[:, None])[:, 0] & mask.any(1)
        pre = rules._apply_move(st, a.clamp(0, 44))
        moved = rules._grant_noble(pre)
        kinds = set(a.clamp(0, 44)[legal].tolist())
        assert kinds == set(range(45)), sorted(set(range(45)) - kinds)
        want_s, want_f = core.step_core_plain(st, a, mask=mask)
        held = pre.tokens[torch.arange(B, device=cuda), st.to_play.long()].sum(1)
        assert int(((moved.noble_ids != pre.noble_ids).any(1) & legal).sum()) > 0, "noble"
        assert int(((held > 10) & legal).sum()) > 0, "token return"
        assert int((want_f["turn_limit"] & legal).sum()) > 0, "turn limit"
        assert int(want_f["draw"].sum()) > 0 and int(term.sum()) > 0, "no move, finished"
        ac = a.clamp(0, 44)
        off = torch.where(ac < 27, ac - 15, ac - 27).clamp(0, 11)
        tier = torch.where(ac < 39, off // 4, (ac - 39).clamp(0, 2))
        empty = st.deck_count.gather(1, tier[:, None])[:, 0] == 0
        assert int((empty & (ac >= 15) & (ac < 39) & legal).sum()) > 0, "a pop from no deck"


def encode(state):
    from splendax_torch.engine.encode import encode_observation

    return encode_observation(state)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 100, 8192, 32768])
def test_engine_observe_kernel_equals_the_plain_functions(cuda, B):
    """The observe kernel bit for bit against `encode_observation` and
    `legal_mask` on `_edge_games` (and on the garbage children of illegal
    actions): plain; the mask `& ~done`; `select(done, fresh, state)` with
    the carried state; gathered rows with and without the obs.  One launch a
    call."""
    from splendax_torch.engine import rules
    from splendax_torch.env import core

    st, g = _edge_games(max(B, 64), B + 1, cuda)
    st = st.map(lambda x: x[:B])
    kids = rules.apply_action_plain(st, torch.randint(0, 45, (B,), generator=g, device=cuda))
    launched = ep.launches["observe"]
    for what, s in (("games", st), ("children", kids)):
        _, obs, mask = ep.observe(s)
        assert torch.equal(obs, encode(s)) and torch.equal(mask, rules.legal_mask(s)), what
    done = torch.rand(B, generator=g, device=cuda) < 0.3
    none, obs, mask = ep.observe(st, done=done, mask_off=True)
    assert none is None and torch.equal(obs, encode(st))
    assert torch.equal(mask, rules.legal_mask(st) & ~done[:, None])
    fresh = kids
    carry, obs, mask = ep.observe(st, fresh=fresh, done=done)
    want = core.select(done, fresh, st)
    _same_state(carry, want, "select")
    assert torch.equal(obs, encode(want)) and torch.equal(mask, rules.legal_mask(want))
    rows = torch.randint(0, B, (3 * B,), generator=g, device=cuda)
    flat = st.map(lambda x: x[rows])
    for with_obs in (True, False):
        got, obs, mask = ep.observe(st, rows=rows, with_obs=with_obs)
        _same_state(got, flat, "gathered rows")
        assert (obs is None) != with_obs and torch.equal(mask, rules.legal_mask(flat))
        if with_obs:
            assert torch.equal(obs, encode(flat))
    assert ep.launches["observe"] - launched == 6


@pytest.mark.cuda
def test_engine_ply_kernels_refuse_bad_input(cuda):
    """A field or the action on another device, a mask with repeated rows, a
    repeat below 1, apply-only with a mask, a mask of another dtype,
    observe's fresh without done and int32 rows: refused before any
    launch."""
    from splendax_torch.engine import rules

    st, g = _edge_games(64, 3, cuda)
    mask = rules.legal_mask(st)
    a = _fuzzed_actions(mask, g, cuda)
    before = sum(ep.launches.values())
    for call in (lambda: ep.step(st.replace(bank=st.bank.cpu()), a),
                 lambda: ep.step(st, a.cpu()),
                 lambda: ep.step(st, a.repeat(2), mask, repeat=2),
                 lambda: ep.step(st, a, mask, repeat=0),
                 lambda: ep.step(st, a, mask, apply_only=True),
                 lambda: ep.step(st, a, mask=mask.int()),
                 lambda: ep.observe(st, fresh=st),
                 lambda: ep.observe(st, rows=torch.zeros(3, dtype=torch.int32, device=cuda))):
        with pytest.raises(ValueError):
            call()
    assert sum(ep.launches.values()) == before
