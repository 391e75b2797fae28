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
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt
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
    refused = fac.bind(ctypes.CDLL(str(lib)), "wgmma")
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
    refused = fac.bind(ctypes.CDLL(str(lib)), "wide")
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
