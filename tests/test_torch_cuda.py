"""The port's CUDA kernels on the card, against their plain versions, and the
rollout through them.  Every test here needs a CUDA device: each carries the
`cuda` marker and skips without one.  This file imports no JAX, so on a GPU
host without JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt
from splendax_torch.train import ppo
from splendax_torch.train.config import PPOConfig


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


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 512, 768, 1024])
@pytest.mark.parametrize("B", [1, 17, 257, 4096])
def test_fused_kernel_matches_plain(cuda, H, B):
    """rtol/atol 1e-5 (f32 sums in another order): kernel A against its
    plain version, with a row that has no legal action."""
    rng = np.random.RandomState(H + B)
    w = ac.kernel_weights(ac.params_from_jax(numpy_params(rng, H), device=cuda))
    obs = torch.as_tensor(rng.randint(0, 8, size=(B, 297)).astype(np.int32), device=cuda)
    mask = torch.as_tensor(rng.rand(B, 45) < 0.4, device=cuda)
    mask[0] = False
    before = fac.launches
    lk, vk = fac.fused_masked_forward(w, obs, mask)
    lo, vo = fac.fused_masked_forward(w, obs, mask, with_value=False)
    lp, vp = fac.fused_masked_forward_plain(w, obs, mask)
    assert fac.launches == before + 2
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=1e-5)
    assert vo is None and torch.equal(lo, lk)
    assert (lk[0] > -1e8).all()


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
def test_rollout_runs_through_both_kernels(cuda):
    cfg = PPOConfig(num_envs=256, num_steps=8, hidden=64, pool_size=3)
    ts = ppo.init_train_state(cfg, device=cuda)
    a0, b0 = fac.launches, rt.launches
    ts, traj = ppo.rollout(cfg, ts)
    assert fac.launches > a0 and rt.launches - b0 == cfg.num_steps
    legal = traj.mask.gather(2, traj.action[..., None])[..., 0]
    assert bool((legal | ~traj.mask.any(-1)).all())
    assert int(traj.overflow) == 0
