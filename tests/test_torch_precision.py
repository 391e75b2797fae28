"""The numeric design of kernel A (`splendax_torch/csrc/fused_actor_critic.cu`),
emulated on the CPU.

The kernel takes each f32 product on the tensor cores as three TF32
products: with hi = tf32(a) and lo = tf32(a - hi), a b ~ hi hi + hi lo + lo hi,
summed in f32.  TF32 rounding is `cvt.rna`: round to nearest, ties away
from zero, to 10 explicit mantissa bits.  The product of two TF32 values
(11 significant bits each) is exact in f32, so the emulation differs from the
card only in the order of the sums.  Layer 1 drops lo hi where every obs is
exact in TF32 (|x| <= 2048), which the last test shows of the engine's obs.
"""

import os

import pytest
import torch

from splendax_torch.env import core
from splendax_torch.env import ring as ring_lib
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.selfplay.opponents import uniform_legal_action

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = {
    256: os.path.join(ROOT, "runs/ppo_splendor_2b/ppo_splendor_params.npz"),
    768: os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz"),
}
TF32_EXACT = 2048


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as `cvt.rna.tf32.f32` does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_3xtf32(a, b, a_exact=False):
    """a @ b as the kernel takes it: lo hi (unless a is exact in TF32) +
    hi lo + hi hi, each product exact, summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bl + ah @ bh
    return out if a_exact else al @ bh + out


def mm_tf32(a, b, a_exact=False):
    """One TF32 product: what the tensor cores give without the split."""
    return tf32(a) @ tf32(b)


def emulated_forward(weights, obs, mask, mm):
    """The kernel's forward with its products taken by `mm`; the value head
    is an f32 dot product, as in the kernel."""
    aw0, ab0, aw1, ab1, aw2, ab2, cw0, cb0, cw1, cb1, cw2, cb2 = weights
    x = obs.to(torch.float32)
    exact = bool((x.abs() <= TF32_EXACT).all())
    h = torch.tanh(mm(x, aw0, exact) + ab0)
    h = torch.tanh(mm(h, aw1) + ab1)
    logits = fac.masked_logits(mm(h, aw2) + ab2, mask)
    v = torch.tanh(mm(x, cw0, exact) + cb0)
    v = torch.tanh(mm(v, cw1) + cb1)
    return logits, (v @ cw2 + cb2)[:, 0]


def engine_obs(B, plies, seed):
    """Obs and masks of B games after `plies` uniform random legal plies on
    the port's CPU engine; row 0 has no legal action."""
    g = torch.Generator().manual_seed(seed)
    state, obs, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        state, out = core.step(state, uniform_legal_action(mask, g), mask=mask)
        obs, mask = out.obs, out.action_mask
    mask = mask.clone()
    mask[0] = False
    return obs, mask


@pytest.fixture(scope="module")
def batch():
    return engine_obs(1024, 40, seed=11)


@pytest.mark.parametrize("hidden", [256, 768])
def test_3xtf32_matches_plain_forward(batch, hidden):
    """rtol/atol 1e-5: the committed nets on engine obs, B = 1024, three TF32
    products per f32 one against the plain f32 forward."""
    w = ac.kernel_weights(ac.import_params_npz(NETS[hidden], device="cpu"))
    assert w[0].shape[1] == hidden
    obs, mask = batch
    lp, vp = fac.fused_masked_forward_plain(w, obs, mask)
    le, ve = emulated_forward(w, obs, mask, mm_3xtf32)
    torch.testing.assert_close(le, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ve, vp, rtol=1e-5, atol=1e-5)
    assert (le[0] > -1e8).all()


@pytest.mark.parametrize("hidden", [256, 768])
def test_3xtf32_is_closer_to_exact_than_f32(batch, hidden):
    """Against the plain forward in float64, the card's reference: the
    emulated kernel is within rtol/atol 1e-5 and, on average, closer than the
    plain forward in float32."""
    w = ac.kernel_weights(ac.import_params_npz(NETS[hidden], device="cpu"))
    obs, mask = batch
    lr, vr = fac.fused_masked_forward_plain([t.double() for t in w], obs, mask)
    le, ve = emulated_forward(w, obs, mask, mm_3xtf32)
    torch.testing.assert_close(le.double(), lr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ve.double(), vr, rtol=1e-5, atol=1e-5)
    lp, _ = fac.fused_masked_forward_plain(w, obs, mask)
    assert (le.double() - lr).abs().mean() < (lp.double() - lr).abs().mean()


def test_one_tf32_product_misses_the_contract(batch):
    """The negative control: plain TF32 (hi hi alone) is not within 1e-5 of
    the f32 forward on the flagship net, which is why the kernel takes three
    products."""
    w = ac.kernel_weights(ac.import_params_npz(NETS[768], device="cpu"))
    obs, mask = batch
    lp, vp = fac.fused_masked_forward_plain(w, obs, mask)
    lt, vt = emulated_forward(w, obs, mask, mm_tf32)
    assert not torch.allclose(lt, lp, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(vt, vp, rtol=1e-5, atol=1e-5)
    err_3x = (emulated_forward(w, obs, mask, mm_3xtf32)[0] - lp).abs().max()
    assert (lt - lp).abs().max() > 100 * err_3x


def test_engine_obs_are_exact_in_tf32():
    """Every obs the engine encodes over 300 plies of 512 games, with ring
    autoreset, is an integer of magnitude <= 2048, exact in TF32: its lo is
    0, so layer 1's lo hi product, which the kernel skips, is exactly 0."""
    B = 512
    g = torch.Generator().manual_seed(5)
    state, obs, mask = core.reset(B, g, "cpu")
    ring = ring_lib.make_ring(4 * B, g, "cpu", window=B)
    biggest, finished = int(obs.abs().max()), 0
    for _ in range(300):
        state, out, obs, mask, ring = ring_lib.step_autoreset_ring(
            state, uniform_legal_action(mask, g), ring, mask=mask)
        biggest = max(biggest, int(obs.abs().max()))
        finished += int(out.terminated.sum())
        assert not split(obs.to(torch.float32))[1].any()
    assert finished > B  # autoreset dealt fresh games along the way
    assert int(ring.overflow) == 0
    assert biggest <= TF32_EXACT
    # tf32 rounding as the card does it: exact below 2^11, rounded above.
    assert float(tf32(torch.tensor([2048.0]))) == 2048.0
    assert float(tf32(torch.tensor([2049.0]))) == 2050.0  # tie, away from zero
