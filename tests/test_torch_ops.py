"""The port's kernels' plain versions and the modules around them against the
JAX package: the fused actor-critic forward (the Pallas kernel in interpret
mode, and the flagship h768 weights), and the ring row take (the Pallas
kernel in interpret mode, and JAX `ring.take`).  The CUDA kernels themselves
run only on the card: their tests are in test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splendax.env import ring as jring
from splendax.models import actor_critic as jac
from splendax.ops.fused_actor_critic import fused_masked_forward as jax_fused
from splendax.ops.ring_take import SLAB, slab_take_rows
from splendax.train.checkpoint import import_params_npz as jax_import_npz
from splendax_torch.engine import rules, state as S
from splendax_torch.env import core, ring
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.ops import ring_take as rt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs/ppo_splendor_2b_h768/ppo_splendor_params.npz")


def numpy_params(rng, hidden):
    """Flat npz-layout params, uniform +-1/sqrt(fan_in) as both inits draw."""
    out = {}
    for head, n_out in (("actor", 45), ("critic", 1)):
        for i, (fi, fo) in enumerate(((297, hidden), (hidden, hidden), (hidden, n_out))):
            bound = 1.0 / np.sqrt(fi)
            out[f"{head}.{i}.w"] = rng.uniform(-bound, bound, (fi, fo)).astype(np.float32)
            out[f"{head}.{i}.b"] = rng.uniform(-bound, bound, (fo,)).astype(np.float32)
    return out


def jax_params(flat):
    return {h: [{"w": jnp.asarray(flat[f"{h}.{i}.w"]), "b": jnp.asarray(flat[f"{h}.{i}.b"])}
                for i in range(3)] for h in ("actor", "critic")}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    obs = rng.randint(0, 8, size=(300, 297)).astype(np.int32)
    mask = rng.rand(300, 45) < 0.4
    mask[0] = False  # a row with no legal action
    return obs, mask


@pytest.mark.parametrize("B", [1, 17, 256, 257])
def test_fused_forward_plain_matches_pallas_kernel(batch, B):
    """rtol/atol 1e-5 (f32 sums in another order): the port's plain version
    against the Pallas kernel in interpret mode, at H=64."""
    flat = numpy_params(np.random.RandomState(0), 64)
    obs, mask = batch[0][:B], batch[1][:B]
    lj, vj = jax_fused(jax_params(flat), jnp.asarray(obs), jnp.asarray(mask), interpret=True)
    w = ac.kernel_weights(ac.params_from_jax(flat, device="cpu"))
    lp, vp = fac.fused_masked_forward(w, torch.from_numpy(obs), torch.from_numpy(mask))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
    # the no-legal row stays unmasked; the others carry -1e9 exactly where illegal
    assert (lp[0] > -1e8).all()
    np.testing.assert_array_equal(lp.numpy()[1:] == fac.BIG_NEG, ~mask[1:])
    lo, vo = fac.fused_masked_forward(w, torch.from_numpy(obs), torch.from_numpy(mask),
                                      with_value=False)
    assert vo is None and torch.equal(lo, lp)


@pytest.mark.parametrize("hidden", [100, 769, 1024, 1280, 2048])
def test_cpu_forward_matches_pallas_kernel_and_launches_nothing(batch, hidden):
    """At widths of each route (100: wgmma; 769, 1024, 1280, 2048: wide, past
    the 1024 that the port once capped), a CPU tensor takes the plain
    version: rtol/atol 1e-5 of the Pallas kernel in interpret mode at B=33,
    and no launch counter, route count or weight preparation moves
    (`prepare_weights` on the CPU is the plain version)."""
    assert fac.route(hidden) == ("wgmma" if hidden <= 768 else "wide")
    flat = numpy_params(np.random.RandomState(hidden), hidden)
    obs, mask = batch[0][:33], batch[1][:33]
    lj, vj = jax_fused(jax_params(flat), jnp.asarray(obs), jnp.asarray(mask), interpret=True)
    w = ac.kernel_weights(ac.params_from_jax(flat, device="cpu"))
    before = (fac.launches, dict(fac.launches_by_route), fac.prep_launches)
    lp, vp = fac.fused_masked_forward(w, torch.from_numpy(obs), torch.from_numpy(mask))
    assert torch.equal(fac.prepare_weights(w), fac.prepare_weights_plain(w))
    assert (fac.launches, dict(fac.launches_by_route), fac.prep_launches) == before
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [37, 100, 769, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_value_forward_plain_is_the_two_head_value(batch, hidden, dtype):
    """The critic alone in plain PyTorch (`fused_value_forward_plain`, and
    `fused_value_forward` on a CPU tensor, on the weights as a list or a
    `PreparedWeights` handle) gives the two-head plain forward's value bit
    for bit, at widths of both routes, in float32 and float64 (the
    reference the kernels are held to); the CPU path launches nothing and
    counts no forward of the critic alone."""
    flat = numpy_params(np.random.RandomState(hidden), hidden)
    w = [t.to(dtype) for t in ac.kernel_weights(ac.params_from_jax(flat, device="cpu"))]
    obs, mask = torch.from_numpy(batch[0][:65]), torch.from_numpy(batch[1][:65])
    _, want = fac.fused_masked_forward_plain(w, obs, mask)
    before = fac.launch_counts()
    assert torch.equal(fac.fused_value_forward_plain(w, obs), want)
    if dtype == torch.float32:
        for weights in (w, fac.PreparedWeights(w)):
            got = fac.fused_value_forward(weights, obs)
            assert got.dtype == torch.float32 and got.shape == (65,)
            assert torch.equal(got, want)
        assert torch.equal(fac.fused_masked_forward(w, obs, mask)[1], want)
    assert fac.launch_counts() == before


def test_critic_alone_refusals():
    """A forward without the mask runs the critic alone, so it must compute
    the value; a tensor on neither the CPU nor the card is refused."""
    flat = numpy_params(np.random.RandomState(0), 16)
    w = ac.kernel_weights(ac.params_from_jax(flat, device="cpu"))
    obs = torch.zeros((4, 297), dtype=torch.int32)
    with pytest.raises(ValueError, match="with_value"):
        fac._launch("wgmma", w, obs, None, False)
    with pytest.raises(ValueError, match="unsupported device"):
        fac.fused_value_forward(w, obs.to("meta"))
    assert fac.heads(True) == 2 and fac.heads(False) == 1 and fac.heads(True, actor=False) == 1


def test_flagship_weights_match_jax_forward():
    """The committed h768 flagship through `import_params_npz`: logits and
    values within 1e-4 of JAX `ac.forward` + `masked_logits` at B=64.  1e-4,
    not 1e-5: the two CPU matmul backends sum the 768-long products in
    different orders, and the flagship's logits reach tens in magnitude."""
    model = ac.import_params_npz(FLAGSHIP, device="cpu")
    assert model.hidden == 768
    with np.load(FLAGSHIP) as d:
        np.testing.assert_array_equal(model.actor[0].weight.detach().numpy().T, d["actor.0.w"])
    rng = np.random.RandomState(2)
    st = S.initial_state(64, torch.Generator().manual_seed(2), device="cpu")
    for _ in range(20):
        m = rules.legal_mask(st).numpy()
        a = np.where(m.any(1), (rng.rand(64, 45) * m).argmax(1), 0)
        st, out = core.step(st, torch.from_numpy(a))
    obs, mask = out.obs, out.action_mask
    jp = jax_import_npz(FLAGSHIP)
    lj, vj = jac.forward(jp, jnp.asarray(obs.numpy()))
    lj = jac.masked_logits(lj, jnp.asarray(mask.numpy()))
    with torch.no_grad():
        logits, value = model(obs)
    lm = ac.masked_logits(logits, mask)
    np.testing.assert_allclose(lm.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(value.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)
    lf, vf = fac.fused_masked_forward(ac.kernel_weights(model), obs, mask)
    np.testing.assert_allclose(lf.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vf.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p_done", [0.03, 0.5, 1.0])
def test_ring_take_plain_matches_pallas_kernel(p_done):
    """Exact: the plain row take against `slab_take_rows` in interpret mode,
    W=512, 1024 lanes (all done overflows the window)."""
    rng = np.random.RandomState(0)
    W, R, ptr0 = 512, 1024, 300
    packed = rng.randint(-1, 90, size=(R + W, 135)).astype(np.int8)
    done = rng.rand(1024) < p_done
    rank = np.concatenate([[0], np.cumsum(done)[:-1]]).astype(np.int64)
    clamped = np.minimum(rank, W - 1).astype(np.int32)
    want = np.asarray(slab_take_rows(
        jnp.asarray(packed[ptr0 : ptr0 + W + SLAB]), jnp.asarray(clamped), interpret=True))
    got = rt.take_rows(torch.from_numpy(packed), torch.tensor(ptr0), torch.from_numpy(rank), W)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p_done", [0.03, 0.5, 1.0])
def test_ring_take_matches_jax_ring_take(p_done):
    """Exact: the port's `ring.take` on a ring carried over from JAX
    `make_ring`, against JAX `ring.take`: the fresh states, the pointer and
    the overflow count (p_done=1.0 finishes more than W lanes)."""
    B, size, W = 1024, 2048, 512
    jr = jring.make_ring(jax.random.PRNGKey(0), size, window=W)
    jr = jr.replace(ptr=jnp.int32(1900))  # so the take crosses the mirrored tail
    pr = ring.FreshGameRing(
        packed=torch.from_numpy(np.array(jr.packed)),
        mask0=torch.from_numpy(np.array(jr.mask0)),
        ptr=torch.tensor(int(jr.ptr)), overflow=torch.tensor(int(jr.overflow)), size=size,
    )
    done = np.random.RandomState(1).rand(B) < p_done
    for _ in range(2):
        jfresh, jmask, jr = jring.take(jr, jnp.asarray(done))
        pfresh, pmask, pr = ring.take(pr, torch.from_numpy(done))
        for k in S.FIELDS:
            got, want = getattr(pfresh, k).numpy(), np.asarray(getattr(jfresh, k))
            np.testing.assert_array_equal(got[done], want[done], err_msg=k)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        assert int(pr.ptr) == int(jr.ptr) and int(pr.overflow) == int(jr.overflow)
    if p_done == 1.0:
        assert int(pr.overflow) == 2 * (B - W)


def test_ring_unpack_inverts_pack():
    st = S.initial_state(32, torch.Generator().manual_seed(5), device="cpu")
    back = ring._unpack_state(ring._pack(st))
    for k in S.FIELDS:
        assert torch.equal(getattr(back, k), getattr(st, k)), k

