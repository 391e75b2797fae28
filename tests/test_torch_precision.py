"""The numeric design of kernel A (the wgmma and wide routes'
`splendax_torch/csrc/fused_actor_critic_wgmma.cu`), emulated on the CPU.

The kernel takes each f32 product on the tensor cores as three TF32
products: with hi = tf32(a) and lo = tf32(a - hi), a b ~ hi hi + hi lo + lo hi,
summed in f32.  TF32 rounding is `cvt.rna`: round to nearest, ties away
from zero, to 10 explicit mantissa bits.  The product of two TF32 values
(11 significant bits each) is exact in f32, so the emulation differs from the
card only in the order of the sums.  Layer 1 drops lo hi where every obs is
exact in TF32 (|x| <= 2048), which the last test shows of the engine's obs.
"""

import os

import numpy as np
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
    1024: os.path.join(ROOT, "runs/ppo_splendor_2b_h1024/ppo_splendor_params.npz"),
}
TF32_EXACT = 2048


tf32 = fac.tf32  # f32 -> TF32 as `cvt.rna.tf32.f32` rounds (the last test pins it down)


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


# The wgmma route (`splendax_torch/csrc/fused_actor_critic_wgmma.cu`).


def random_weights(hidden, seed):
    """The 12 weights at hidden width `hidden`, uniform in +-1/sqrt(fan-in),
    from a numpy seed."""
    rng = np.random.RandomState(seed)
    out = []
    for n_out in (45, 1):
        for fi, fo in ((297, hidden), (hidden, hidden), (hidden, n_out)):
            bound = 1.0 / np.sqrt(fi)
            out.append(torch.from_numpy(rng.uniform(-bound, bound, (fi, fo)).astype(np.float32)))
            out.append(torch.from_numpy(rng.uniform(-bound, bound, (fo,)).astype(np.float32)))
    return out


@pytest.mark.parametrize("hidden", [37, 100, 256, 768])
def test_prepare_weights_plain_splits_exactly(hidden):
    """The preparation of aw0, aw1, cw0, cw1: [out, in] (K contiguous), hi and
    lo exact TF32 values, hi + lo within 2^-22 |w| of w, zeros padding both
    dimensions to multiples of 8 (the second layers' K to 16); without the
    critic its half is zero."""
    w = random_weights(hidden, seed=hidden)
    buf = fac.prepare_weights_plain(w)
    assert buf.dtype == torch.float32 and buf.numel() == fac.prepared_floats(hidden)
    hp = (hidden + 7) // 8 * 8
    mats = [buf[o:o + 2 * hp_ * kp].view(2, hp_, kp) for o, hp_, kp in fac.prepared_layout(hidden)]
    for m, i in zip(mats, (0, 2, 6, 8)):
        k = w[i].shape[0]
        assert m.shape == (2, hp, 304 if k == 297 else (k + 15) // 16 * 16)
        hi, lo = m[0], m[1]
        assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
        wt = w[i].t()
        err = (hi[:hidden, :k].double() + lo[:hidden, :k].double() - wt.double()).abs()
        assert (err <= 2.0 ** -22 * wt.double().abs()).all()
        assert (hi[:hidden, :k] - wt).abs().max() <= 2.0 ** -11 * wt.abs().max()
        pad = torch.ones_like(hi, dtype=torch.bool)
        pad[:hidden, :k] = False
        assert not hi[pad].any() and not lo[pad].any()
    actor_only = fac.prepare_weights_plain(w, with_value=False)
    cut = fac.prepared_layout(hidden)[2][0]
    assert torch.equal(actor_only[:cut], buf[:cut]) and not actor_only[cut:].any()
    assert torch.equal(fac.prepare_weights(w), buf)  # a CPU tensor takes the plain version


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero: the tensor cores' adds are
    modelled so, the harsher case for a long chain of them."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mm_wgmma(a, b, chunk, a_exact=False):
    """a @ b as the wgmma route takes it: K padded to a multiple of 8; in
    each k-step of 8, lo hi (unless a is exact in TF32), hi lo and hi hi,
    each an exact product of TF32 values added to the chunk's scratch sum
    with one rounding toward zero; the chunk's sum of `chunk` k-steps added
    to the f32 accumulator, rounded to nearest."""
    (B, K), N = a.shape, b.shape[1]
    n = -(-K // (8 * chunk))  # chunks; a last one padded with k-steps of zeros adds exact zeros
    kp = 8 * chunk * n
    a = torch.nn.functional.pad(a, (0, kp - K))
    b = torch.nn.functional.pad(b, (0, 0, 0, kp - K))
    ah, al = split(a)
    bh, bl = split(b)
    prods = [(ah, bl), (ah, bh)] if a_exact else [(al, bh), (ah, bl), (ah, bh)]
    # Every chunk's scratch sum at once: [chunks, B, N], its k-steps in order.
    s = torch.zeros(n, B, N, dtype=torch.float64)
    for q in range(chunk):
        for x, y in prods:
            xq = x.double().view(B, n, chunk, 8)[:, :, q].transpose(0, 1)
            yq = y.double().view(n, chunk, 8, N)[:, q]
            s = round_toward_zero(s + xq @ yq).double()
    acc = torch.zeros(B, N, dtype=torch.float32)
    for c in range(n):
        acc = acc + s[c].float()
    return acc


def fma32(a, b, c):
    """fmaf on float32: a b + c with one rounding (the float64 product of two
    float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def group_partials(h2, w2, wv, n0, hidden):
    """One consumer group's partial heads over the 64 columns from n0 of a
    pass, each from zero: the logits, a 3xTF32 product per group of 8
    columns added in f32; the value, each quad thread's f32 FMA chain over
    its 16 columns (8 i + 2 t + e, i then e), then summed over the quad as
    the two shuffles do, (t0 + t1) + (t2 + t3)."""
    B = h2.shape[0]
    logits = torch.zeros(B, w2.shape[1], dtype=torch.float32)
    for k0 in range(n0, min(n0 + 64, hidden), 8):
        logits = logits + mm_wgmma(h2[:, k0:k0 + 8], w2[k0:k0 + 8], chunk=1)
    lanes = []
    for t in range(4):
        v = torch.zeros(B, dtype=torch.float32)
        for i in range(8):
            for e in range(2):
                col = n0 + 8 * i + 2 * t + e
                if col < hidden:
                    v = fma32(h2[:, col], wv[col, 0].expand(B), v)
        lanes.append(v)
    return logits, (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def heads_tile(h2, w2, wv, hidden):
    """The heads as a tile-mode block sums them: each consumer group's
    partials added to its running sums pass by pass, from zero; then the two
    groups' sums added (the bias comes after)."""
    run = [[torch.zeros(h2.shape[0], w2.shape[1]), torch.zeros(h2.shape[0])] for _ in range(2)]
    for n0 in range(0, hidden, 128):
        for c in range(2):
            lg, v = group_partials(h2, w2, wv, n0 + 64 * c, hidden)
            run[c][0] = run[c][0] + lg
            run[c][1] = run[c][1] + v
    return run[0][0] + run[1][0], run[0][1] + run[1][1]


def heads_cluster(h2, w2, wv, hidden, per_block):
    """The heads as a cluster sums them: blocks of `per_block` passes each
    write the partials of their passes, then one reducer per output adds
    every pass's partials in pass order from zero, each consumer group's
    apart, then the two groups' sums."""
    passes = list(range(0, hidden, 128))
    written = {}
    for b0 in reversed(range(0, len(passes), per_block)):  # the blocks, in any order
        for n0 in passes[b0:b0 + per_block]:
            for c in range(2):
                written[n0, c] = group_partials(h2, w2, wv, n0 + 64 * c, hidden)
    out = []
    for j in range(2):  # logits, value
        sums = []
        for c in range(2):
            s = torch.zeros_like(written[0, 0][j])
            for n0 in passes:
                s = s + written[n0, c][j]
            sums.append(s)
        out.append(sums[0] + sums[1])
    return tuple(out)


def emulated_wgmma_forward(weights, obs, mask, chunk):
    """The wgmma route's forward, its heads summed as both modes sum them."""
    aw0, ab0, aw1, ab1, aw2, ab2, cw0, cb0, cw1, cb1, cw2, cb2 = weights
    hidden = aw0.shape[1]
    x = obs.to(torch.float32)
    exact = bool((x.abs() <= TF32_EXACT).all())
    h = torch.tanh(mm_wgmma(x, aw0, chunk, exact) + ab0)
    h = torch.tanh(mm_wgmma(h, aw1, chunk) + ab1)
    logits = fac.masked_logits(heads_tile(h, aw2, cw2, hidden)[0] + ab2, mask)
    v = torch.tanh(mm_wgmma(x, cw0, chunk, exact) + cb0)
    v = torch.tanh(mm_wgmma(v, cw1, chunk) + cb1)
    return logits, heads_tile(v, aw2, cw2, hidden)[1] + cb2[0]


def net_weights(hidden):
    """The committed net of that width, else seeded random weights (H=1280
    has no committed net)."""
    if hidden in NETS:
        return ac.kernel_weights(ac.import_params_npz(NETS[hidden], device="cpu"))
    return random_weights(hidden, seed=hidden)


@pytest.mark.parametrize("hidden, chunk", [(256, 1), (256, 2), (256, 4), (768, 1), (768, 2),
                                           (768, 4), (1024, 2), (1280, 2)])
def test_wgmma_arithmetic_matches_float64(batch, hidden, chunk):
    """rtol/atol 1e-5 of the float64 plain forward: the committed nets on
    engine obs (128 rows; H=1280 on seeded random weights), with the wgmma
    and wide routes' arithmetic at the chunk lengths tried on the card (2 is
    the routes'; 8 missed the contract there, at 1.13 of the tolerance on
    8192 rows), its heads summed as every mode sums them: per pass and
    consumer group from zero, in pass order.  The wide route (H > 768) sums
    layer 2 over pad16(H) / 16 chunks, held at the routes' chunk of two."""
    w = net_weights(hidden)
    obs, mask = batch[0][:128], batch[1][:128]
    lr, vr = fac.fused_masked_forward_plain([t.double() for t in w], obs, mask)
    le, ve = emulated_wgmma_forward(w, obs, mask, chunk)
    torch.testing.assert_close(le.double(), lr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ve.double(), vr, rtol=1e-5, atol=1e-5)
    assert (le[0] > -1e8).all()


@pytest.fixture(scope="module")
def whole_forwards(batch):
    """The 128-row forward through the routes' arithmetic, by width, each
    computed once."""
    cache = {}

    def get(hidden):
        if hidden not in cache:
            cache[hidden] = emulated_wgmma_forward(net_weights(hidden), batch[0][:128],
                                                   batch[1][:128], 2)
        return cache[hidden]

    return get


@pytest.mark.parametrize("hidden", [256, 768, 1024, 1280])
@pytest.mark.parametrize("B", [1, 17, 64])
def test_wgmma_rows_match_float64_at_any_b(batch, whole_forwards, hidden, B):
    """The first B of 128 rows through the wgmma and wide routes' arithmetic
    (chunks of two, the heads in the modes' order) equal the same rows of
    the 128-row forward bit for bit, and are within rtol/atol 1e-5 of the
    float64 plain forward."""
    w = net_weights(hidden)
    obs, mask = batch[0][:128], batch[1][:128]
    whole = whole_forwards(hidden)
    part = emulated_wgmma_forward(w, obs[:B], mask[:B], 2)
    for got, want in zip(part, whole):
        assert torch.equal(got, want[:B])
    lr, vr = fac.fused_masked_forward_plain([t.double() for t in w], obs[:B], mask[:B])
    torch.testing.assert_close(part[0].double(), lr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(part[1].double(), vr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden, per_block", [(37, 1), (100, 1), (256, 1), (256, 2), (300, 1),
                                               (300, 3), (768, 1), (768, 2), (768, 3), (768, 6)])
def test_wgmma_cluster_heads_equal_tile_heads(hidden, per_block):
    """The heads summed as a cluster sums them (blocks of `per_block` passes
    write their partials; one reducer an output adds them in pass order)
    equal the tile mode's running sums bit for bit, at any number of column
    groups: the two modes share one definition of the heads.  Seeded
    random second hidden layers (tanh range) and head weights; the sums are
    within rtol/atol 1e-5 of float64."""
    rng = np.random.RandomState(hidden + per_block)
    h2 = torch.from_numpy(np.tanh(rng.randn(40, hidden)).astype(np.float32))
    w = random_weights(hidden, seed=hidden)
    tile = heads_tile(h2, w[4], w[10], hidden)
    cluster = heads_cluster(h2, w[4], w[10], hidden, per_block)
    for got, want in zip(cluster, tile):
        assert torch.equal(got, want)
    exact = (h2.double() @ w[4].double(), (h2.double() @ w[10].double())[:, 0])
    for got, want in zip(tile, exact):
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [1, 37, 100, 128, 129, 256, 300, 640, 768])
def test_wgmma_mode_is_a_function_of_b_and_h(hidden):
    """The wgmma route's mode follows (B, H) alone, cluster mode up to
    CLUSTER_MAX_ROWS rows; its launch puts one block per 64-row tile, pass
    of 128 columns and head, the cluster over the passes of one tile and
    head: the cluster divides the grid and stays within the portable 8
    blocks.  Tile mode launches one block per tile, no cluster."""
    import inspect

    assert list(inspect.signature(fac.wgmma_mode).parameters) == ["B", "H"]
    groups = fac.column_groups(hidden)
    assert groups == -(-hidden // 128) and 1 <= groups <= fac.PORTABLE_CLUSTER
    for B in (1, 63, 64, 65, 512, fac.CLUSTER_MAX_ROWS, fac.CLUSTER_MAX_ROWS + 1, 8192, 737280):
        mode = fac.wgmma_mode(B, hidden)
        assert mode == ("cluster" if B <= fac.CLUSTER_MAX_ROWS else "tile")
        # Both heads, the actor alone and the critic alone (no actor).
        for with_value, actor in ((True, True), (False, True), (True, False)):
            for m in ("tile", "cluster"):
                grid, cluster = fac.launch_shape(B, hidden, with_value, m, actor=actor)
                assert grid[0] == -(-B // 64)
                assert all(g % c == 0 for g, c in zip(grid, cluster))
                assert cluster[0] * cluster[1] * cluster[2] <= fac.PORTABLE_CLUSTER
                if m == "cluster":
                    assert grid[1:] == (groups, 2 if with_value and actor else 1)
                    assert cluster == (1, groups, 1)
                else:
                    assert grid[1:] == (1, 1) and cluster == (1, 1, 1)


@pytest.mark.parametrize("hidden, want", [(1, "wgmma"), (256, "wgmma"), (768, "wgmma"),
                                          (769, "wide"), (1024, "wide"), (1280, "wide"),
                                          (2048, "wide")])
def test_route_follows_the_hidden_width(hidden, want):
    """H <= 768 takes the wgmma route (its 64-row tile holds the first hidden
    layer in shared memory), wider nets the wide route, at any width."""
    assert fac.route(hidden) == want


@pytest.mark.parametrize("hidden", [769, 1000, 1024, 1280, 2048, 2049, 4100])
def test_wide_launch_shape(hidden):
    """The wide route's launches: B cut into chunks of at most
    WIDE_MAX_ROWS rows that cover it in order; per chunk, layer 1 and layer
    2 a block per (128 columns in pass mode, 64 in half mode, 128-row tile,
    head), with no cluster, so no cluster limit at any width; half mode
    while pass mode's blocks would fill at most half of the H100's 132 SMs
    (WIDE_HALF_MAX_BLOCKS); the outputs a block per 8 rows; a scratch
    of h1 in f32 for every row and head, plus the per-(pass, column group)
    partial heads, sized by the chunk's rows and H, never by B beyond the
    chunk."""
    passes = -(-hidden // 128)
    kh = (hidden + 15) // 16 * 16
    for B in (1, 63, 64, 65, 1024, 1025, 8192, fac.WIDE_MAX_ROWS, fac.WIDE_MAX_ROWS + 1, 737280):
        chunks = fac.wide_chunks(B)
        assert chunks[0][0] == 0 and sum(n for _, n in chunks) == B
        assert all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
        assert all(0 < n <= fac.WIDE_MAX_ROWS for _, n in chunks)
        assert len(chunks) == -(-B // fac.WIDE_MAX_ROWS)
        for with_value in (True, False):
            heads = 2 if with_value else 1
            n = chunks[0][1]
            half = passes * -(-n // 128) * heads <= 66
            assert fac.wide_mode(B, hidden, with_value) == ("half" if half else "pass")
            for mode, blocks in (("pass", passes), ("half", 2 * passes)):
                shape = fac.wide_launch_shape(n, hidden, with_value, mode)
                assert shape["layers"] == (blocks, -(-n // 128), heads)
                assert shape["heads"] == (-(-n // 8), 1, 1)
                assert shape["layers"][1] <= 65535  # the grid's y
            floats = fac.wide_scratch_floats(n, hidden, with_value)
            assert floats == n * (heads * kh + passes * 2 * 48 + (passes * 2 if with_value else 0))
            # the scratch follows the chunk, so it stops growing past WIDE_MAX_ROWS
            assert floats <= fac.wide_scratch_floats(fac.WIDE_MAX_ROWS, hidden, with_value)
        # The critic alone: one head on the layers' z, in the mode of the call
        # with both heads; the scratch its h1 plane and the partial values.
        for mode, blocks in (("pass", passes), ("half", 2 * passes)):
            shape = fac.wide_launch_shape(chunks[0][1], hidden, True, mode, actor=False)
            assert shape["layers"] == (blocks, -(-chunks[0][1] // 128), 1)
        assert fac.wide_scratch_floats(chunks[0][1], hidden, True, actor=False) == (
            chunks[0][1] * (kh + passes * 2))
    if hidden == 1024:
        # The pool slot's forward (B = 1024, no value) in the mode it
        # derives: 128 blocks a layer, near the H100's 132 SMs, not 64; the
        # agent forward (B = 1024 with value) already 128 in pass mode.
        for with_value, mode in ((False, "half"), (True, "pass")):
            assert fac.wide_mode(1024, 1024, with_value) == mode
            layers = fac.wide_launch_shape(1024, 1024, with_value, mode)["layers"]
            assert layers[0] * layers[1] * layers[2] == 128


def test_route_takes_no_batch_size():
    """The route is a function of H alone: rows split across calls (a dp
    rank's share, a pool slot's) take the same kernel as in one call."""
    import inspect

    assert list(inspect.signature(fac.route).parameters) == ["H"]
