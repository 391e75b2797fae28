"""Kernel A's prepared-weight handles (`fused_actor_critic.PreparedWeights`)
on the CPU: when a handle prepares, for each writer of the weights it must
survive, and that a forward through a handle is the forward through its
plain list.

The decision to prepare does not depend on the device: on the CPU a
handle's `buffer()` takes `prepare_weights_plain` and counts in
`preparations` as it counts a kernel launch on the card.  After every write
each handle's buffer must equal the plain preparation of its weights as
they are now, and each handle must have prepared exactly as often as the
write calls for.  The tp gather's case is in tests/test_torch_parallel.py
(it needs gloo ranks)."""

import copy
import pickle

import numpy as np
import pytest
import torch

from splendax_torch import bench
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.search import mc
from splendax_torch.selfplay import pool as pool_lib
from splendax_torch.train import checkpoint, optim, ppo
from splendax_torch.train.config import PPOConfig

CFG = PPOConfig(num_envs=8, num_steps=2, minibatch_size=8, total_timesteps=64, hidden=16,
                pool_size=3)


def numpy_weights(hidden, seed):
    """12 kernel-layout tensors drawn with numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for n_out in (45, 1):
        for fi, fo in ((297, hidden), (hidden, hidden), (hidden, n_out)):
            out += [torch.as_tensor(rng.uniform(-1, 1, (fi, fo)).astype(np.float32)),
                    torch.as_tensor(rng.uniform(-1, 1, (fo,)).astype(np.float32))]
    return out


def other_model(seed):
    return ac.params_from_jax(
        {f"{h}.{i}.{k}": v.numpy() for (h, i, k), v in zip(
            [(h, i, k) for h in ("actor", "critic") for i in range(3) for k in ("w", "b")],
            numpy_weights(CFG.hidden, seed))}, device="cpu")


def prepared_state():
    """A tiny TrainState with every pool slot's handle prepared."""
    ts = ppo.init_train_state(CFG, device="cpu")
    for h in ts.pool.slots:
        h.buffer()
    return ts


def holds_plain(h) -> bool:
    """The handle's buffer (prepared again if stale) is the plain
    preparation of its weights as they are now."""
    return torch.equal(h.buffer(), fac.prepare_weights_plain(list(h)))


def counts(handles):
    return [h.preparations for h in handles]


def write_set_current(ts):
    pool = pool_lib.set_current(ts.pool, other_model(1))
    assert all(torch.equal(a, b) for a, b in zip(pool.slot(3), ac.kernel_weights(other_model(1))))
    return pool.slots, [1, 1, 1, 2]


def write_push_snapshot(ts):
    pool = pool_lib.push_snapshot(pool_lib.push_snapshot(ts.pool, other_model(1)), other_model(2))
    return pool.slots, [2, 2, 1, 1]


def write_push_then_set_current(ts):
    """A snapshot push at the end of one update, then `set_current` at the
    start of the next, before any forward: the pushed slot's write is not
    hidden by CURRENT's, though both move every slot's counters."""
    pool = pool_lib.set_current(pool_lib.push_snapshot(ts.pool, other_model(1)), other_model(2))
    return pool.slots, [2, 1, 1, 2]


def write_raw_stack_write(ts):
    """A write to the stack outside the pool's own writes moves every
    slot's counters, and every slot prepares again."""
    ts.pool.stack[2][1].add_(0.5)  # aw1 of slot 1, in place
    return ts.pool.slots, [2, 2, 2, 2]


def write_optimizer_step(ts):
    """`optim.step` on the live params: a handle of `kernel_weights` holds
    copies of the weights (and the live biases, which no preparation
    reads), so it keeps its preparation; a handle over the tensors that
    the step writes in place (`_foreach_addcdiv_`) prepares again."""
    model = ts.params
    live = fac.PreparedWeights(ac.kernel_weights(model))
    own = fac.PreparedWeights([w.clone() for w in ac.kernel_weights(model)])
    live.buffer(), own.buffer()
    params = list(model.parameters())
    optim.step(params, [torch.full_like(p, 0.1) for p in params], optim.init(params), 1e-2)
    optim.step(list(own), [torch.full_like(w, 0.1) for w in own], optim.init(own), 1e-2)
    assert not torch.equal(own[2], live[2])
    return [live, own], [1, 2]


def write_checkpoint_restore(ts):
    """`checkpoint.load_state_dict`: a new stack, so new handles, each
    prepared at its first forward; and the live params written in place by
    `load_state_dict`, which a handle of `kernel_weights` does not read."""
    ts.pool = pool_lib.set_current(ts.pool, other_model(1))
    saved = checkpoint.state_dict(ts)
    fresh = prepared_state()
    live = fac.PreparedWeights(ac.kernel_weights(fresh.params))
    live.buffer()
    restored = checkpoint.load_state_dict(fresh, saved)
    assert all(torch.equal(a, b) for a, b in zip(restored.pool.stack, saved["pool"]["stack"]))
    assert all(h.stale() for h in restored.pool.slots)
    return restored.pool.slots + [live], [1, 1, 1, 1, 1]


def write_bench_restore(ts):
    """The bench's `save_state` / `restore_state` (a deep copy): the copy's
    handles take the preparations that were current, over views of the
    copy's own stack, so a write to the copy prepares there again and not
    in the original."""
    ts.pool = pool_lib.push_snapshot(ts.pool, other_model(1))  # slot 0 stale
    copied = bench.restore_state(bench.save_state(ts))
    assert [h.stale() for h in copied.pool.slots] == [True, False, False, False]
    pool = pool_lib.set_current(copied.pool, other_model(2))
    assert not ts.pool.slot(3).stale()
    assert not torch.equal(ts.pool.slot(3)[0], pool.slot(3)[0])
    return pool.slots + ts.pool.slots, [1, 0, 0, 1, 2, 1, 1, 1]


WRITERS = {
    "set_current": write_set_current,
    "push_snapshot": write_push_snapshot,
    "push_then_set_current": write_push_then_set_current,
    "raw_stack_write": write_raw_stack_write,
    "optimizer_step": write_optimizer_step,
    "checkpoint_restore": write_checkpoint_restore,
    "bench_restore": write_bench_restore,
}


@pytest.mark.parametrize("writer", list(WRITERS))
def test_writer_reprepares_before_next_forward(writer):
    """After each writer, every handle's buffer is the plain preparation of
    its weights as they are now, and each prepared as many times in all as
    the writes call for: once before the write (where it existed) and once
    after a write to a weight it read, never for a write the pool made to
    another slot."""
    torch.manual_seed(0)
    handles, want = WRITERS[writer](prepared_state())
    assert all(holds_plain(h) for h in handles)
    assert counts(handles) == want
    assert all(holds_plain(h) for h in handles) and counts(handles) == want  # no more


def test_every_slot_write_leaves_the_other_slots_prepared():
    """Writing each slot in turn, the written one prepares again and every
    other keeps its buffer, which stays the plain preparation of its own
    weights."""
    ts = prepared_state()
    pool = ts.pool
    for i in range(pool.pool_size):
        pool = pool_lib.push_snapshot(pool, other_model(10 + i))
        assert [h.stale() for h in pool.slots] == [j == i for j in range(4)]
        assert all(holds_plain(h) for h in pool.slots)
    assert counts(pool.slots) == [2, 2, 2, 1]


def test_handle_prepares_once_per_version():
    w = numpy_weights(16, 3)
    h = fac.PreparedWeights(w)
    assert h.stale() and h.preparations == 0 and h.prepared_bytes == 0
    first = h.buffer()
    assert h.buffer() is first and h.preparations == 1 and not h.stale()
    assert h.prepared_bytes == 4 * fac.prepared_floats(16)
    w[4].add_(1.0)  # aw2: read by the kernel from the list, not prepared
    w[1].add_(1.0)
    assert not h.stale() and h.buffer() is first
    w[6].mul_(2.0)  # cw0
    assert h.stale() and holds_plain(h) and h.preparations == 2


def test_handle_buffer_serves_forwards_without_the_critic():
    """The handle prepares with the critic; the actor's half, all that a
    forward without value reads, is the without-value preparation's bits."""
    w = numpy_weights(24, 4)
    cut = fac.prepared_layout(24)[2][0]
    assert torch.equal(fac.PreparedWeights(w).buffer()[:cut],
                       fac.prepare_weights_plain(w, with_value=False)[:cut])


@pytest.mark.parametrize("with_value", [True, False])
def test_forward_on_handle_equals_plain_list(with_value):
    rng = np.random.RandomState(5)
    w = numpy_weights(16, 5)
    obs = torch.as_tensor(rng.randint(0, 8, (33, 297)).astype(np.int32))
    mask = torch.as_tensor(rng.rand(33, 45) < 0.4)
    got = fac.fused_masked_forward(fac.PreparedWeights(w), obs, mask, with_value)
    want = fac.fused_masked_forward(w, obs, mask, with_value)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_handle_reads_as_the_list():
    w = numpy_weights(16, 6)
    h = fac.PreparedWeights(w)
    assert len(h) == 12 and all(a is b for a, b in zip(h, w)) and list(h[:2]) == w[:2]
    aw0, *_ = h
    assert aw0 is w[0]
    with pytest.raises(ValueError, match="12 tensors"):
        fac.PreparedWeights(w[:11])
    assert mc.as_ctx(h) is h and mc.as_ctx(None) is None
    assert isinstance(mc.as_ctx(w), fac.PreparedWeights)
    assert isinstance(mc.as_ctx(ac.ActorCritic(16, device="cpu")), fac.PreparedWeights)


def test_copies_never_take_a_stale_preparation():
    """A deep copy keeps a current preparation (its own buffer, recorded
    at the copy's counters) and not a stale one; a pickled handle comes
    back unprepared."""
    w = numpy_weights(16, 7)
    h = fac.PreparedWeights(w)
    h.buffer()
    c = copy.deepcopy(h)
    assert not c.stale() and c.buffer() is not h.buffer() and torch.equal(c.buffer(), h.buffer())
    assert c.preparations == 0
    w[0].add_(1.0)
    assert h.stale() and not c.stale()
    assert copy.deepcopy(h).stale()
    assert pickle.loads(pickle.dumps(h)).stale()


def test_failed_preparation_raises_and_stays_stale(monkeypatch):
    h = fac.PreparedWeights(numpy_weights(16, 8))

    def fails(*a, **k):
        raise RuntimeError("fused_actor_critic weight preparation failed: CUDA error 1")

    monkeypatch.setattr(fac, "prepare_weights", fails)
    with pytest.raises(RuntimeError, match="preparation failed"):
        h.buffer()
    assert h.stale() and h.preparations == 0 and h.prepared_bytes == 0
    monkeypatch.undo()
    assert holds_plain(h) and h.preparations == 1


def test_owners_build_handles():
    """The pool's slots, the eval policies and the search contexts hold
    handles; the rollout runs the CURRENT slot's."""
    from splendax_torch.eval import suite
    from splendax_torch.search import gumbel, uct

    ts = ppo.init_train_state(CFG, device="cpu")
    assert all(isinstance(ts.pool.slot(i), fac.PreparedWeights) for i in range(4))
    assert ts.pool.slot(3) is ts.pool.slot(3)
    assert ts.pool.replace(n_snapshots=1).slots is ts.pool.slots
    assert ts.pool.replace(stack=list(ts.pool.stack)).slots is not ts.pool.slots
    for spec in (suite.model_greedy_policy(ts.params), suite.model_sampling_policy(ts.params),
                 gumbel.gumbel_search_policy(params=ts.params), mc.mc_search_policy(params=ts.params),
                 uct.uct_search_policy(params=ts.params)):
        assert isinstance(spec[1], fac.PreparedWeights)
