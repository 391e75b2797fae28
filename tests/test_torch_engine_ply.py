"""The fast-mode ply's kernels (`splendax_torch.ops.engine_ply`) on the CPU:
the dispatch that keeps CPU tensors and parity mode on the plain functions,
the card and noble tables generated for the kernel, and the wrapper's
refusals.  The kernels themselves are held against the plain functions on
the card (`tests/test_torch_cuda.py`)."""

import types

import numpy as np
import pytest
import torch

from splendax_torch import trace
from splendax_torch.engine import data as D
from splendax_torch.engine import rules
from splendax_torch.env import core
from splendax_torch.env import ring as ring_lib
from splendax_torch.ops import _build, engine_ply, engine_tables
from splendax_torch.search import gumbel, mc
from splendax_torch.selfplay import dual
from splendax_torch.selfplay.opponents import uniform_legal_action


def _games(B: int, plies: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    st, _, mask = core.reset(B, g, "cpu")
    for _ in range(plies):
        st, _, _, mask = core.step_autoreset(st, uniform_legal_action(mask, g), g, mask=mask)
    return st, mask, g


def _launches() -> int:
    return sum(trace.counters("engine_ply.launches.").values())


def test_generated_tables_equal_the_engine_data(tmp_path):
    """The header's packed words read back as `engine/data.py`'s tables, its
    record layout covers every GameState field but deck_perm in order, and
    writing it again leaves an unchanged file alone."""
    text = engine_tables.header()
    got = engine_tables.unpack(text)
    for name, table in got.items():
        np.testing.assert_array_equal(table, getattr(D, name), err_msg=name)
    assert text.count("__constant__") == 5
    assert f"constexpr int R_STRIDE = {engine_tables.R_STRIDE};" in text
    path = engine_tables.write(tmp_path)
    mtime = path.stat().st_mtime_ns
    assert path.read_text() == text and engine_tables.write(tmp_path).stat().st_mtime_ns == mtime
    assert "engine_ply" in _build.SOURCES
    from splendax_torch.engine.state import FIELDS

    assert [f for f, _, _ in engine_tables.RECORD] == [f for f in FIELDS if f != "deck_perm"]
    assert engine_tables.R_WORDS == 74 and engine_tables.R_STRIDE % 2 == 1


def test_dispatch_follows_the_device_and_the_mode():
    """A CUDA tensor in fast mode takes the kernels; parity mode, an unknown
    mode and a CPU tensor do not."""
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert engine_ply.takes(on_card, "fast")
    assert not engine_ply.takes(on_card, "parity") and not engine_ply.takes(on_card, "other")
    assert not engine_ply.takes(torch.zeros(1), "fast")


@pytest.mark.parametrize("rng_mode", ["fast", "parity"])
def test_cpu_sites_run_the_plain_functions(rng_mode):
    """On CPU tensors every call site of the kernels runs the plain
    functions: the same bits as the `_plain` versions, no kernel launch."""
    st, mask, g = _games(24, 20, 11)
    a = uniform_legal_action(mask, g)
    before = _launches()
    nxt, out = core.step(st, a, rng_mode=rng_mode, mask=mask)
    p_nxt, p_out = core.step_plain(st, a, rng_mode=rng_mode, mask=mask)
    assert all(torch.equal(x, getattr(p_nxt, k)) for k, x in nxt.items())
    assert all(torch.equal(getattr(out, k), getattr(p_out, k)) for k in vars(out))
    kid = rules.apply_action(st, a, rng_mode=rng_mode)
    p_kid = rules.apply_action_plain(st, a, rng_mode)
    assert all(torch.equal(x, getattr(p_kid, k)) for k, x in kid.items())
    s1, o1 = dual._agent_ply(st, a, mask, rng_mode=rng_mode)
    opp = uniform_legal_action(o1.action_mask | ~o1.action_mask.any(1, keepdim=True), g)
    dual._opponent_ply(s1, opp, o1.action_mask, o1.terminated, o1.reward, o1.final_rewards,
                       o1.turn_limit, rng_mode=rng_mode)
    done = torch.rand(24, generator=g) < 0.3
    obs, m = dual._observe(st, done, rng_mode=rng_mode)
    assert torch.equal(m, rules.legal_mask(st) & ~done[:, None])
    dual._reset(done, nxt, st, rng_mode=rng_mode)
    gumbel.children(st, torch.stack([a, (a + 3) % 45], 1), rng_mode=rng_mode)
    gumbel._lanes(st, torch.randint(0, 24, (48,), generator=g), rng_mode=rng_mode)
    mc.playout_step(st, a, mask, rng_mode=rng_mode)
    mc.observe(st, rng_mode=rng_mode)
    mc._flat_children(st, rng_mode=rng_mode, rollouts=1, with_obs=False)
    ring = ring_lib.make_ring(48, torch.Generator().manual_seed(5), "cpu", window=24)
    ring_lib.step_autoreset_ring(st, a, ring, rng_mode=rng_mode, mask=mask)
    assert _launches() == before


def test_kernels_refuse_cpu_tensors_and_bad_inputs():
    """The wrapper refuses CPU tensors, a field of another dtype or shape and
    a repeat below 1; nothing is launched."""
    st, mask, g = _games(8, 5, 12)
    a = uniform_legal_action(mask, g)
    before = _launches()
    with pytest.raises(ValueError, match="on the card"):
        engine_ply.step(st, a, mask)
    with pytest.raises(ValueError, match="on the card"):
        engine_ply.observe(st)
    with pytest.raises(ValueError, match="bank must be"):
        engine_ply.step(st.replace(bank=st.bank.long()), a)
    with pytest.raises(ValueError, match="tokens must be"):
        engine_ply.observe(st.replace(tokens=st.tokens[:, :1]))
    with pytest.raises(ValueError, match="game_over must be"):
        engine_ply.observe(st.replace(game_over=st.game_over.int()))
    with pytest.raises(ValueError, match="repeat"):
        engine_ply.step(st, a, apply_only=True, repeat=0)
    assert _launches() == before
