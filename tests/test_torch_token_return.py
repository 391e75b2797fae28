"""The fast-mode token return (`splendax_torch.ops.token_return`) on the CPU:
its plain version against the JAX engine's on fuzzed, unreachable hands, and
the wrapper's input checks.  On the card the ply's kernel draws the token
return itself and is held against the plain version there
(`tests/test_torch_cuda.py`)."""

import functools

import jax
import numpy as np
import pytest
import torch

from _token_hands import fuzzed_hands
from splendax.engine import rules as jrules
from splendax.engine.types import GameState as JGameState
from splendax_torch.engine import rules, state as S
from splendax_torch.ops import engine_ply as ep
from splendax_torch.ops import token_return as tr

B = 512


@functools.lru_cache(maxsize=None)
def _jax_return():
    """JAX's fast-mode token return of one game, vmapped and jitted once."""
    return jax.jit(jax.vmap(lambda s: jrules._auto_return_tokens(s, s.to_play, "fast")))


def _torch(h):
    return {k: torch.from_numpy(v) for k, v in h.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_the_jax_token_return(seed):
    """Exact: the plain version's tokens and bank against the JAX engine's
    fast mode on 512 fuzzed games a seed (every k from 0 to 12, gold-only
    hands, colours that run out, hands past 22, turns up to 2**20)."""
    h = fuzzed_hands(np.random.RandomState(seed), B)
    blank = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
             for k, v in S._blank_state_np().items()}
    js = _jax_return()(JGameState(**{**blank, **h}))
    tokens, bank = tr.return_tokens_plain(**_torch(h))
    np.testing.assert_array_equal(np.asarray(js.tokens), tokens.numpy())
    np.testing.assert_array_equal(np.asarray(js.bank), bank.numpy())
    k = np.maximum(h["tokens"][np.arange(B), h["to_play"]].sum(1) - 10, 0)
    assert set(range(13)) <= set(k.tolist())


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors `return_tokens` is the plain version: fresh outputs,
    the other player's row as it was; and a CPU `apply_action` in fast mode
    goes through it, with no kernel launch counted."""
    h = _torch(fuzzed_hands(np.random.RandomState(5), 300))
    before = dict(ep.launches)
    tokens, bank = tr.return_tokens(**h)
    want = tr.return_tokens_plain(**h)
    assert torch.equal(tokens, want[0]) and torch.equal(bank, want[1])
    assert tokens.data_ptr() != h["tokens"].data_ptr() and bank.data_ptr() != h["bank"].data_ptr()
    other = 1 - h["to_play"].long()
    ar = torch.arange(300)
    assert torch.equal(tokens[ar, other], h["tokens"][ar, other])
    st = S.initial_state(4, torch.Generator().manual_seed(0), device="cpu")
    rules.apply_action(st, torch.zeros(4, dtype=torch.int64))
    assert ep.launches == before


BAD_INPUTS = {
    "tokens int64": lambda h: dict(h, tokens=h["tokens"].long()),
    "bank [B, 5]": lambda h: dict(h, bank=h["bank"][:, :5]),
    "to_play of B + 1": lambda h: dict(h, to_play=torch.zeros(9, dtype=torch.int32)),
    "turn_count float": lambda h: dict(h, turn_count=h["turn_count"].float()),
    "tokens [B, 12]": lambda h: dict(h, tokens=h["tokens"].reshape(8, 12)),
    "meta device": lambda h: {k: v.to("meta") for k, v in h.items()},
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_return_tokens_refuses_what_the_kernel_does_not_take(case):
    """Inputs of another dtype, shape or batch, or on a device that is
    neither the CPU nor the card, raise `ValueError` before any work."""
    h = BAD_INPUTS[case](_torch(fuzzed_hands(np.random.RandomState(0), 8)))
    with pytest.raises(ValueError, match="return_tokens"):
        tr.return_tokens(**h)
