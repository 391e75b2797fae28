"""PyTorch/CUDA port of splendax for one NVIDIA H100.

Imports torch and numpy only; the JAX package `splendax` is the reference
it is tested against.  See README.md, "PyTorch/CUDA port".  Entry points run
on the card unless given `device="cpu"`.

Exports resolve lazily (PEP 562), as in `splendax/__init__.py`, so that
`import splendax_torch` loads nothing but this map.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "GameState": "splendax_torch.engine.state",
    "initial_state": "splendax_torch.engine.state",
    "initial_state_parity": "splendax_torch.engine.state",
    "legal_mask": "splendax_torch.engine.rules",
    "apply_action": "splendax_torch.engine.rules",
    "is_terminal": "splendax_torch.engine.rules",
    "encode_observation": "splendax_torch.engine.encode",
    "TOTAL_ACTIONS": "splendax_torch.engine.rules",
    "OBSERVATION_DIM": "splendax_torch.engine.encode",
    "reset": "splendax_torch.env.core",
    "step": "splendax_torch.env.core",
    "reset_batch": "splendax_torch.env.core",
    "step_batch": "splendax_torch.env.core",
    "step_autoreset": "splendax_torch.env.core",
    "StepOutput": "splendax_torch.env.core",
    "SplendaxVectorEnv": "splendax_torch.env.vector",
    "make_vector": "splendax_torch.env.vector",
    "FreshGameRing": "splendax_torch.env.ring",
    "make_ring": "splendax_torch.env.ring",
    "step_autoreset_ring": "splendax_torch.env.ring",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'splendax_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cache for later lookups
    return value


def __dir__():
    return __all__
