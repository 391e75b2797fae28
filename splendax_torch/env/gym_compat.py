"""Gymnasium-compatible single-game env over the port's engine.

Counterpart of `splendax/env/gym_compat.py`, and like it a drop-in for the
reference `SplendorEnv`: the same spaces, the same info dict (`action_mask`
int8[45], `to_play`, and `final_rewards`, `draw`, `illegal_action`,
`turn_limit` when they apply), the same reward contract and the same raise
after the episode ends.  It deals with `initial_state_parity` and steps with
`rng_mode="parity"` by default, so trajectories are bit-identical to the
reference (and to the JAX package) for the same gym seed.

Backends: "torch" steps the port's batched engine with B=1 on `device` (the
card by default: `device.resolve_device` raises without one, so pass
`device="cpu"` to run on the CPU); "native" steps the C++ host engine
(`splendax_torch.native`), whose state `env.state` shows on `device`;
"auto" picks native when `rng_mode="parity"` and the library builds, else
torch.  Batched workloads use `env.core` or `env.vector` instead.

Registered with gymnasium, or its stand-ins in `env._gym`, as
"SplendaxTorch-v0" (the JAX package's env is "Splendax-v0"), so
`gym.make("SplendaxTorch-v0", device="cpu")` works.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..engine import rules
from ..engine.encode import OBSERVATION_DIM, encode_observation
from ..engine.rules import TOTAL_ACTIONS
from ..engine.state import GameState, initial_state_parity
from . import core
from ._gym import gym, spaces

ENV_ID = "SplendaxTorch-v0"

# The host copy of one step's outputs: obs | mask | reward, terminated,
# illegal, draw, turn limit, to_play | final rewards.  float32 holds every
# value exactly (obs entries are small integers).
_FLAG_NAMES = ("terminated", "illegal_action", "draw", "turn_limit")


def _step_to_host(out: core.StepOutput) -> np.ndarray:
    """One step's outputs of game 0 in one device-to-host copy."""
    parts = [out.obs[0], out.action_mask[0], out.reward[:1]]
    parts += [getattr(out, name)[:1] for name in _FLAG_NAMES]
    parts += [out.to_play[:1], out.final_rewards[0]]
    return torch.cat([p.to(torch.float32) for p in parts]).cpu().numpy()


class SplendorEnv(gym.Env):
    metadata = {"render_modes": ["human"], "name": ENV_ID}

    def __init__(
        self,
        num_players: int = 2,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,  # accepted and ignored, as by the reference
        rng_mode: str = "parity",
        backend: str = "auto",
        device="cuda",
    ):
        super().__init__()
        if num_players != 2:
            raise NotImplementedError("Current env supports 2 players only.")
        self.num_players = num_players
        self.render_mode = render_mode
        self.rng_mode = rng_mode
        self.device = resolve_device(device)

        self.action_space = spaces.Discrete(TOTAL_ACTIONS)
        # Box(0, 50) is the reference's declared bound, kept for API parity,
        # though move_count (obs[295]) reaches 200 before the turn limit;
        # `vector.SplendaxVectorEnv` declares the true bound, Box(0, 200).
        self.observation_space = spaces.Box(
            low=0, high=50, shape=(OBSERVATION_DIM,), dtype=np.int32
        )
        self._state: Optional[GameState] = None
        self._terminal = False  # host copy of is_terminal(self._state)
        self._native = None  # NativeGame when the native backend is active
        self.current_player: int = 0

        if backend == "auto":
            backend = "torch"
            if rng_mode == "parity":
                from .. import native

                if native.is_available():
                    backend = "native"
        elif backend == "native":
            from .. import native

            if rng_mode != "parity":
                raise ValueError(
                    "backend='native' implements parity semantics; use "
                    "rng_mode='parity' (or backend='torch' for fast mode)"
                )
            native._load()  # raise now if the library cannot be built
        elif backend != "torch":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend

    @property
    def state(self) -> Optional[GameState]:
        """The current game as a `GameState` with B=1 (from the native flat
        state on demand)."""
        if self._native is not None:
            return self._native.to_game_state(self.device)
        return self._state

    @state.setter
    def state(self, value: Optional[GameState]) -> None:
        if self._native is not None:
            raise AttributeError(
                "cannot assign state on the native backend; use backend='torch'"
            )
        self._state = value
        self._terminal = value is not None and bool(rules.is_terminal(value)[0])

    # -- gym API ------------------------------------------------------------
    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        super().reset(seed=seed)
        engine_seed = int(self.np_random.integers(0, 2**31 - 1))
        if self.backend == "native":
            from .. import native

            self._native = native.NativeGame(engine_seed)
            obs = self._native.observation()
            mask = self._native.legal_mask()
            self.current_player = int(self._native.field("to_play"))
            return obs, {"action_mask": mask, "to_play": self.current_player}
        self.state = initial_state_parity(engine_seed, self.device)
        self.current_player = int(self._state.to_play[0])
        obs = encode_observation(self._state)[0].cpu().numpy()
        mask = rules.legal_mask(self._state)[0].cpu().numpy().astype(np.int8)
        return obs, {"action_mask": mask, "to_play": self.current_player}

    def step(self, action: int):
        if self.backend == "native":
            return self._step_native(action)
        assert self._state is not None, "Call reset() first"
        if self._terminal:
            raise RuntimeError(
                "Cannot call step() after episode termination. Call reset()."
            )
        if not (0 <= int(action) < TOTAL_ACTIONS):
            raise ValueError("Action out of bounds for action_space")
        a = torch.full((1,), int(action), dtype=torch.int64, device=self.device)
        self._state, out = core.step(self._state, a, rng_mode=self.rng_mode)
        host = _step_to_host(out)
        A = OBSERVATION_DIM + TOTAL_ACTIONS
        obs = host[:OBSERVATION_DIM].astype(np.int32)
        terminated, illegal, draw, turn_limit = (bool(x) for x in host[A + 1: A + 5])
        self._terminal = terminated
        info: Dict[str, Any] = {
            "action_mask": host[OBSERVATION_DIM:A].astype(np.int8),
            "to_play": int(host[A + 5]),
        }
        if illegal:
            info["illegal_action"] = True
        if draw:
            info["draw"] = True
        if turn_limit:
            info["turn_limit"] = True
        # The reference's stalemate draw returns without `final_rewards`;
        # only the other terminations attach it.  Wrappers read it with `.get`.
        if terminated and not draw:
            info["final_rewards"] = {0: float(host[A + 6]), 1: float(host[A + 7])}
        return obs, float(host[A]), terminated, False, info

    def _step_native(self, action: int):
        from .. import native

        assert self._native is not None, "Call reset() first"
        if self._native.is_terminal():
            raise RuntimeError(
                "Cannot call step() after episode termination. Call reset()."
            )
        if not (0 <= int(action) < TOTAL_ACTIONS):
            raise ValueError("Action out of bounds for action_space")
        obs, reward, flags, mask = self._native.env_step(int(action))
        terminated = bool(flags & native.F_TERMINATED)
        info: Dict[str, Any] = {
            "action_mask": mask,
            "to_play": int(self._native.field("to_play")),
        }
        if flags & native.F_ILLEGAL:
            info["illegal_action"] = True
        if flags & native.F_DRAW:
            info["draw"] = True
        if flags & native.F_TURN_LIMIT:
            info["turn_limit"] = True
        if terminated and not (flags & native.F_DRAW):
            fr = self._native.final_rewards()
            info["final_rewards"] = {0: fr[0], 1: fr[1]}
        return obs, reward, terminated, False, info

    def get_final_rewards(self) -> Dict[int, float]:
        """Both players' rewards once the game is over (the reference's
        get_final_rewards)."""
        if self._native is not None:
            if not self._native.is_terminal():
                raise RuntimeError("Cannot get final rewards for non-terminal state")
            fr = self._native.final_rewards()
            return {0: fr[0], 1: fr[1]}
        if not self._terminal:
            raise RuntimeError("Cannot get final rewards for non-terminal state")
        fr = core.final_rewards_of(self._state)[0].tolist()
        return {0: float(fr[0]), 1: float(fr[1])}

    def render(self):
        if self.render_mode not in ("human", None):
            return
        assert self.state is not None
        from ..tools.game_logger import format_game_state

        print(format_game_state(self.state))


def make(num_players: int = 2, render_mode: Optional[str] = None, seed: Optional[int] = None,
         device="cuda") -> SplendorEnv:
    return SplendorEnv(num_players=num_players, render_mode=render_mode, seed=seed,
                       device=device)


try:
    gym.register(id=ENV_ID, entry_point="splendax_torch.env.gym_compat:SplendorEnv")
except gym.error.Error:  # pragma: no cover - registered twice
    pass
