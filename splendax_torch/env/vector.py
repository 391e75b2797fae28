"""Gymnasium `VectorEnv` over the port's batched engine.

Counterpart of `splendax/env/vector.py`: N lockstep games behind the
standard vector API, so gymnasium-based code can drop them in:

    envs = SplendaxVectorEnv(num_envs=1024)        # on the card
    obs, infos = envs.reset(seed=0)
    obs, r, term, trunc, infos = envs.step(actions)

Semantics, as in the JAX package:
  * gymnasium's `NEXT_STEP` (the 1.x default) and `SAME_STEP` autoreset
    modes.  `NEXT_STEP`: a lane that ended at step t ignores its action at
    t+1 and returns a fresh game's observation with reward 0.  `SAME_STEP`:
    the lane restarts within the step that ended it; the terminal
    observation rides in `infos["final_obs"]` (an object array), as
    SyncVectorEnv delivers it.
  * Infos always carry `action_mask` (int8 [N, 45]) and `to_play` (int32
    [N]); `illegal_action`, `draw`, `turn_limit` and `final_rewards` appear
    with gymnasium's `_<key>` presence masks when a lane has them.
  * Backend "torch" (the default) steps every lane in one batched engine
    call on `device`, the card unless `device="cpu"` is given; its fast-mode
    deals come from a `torch.Generator` seeded by the reset seed.  Backend
    "native" steps them in one OpenMP-parallel C++ call with the reference's
    per-lane CPython-parity streams: `SplendaxVectorEnv(n, backend="native")`
    is bit-identical to `gym.vector.SyncVectorEnv` over n
    `SplendorEnv(backend="native")`, autoreset included.

Without gymnasium the env still runs, on the stand-ins of `env._gym`.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..engine import rules
from ..engine.encode import OBSERVATION_DIM, encode_observation
from ..engine.rules import TOTAL_ACTIONS
from ..engine.state import GameState, initial_state
from . import core
from ._gym import AutoresetMode, VectorEnv, batch_space, spaces

# The largest value any observation entry reaches: move_count (offset 295)
# hits 2 * TURN_LIMIT = 200 at the turn-limit draw.
_OBS_HIGH = 200


def _step_next(states, mask, actions, pending, generator):
    """NEXT_STEP autoreset: step every lane, then replace the lanes that
    ended LAST step with fresh games (their action ignored, reward 0, flags
    cleared: gymnasium 1.x SyncVectorEnv semantics)."""
    next_state, out = core.step(states, actions, mask=mask)
    fresh_state, fresh_obs, fresh_mask = core.reset(actions.shape[0], generator, actions.device)
    carry = core.select(pending, fresh_state, next_state)
    obs = core.select(pending, fresh_obs, out.obs)
    mask_next = core.select(pending, fresh_mask, out.action_mask)
    zero = torch.zeros((), dtype=torch.bool, device=actions.device)
    out = core.StepOutput(
        obs=obs, action_mask=mask_next,
        reward=torch.where(pending, 0.0, out.reward),
        terminated=torch.where(pending, zero, out.terminated),
        illegal_action=torch.where(pending, zero, out.illegal_action),
        draw=torch.where(pending, zero, out.draw),
        turn_limit=torch.where(pending, zero, out.turn_limit),
        final_rewards=torch.where(pending[:, None], 0.0, out.final_rewards),
        to_play=torch.where(pending, 0, out.to_play).to(out.to_play.dtype),
    )
    return carry, out, obs, mask_next


def _to_host(out: core.StepOutput, obs, mask) -> SimpleNamespace:
    """The step's outputs as numpy arrays, in one device-to-host copy of
    the small fields beside the obs and the mask."""
    small = torch.cat([out.reward[:, None], out.final_rewards, out.to_play[:, None].float(),
                       torch.stack([out.terminated, out.illegal_action, out.draw,
                                    out.turn_limit], 1).float()], 1).cpu().numpy()
    return SimpleNamespace(
        obs=obs.cpu().numpy(), mask=mask.cpu().numpy().astype(np.int8),
        reward=small[:, 0].astype(np.float64), final_rewards=small[:, 1:3],
        to_play=small[:, 3].astype(np.int32), terminated=small[:, 4] > 0,
        illegal_action=small[:, 5] > 0, draw=small[:, 6] > 0, turn_limit=small[:, 7] > 0,
    )


class SplendaxVectorEnv(VectorEnv):
    """N lockstep Splendor games behind the gymnasium vector API."""

    metadata = {"autoreset_mode": {AutoresetMode.NEXT_STEP, AutoresetMode.SAME_STEP}}

    def __init__(
        self,
        num_envs: int = 16,
        autoreset_mode: AutoresetMode = AutoresetMode.NEXT_STEP,
        device="cuda",
        backend: str = "torch",
    ):
        self.num_envs = int(num_envs)
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if isinstance(autoreset_mode, str):
            autoreset_mode = AutoresetMode(autoreset_mode)
        if autoreset_mode not in self.metadata["autoreset_mode"]:
            raise ValueError(
                f"unsupported autoreset_mode {autoreset_mode}; supported: "
                f"{self.metadata['autoreset_mode']}"
            )
        # The torch backend's device; the native backend runs on the host.
        self._device = resolve_device(device) if backend == "torch" else None
        if backend == "native":
            from .. import native as native_mod

            native_mod._load()  # raise now if the library cannot be built
            self._nb = native_mod.NativeBatch(self.num_envs)
            self._lane_rngs = None
        self.backend = backend
        self.autoreset_mode = autoreset_mode
        self.metadata = dict(self.metadata, autoreset_mode=autoreset_mode)
        self.render_mode = None

        self.single_action_space = spaces.Discrete(TOTAL_ACTIONS)
        self.single_observation_space = spaces.Box(
            low=0, high=_OBS_HIGH, shape=(OBSERVATION_DIM,), dtype=np.int32
        )
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)

        self._states = None
        self._mask = None  # the legal masks of the carried states
        self._pending = None  # bool [N] host array: NEXT_STEP lanes awaiting reset
        self._gen = None

    # -- helpers ---------------------------------------------------------------

    def _info_dict(self, mask, to_play, out=None) -> Dict[str, Any]:
        n = self.num_envs
        infos: Dict[str, Any] = {
            "action_mask": np.asarray(mask, dtype=np.int8),
            "_action_mask": np.ones(n, dtype=bool),
            "to_play": np.asarray(to_play, dtype=np.int32),
            "_to_play": np.ones(n, dtype=bool),
        }
        if out is not None:
            for name in ("illegal_action", "draw", "turn_limit"):
                flag = np.asarray(getattr(out, name), dtype=bool)
                if flag.any():
                    infos[name] = flag
                    infos[f"_{name}"] = flag
            term = np.asarray(out.terminated, dtype=bool)
            if term.any():
                infos["final_rewards"] = np.asarray(out.final_rewards, np.float32)
                infos["_final_rewards"] = term
        return infos

    # -- gymnasium vector API --------------------------------------------------

    def reset(
        self,
        *,
        seed: Optional[Union[int, Sequence[int]]] = None,
        options: Optional[Dict[str, Any]] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if self.backend == "native":
            return self._reset_native(seed)
        if seed is None:
            seed = int(np.random.SeedSequence().generate_state(1)[0])
        dev = self._device
        if isinstance(seed, (int, np.integer)):
            self._gen = torch.Generator(device=dev).manual_seed(int(seed))
            self._states = initial_state(self.num_envs, self._gen, dev)
        else:
            seeds = np.asarray(list(seed), dtype=np.uint32)
            if len(seeds) != self.num_envs:
                raise ValueError(f"got {len(seeds)} seeds for {self.num_envs} envs")
            # Lane i is dealt from its own seed; the autoreset stream depends
            # on EVERY seed (not just seeds[0]), or differently seeded runs
            # would share all fresh deals after the first game.
            uniq, inv = np.unique(seeds, return_inverse=True)
            deals = [initial_state(1, torch.Generator(device=dev).manual_seed(int(s)), dev)
                     for s in uniq]
            rows = torch.as_tensor(inv, device=dev)
            self._states = GameState(**{
                k: torch.cat([getattr(d, k) for d in deals])[rows] for k, _ in deals[0].items()})
            digest = hashlib.blake2s(seeds.tobytes(), digest_size=4).digest()
            self._gen = torch.Generator(device=dev).manual_seed(int.from_bytes(digest, "little"))
        obs = encode_observation(self._states)
        self._mask = rules.legal_mask(self._states)
        self._pending = np.zeros(self.num_envs, dtype=bool)
        to_play = np.zeros(self.num_envs, dtype=np.int32)
        return obs.cpu().numpy(), self._info_dict(self._mask.cpu().numpy(), to_play)

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("Call reset() before step().")
        actions = np.asarray(actions, dtype=np.int32)
        if actions.shape != (self.num_envs,):
            raise ValueError(f"actions must have shape ({self.num_envs},)")
        # Reject out-of-range actions like the single env does: the engine's
        # clip would otherwise silently PLAY action 44 for any action >= 45.
        if ((actions < 0) | (actions >= TOTAL_ACTIONS)).any():
            bad = actions[(actions < 0) | (actions >= TOTAL_ACTIONS)]
            raise ValueError(f"actions out of bounds for Discrete({TOTAL_ACTIONS}): {bad[:8]}")
        if self.backend == "native":
            return self._step_native(actions)
        a = torch.as_tensor(actions, device=self._device).long()
        if self.autoreset_mode == AutoresetMode.NEXT_STEP:
            if self._pending.any():
                pending = torch.as_tensor(self._pending, device=self._device)
                self._states, out, obs, mask_next = _step_next(
                    self._states, self._mask, a, pending, self._gen)
            else:
                self._states, out = core.step(self._states, a, mask=self._mask)
                obs, mask_next = out.obs, out.action_mask
            host = _to_host(out, obs, mask_next)
            final_obs = None
        else:  # SAME_STEP: reset within the terminating step
            self._states, out, obs, mask_next = core.step_autoreset(
                self._states, a, self._gen, mask=self._mask)
            host = _to_host(out, obs, mask_next)
            final_obs = out.obs.cpu().numpy() if host.terminated.any() else None
        self._mask = mask_next
        return self._package_step(host.obs, host.reward, host.terminated,
                                  self._info_dict(host.mask, host.to_play, host), final_obs)

    def _package_step(self, obs, reward, terminated, infos, final_obs):
        """Shared post-step packaging for both backends: pending-lane
        bookkeeping (NEXT_STEP) or the SyncVectorEnv SAME_STEP convention of
        terminal observations riding in infos as an object array."""
        if self.autoreset_mode == AutoresetMode.NEXT_STEP:
            self._pending = terminated.copy()
        elif terminated.any():
            fo = np.full(self.num_envs, None, dtype=object)
            for i in np.nonzero(terminated)[0]:
                fo[i] = final_obs[i]
            infos["final_obs"] = fo
            infos["_final_obs"] = terminated.copy()
        truncated = np.zeros(self.num_envs, dtype=bool)
        return obs, reward, terminated, truncated, infos

    # -- native (C++ host) backend ----------------------------------------------

    def _engine_seed(self, lane: int) -> int:
        # The single env's derivation (np_random PCG64 -> integers(0,
        # 2**31 - 1)); the stream persists across autoresets as a sub-env's
        # np_random does.
        return int(self._lane_rngs[lane].integers(0, 2**31 - 1))

    def _reset_native(self, seed):
        if seed is None:
            # An unseeded reset keeps the per-lane streams, as a gymnasium
            # Env.reset(seed=None) keeps its np_random.
            if self._lane_rngs is None:
                self._lane_rngs = [np.random.default_rng(None) for _ in range(self.num_envs)]
        else:
            if isinstance(seed, (int, np.integer)):
                # gymnasium's vector convention: sub-env i gets seed + i.
                lane_seeds = [int(seed) + i for i in range(self.num_envs)]
            else:
                lane_seeds = [int(s) for s in seed]
                if len(lane_seeds) != self.num_envs:
                    raise ValueError(f"got {len(lane_seeds)} seeds for {self.num_envs} envs")
            self._lane_rngs = [np.random.default_rng(s) for s in lane_seeds]
        engine_seeds = np.asarray([self._engine_seed(i) for i in range(self.num_envs)], np.int64)
        obs, mask = self._nb.reset(engine_seeds)
        self._mask = mask
        self._pending = np.zeros(self.num_envs, dtype=bool)
        to_play = np.zeros(self.num_envs, dtype=np.int32)
        self._states = self._nb.states  # not None: reset() was called
        return obs, self._info_dict(mask, to_play)

    def _step_native(self, actions: np.ndarray):
        n = self.num_envs
        if self.autoreset_mode == AutoresetMode.NEXT_STEP:
            pending = self._pending
            if pending.any():
                reset_seeds = np.zeros(n, np.int64)
                for i in np.nonzero(pending)[0]:
                    reset_seeds[i] = self._engine_seed(int(i))
                obs, mask, reward, flags, final = self._nb.step(
                    actions, pending.astype(np.int8), reset_seeds)
            else:
                obs, mask, reward, flags, final = self._nb.step(actions)
            final_obs = None
        else:  # SAME_STEP
            obs, mask, reward, flags, final = self._nb.step(actions)
            term = (flags & 1) != 0
            final_obs = obs.copy() if term.any() else None
            if term.any():
                idx = np.nonzero(term)[0]
                self._nb.reset_lanes(idx, [self._engine_seed(int(i)) for i in idx])
                for i in idx:
                    obs[i], mask[i] = self._nb.lane_obs_mask(int(i))
        self._mask = mask

        terminated = (flags & 1) != 0
        out = SimpleNamespace(
            terminated=terminated,
            illegal_action=(flags & 2) != 0,
            draw=(flags & 4) != 0,
            turn_limit=(flags & 8) != 0,
            final_rewards=final.astype(np.float32),
        )
        infos = self._info_dict(mask, self._nb.to_play(), out)
        return self._package_step(obs, reward, terminated, infos, final_obs)

    def close_extras(self, **kwargs):
        self._states = None


def make_vector(num_envs: int = 16, **kwargs) -> SplendaxVectorEnv:
    return SplendaxVectorEnv(num_envs=num_envs, **kwargs)
