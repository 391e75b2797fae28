"""Host self-play wrappers over the gym-compatible env.

Counterpart of `splendax/selfplay/wrappers.py`, with the reference wrapper
layer's behaviour: `SelfPlayWrapper` (the agent is player 0; the
opponent's terminal reward is sign-flipped for the agent),
`DualStepSelfPlayWrapper` (one step is a whole turn; the reward comes from
final_rewards[0]) and `DualStepNativeWrapper` (adds `dual_step()`, which
returns both players' data).  They serve compatibility and host-side
evaluation; batched rollouts use `selfplay.dual`.

`frozen_policy_from(params)` is the greedy host policy of a network: on a
card it runs the fused actor-critic kernel at B=1 without the critic, on
the CPU its plain version.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def random_opponent(obs, info):
    """Uniform over the legal actions (the reference's selfplay wrapper)."""
    mask = info.get("action_mask")
    if mask is None:
        return 0
    legal = np.flatnonzero(mask)
    if len(legal) == 0:
        return 0
    return int(np.random.choice(legal))


class _WrapperBase:
    """Minimal gym.Wrapper stand-in (works with or without gymnasium)."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()


class SelfPlayWrapper(_WrapperBase):
    """Single-agent view of the 2-player game; the agent is player 0.

    Reference semantics (selfplay.py:20-63): per-episode opponent sampling via
    `opponent_supplier`; random-starts coin flip (dead code in practice since
    player 0 always opens — preserved for parity); opponent's terminal reward
    sign-flipped for the agent.
    """

    def __init__(self, env, opponent_policy, random_starts: bool = True,
                 opponent_supplier: Optional[Callable] = None):
        super().__init__(env)
        self.opponent_policy = opponent_policy
        self.random_starts = random_starts
        self.opponent_supplier = opponent_supplier
        self._opp_policy = opponent_policy

    def reset(self, **kwargs):
        self._opp_policy = (
            self.opponent_supplier() if self.opponent_supplier is not None
            else self.opponent_policy
        )
        obs, info = self.env.reset(**kwargs)
        if self.random_starts and info.get("to_play", 0) == 1 and np.random.rand() < 0.5:
            a = self._opp_policy(obs, info)
            obs, _, term, trunc, info = self.env.step(a)
            if term or trunc:
                return obs, info
        while info.get("to_play", 0) == 1:
            a = self._opp_policy(obs, info)
            obs, _, term, trunc, info = self.env.step(a)
            if term or trunc:
                break
        return obs, info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        if term or trunc:
            return obs, reward, term, trunc, info
        if info.get("to_play", 0) == 1:
            a = self._opp_policy(obs, info)
            obs, opp_reward, term, trunc, info = self.env.step(a)
            reward = -opp_reward if (term or trunc) else 0.0
            return obs, reward, term, trunc, info
        raise RuntimeError(
            f"Invalid state: game not terminal but to_play={info.get('to_play')}"
        )


class DualStepSelfPlayWrapper(_WrapperBase):
    """One `step` = one complete turn; agent reward read from
    `final_rewards[0]` instead of sign-flipping (dual_step_selfplay.py:80-152)."""

    def __init__(self, env, opponent_policy, random_starts: bool = True,
                 opponent_supplier: Optional[Callable] = None):
        super().__init__(env)
        self.opponent_policy = opponent_policy
        self.random_starts = random_starts
        self.opponent_supplier = opponent_supplier
        self._opp_policy = opponent_policy
        self.turn_count = 0
        self.total_agent_actions = 0
        self.total_opponent_actions = 0

    def reset(self, **kwargs):
        self._opp_policy = (
            self.opponent_supplier() if self.opponent_supplier is not None
            else self.opponent_policy
        )
        self.turn_count = 0
        self.total_agent_actions = 0
        self.total_opponent_actions = 0
        obs, info = self.env.reset(**kwargs)
        while info.get("to_play", 0) == 1:
            a = self._opp_policy(obs, info)
            obs, _, term, trunc, info = self.env.step(a)
            self.total_opponent_actions += 1
            if term or trunc:
                break
        return obs, info

    def step(self, agent_action: int):
        self.turn_count += 1
        self.total_agent_actions += 1
        obs, r_agent, term, trunc, info = self.env.step(agent_action)
        turn_info = {
            "turn_count": self.turn_count,
            "agent_action": agent_action,
            "phase": "agent_only",
        }
        turn_info.update(info)
        if term or trunc:
            turn_info["game_ended_on"] = "agent_move"
            return obs, r_agent, term, trunc, turn_info
        if info.get("to_play", 0) != 1:
            raise RuntimeError(
                f"Invalid state after agent move: to_play={info.get('to_play')}"
            )
        opp_action = self._opp_policy(obs, info)
        self.total_opponent_actions += 1
        obs, r_opp, term, trunc, info = self.env.step(opp_action)
        turn_info.update(info)
        turn_info.update(
            {"opponent_action": opp_action, "opponent_reward": r_opp,
             "phase": "complete_turn"}
        )
        if term or trunc:
            turn_info["game_ended_on"] = "opponent_move"
            reward = info.get("final_rewards", {}).get(0, r_agent)
            return obs, reward, term, trunc, turn_info
        return obs, 0.0, term, trunc, turn_info

    def get_wrapper_stats(self) -> Dict[str, Any]:
        return {
            "turn_count": self.turn_count,
            "total_agent_actions": self.total_agent_actions,
            "total_opponent_actions": self.total_opponent_actions,
            "wrapper_type": "DualStepSelfPlayWrapper",
        }


class DualStepNativeWrapper(_WrapperBase):
    """Training default: `dual_step(a)` returns both players' data
    (dual_step_native.py:90-193); plain `step()` kept for compatibility."""

    def __init__(self, env, opponent_policy, random_starts: bool = True,
                 opponent_supplier: Optional[Callable] = None):
        super().__init__(env)
        self.opponent_policy = opponent_policy
        self.random_starts = random_starts
        self.opponent_supplier = opponent_supplier
        self._opp_policy = opponent_policy
        self.turn_count = 0
        self.total_agent_steps = 0
        self.total_opponent_steps = 0

    def reset(self, **kwargs):
        self._opp_policy = (
            self.opponent_supplier() if self.opponent_supplier is not None
            else self.opponent_policy
        )
        self.turn_count = 0
        self.total_agent_steps = 0
        self.total_opponent_steps = 0
        obs, info = self.env.reset(**kwargs)
        while info.get("to_play", 0) == 1:
            a = self._opp_policy(obs, info)
            obs, _, term, trunc, info = self.env.step(a)
            self.total_opponent_steps += 1
            if term or trunc:
                break
        return obs, info

    def step(self, action: int):
        agent_obs, agent_reward, _, _, done, info = self.dual_step(action)
        return agent_obs, agent_reward, done, False, info

    def dual_step(self, agent_action: int) -> Tuple[np.ndarray, float, np.ndarray, float, bool, Dict]:
        if getattr(self.env, "state", None) is None:
            raise RuntimeError("Cannot call dual_step() before reset()")
        if int(self.env.state.to_play) != 0:
            raise ValueError("dual_step() requires agent (player 0) to move first")
        self.turn_count += 1
        self.total_agent_steps += 1

        obs_a, r_a, done_a, trunc_a, info_a = self.env.step(agent_action)
        turn_info: Dict[str, Any] = {
            "turn_count": self.turn_count,
            "agent_action": agent_action,
            "phase": "agent_only",
        }
        turn_info.update(info_a)
        if done_a or trunc_a:
            opp_r = info_a.get("final_rewards", {}).get(1, 0.0)
            turn_info.update(
                {"opponent_action": None, "opponent_reward": opp_r,
                 "turn_complete": True, "game_ended_on": "agent_move"}
            )
            return obs_a, r_a, obs_a, opp_r, True, turn_info

        if int(self.env.state.to_play) != 1:
            raise ValueError(
                f"Expected opponent to move after agent, got to_play={int(self.env.state.to_play)}"
            )
        opp_action = self._opp_policy(obs_a, info_a)
        self.total_opponent_steps += 1
        obs_f, r_opp, done_f, trunc_f, info_f = self.env.step(opp_action)
        if done_f or trunc_f:
            agent_final = info_f.get("final_rewards", {}).get(0, 0.0)
            ended = "opponent_move"
        else:
            agent_final = 0.0
            ended = None
        turn_info.update(info_f)
        turn_info.update(
            {"opponent_action": opp_action, "opponent_reward": r_opp,
             "phase": "complete_turn", "turn_complete": True, "game_ended_on": ended}
        )
        return obs_f, agent_final, obs_f, r_opp, done_f, turn_info

    def get_wrapper_stats(self) -> Dict[str, Any]:
        return {
            "turn_count": self.turn_count,
            "total_agent_steps": self.total_agent_steps,
            "total_opponent_steps": self.total_opponent_steps,
            "wrapper_type": "DualStepNativeWrapper",
        }


_WRAPPERS = {
    "selfplay": SelfPlayWrapper,
    "dual": DualStepSelfPlayWrapper,
    "dual_native": DualStepNativeWrapper,
}


def make_env(
    opponent_policy: Optional[Callable] = None,
    opponent_supplier: Optional[Callable] = None,
    wrapper: str = "dual_native",
    random_starts: bool = False,
    rng_mode: str = "parity",
    backend: str = "auto",
    device="cuda",
) -> Callable:
    """A zero-argument thunk that builds the env and its wrapper, for vector
    env builders (the reference's training_utils.make_env)."""
    if wrapper not in _WRAPPERS:
        raise ValueError(f"wrapper must be one of {sorted(_WRAPPERS)}")

    def thunk():
        from ..env.gym_compat import SplendorEnv

        env = SplendorEnv(rng_mode=rng_mode, backend=backend, device=device)
        return _WRAPPERS[wrapper](
            env,
            opponent_policy or random_opponent,
            random_starts=random_starts,
            opponent_supplier=opponent_supplier,
        )

    return thunk


def frozen_policy_from(params) -> Callable:
    """Host (obs, info) -> greedy action policy of frozen params (an
    `ActorCritic`), on the params' device: the fused forward at B=1
    without the critic, then the argmax of the masked logits."""
    from ..models.actor_critic import kernel_weights
    from ..ops.fused_actor_critic import PreparedWeights, fused_masked_forward

    weights = PreparedWeights(kernel_weights(params))  # prepared once for every move
    device = weights[0].device

    def policy(obs, info):
        x = torch.as_tensor(np.asarray(obs, np.int32), device=device)[None]
        mask = torch.as_tensor(np.asarray(info["action_mask"]) > 0, device=device)[None]
        logits, _ = fused_masked_forward(weights, x, mask, with_value=False)
        return int(torch.argmax(logits[0]))

    return policy
