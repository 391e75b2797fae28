"""Training configuration: the port's own copy of the JAX package's
`PPOConfig` (`splendax/train/config.py`), with the same fields and defaults."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class PPOConfig:
    # Reference trainer flags
    total_timesteps: int = 1_000_000
    num_envs: int = 16
    num_steps: int = 128
    gamma: float = 0.999
    gae_lambda: float = 0.95
    lr: float = 2.5e-4
    ent_coef: float = 0.03
    vf_coef: float = 0.5
    clip_coef: float = 0.2
    update_epochs: int = 4
    minibatch_size: int = 256
    save_path: str = "runs/ppo_splendor"
    seed: int = 42
    track: bool = False
    log_dir: str = "runs/ppo_splendor"
    eval_every_updates: int = 10
    eval_games: int = 400
    lr_anneal: bool = False
    train_opponent: str = "basic"  # random | greedy_v1 | basic (static-opponent mode)
    self_play: bool = True
    pool_size: int = 12
    snapshot_every_updates: int = 10
    p_current: float = 0.25
    target_kl: float = 0.02
    vclip: float = 0.2
    ent_coef_final: float = 0.01

    # MLP hidden width; 256 is the reference architecture.
    hidden: int = 256
    rng_mode: str = "fast"  # engine token-return RNG: fast | parity
    # True reproduces the reference's entropy penalty sign quirk.
    reference_entropy_quirk: bool = False
    checkpoint_every_updates: int = 1
    resume: bool = False
    profile_updates: int = 0
    # Fresh-game ring: ring size = reset_ring_mult * num_envs; 0 selects the
    # full-batch autoreset.
    reset_ring_mult: int = 2
    # Data / hidden-width parallelism (dp=0: one device).
    dp: int = 0
    tp: int = 1
    opponent_sampling: str = "uniform"  # uniform | pfsp
    # Search-hardened league slot.
    search_opponent: bool = False
    p_search: float = 0.125
    search_m: int = 8
    search_k0: int = 4
    search_horizon: int = 2
    search_static: bool = False
    search_censored: bool = False
    wandb_project: str | None = None
    wandb_entity: str | None = None

    @property
    def n_search_static(self) -> int:
        s = int(round(self.p_search * self.num_envs))
        if s == 0 and self.p_search > 0:
            s = 1
        return min(s, self.num_envs)

    @property
    def search_stride(self) -> int:
        return max(1, self.num_envs // max(1, self.n_search_static))

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps

    @property
    def num_updates(self) -> int:
        return self.total_timesteps // self.batch_size

    @property
    def num_minibatches(self) -> int:
        mb = min(self.minibatch_size, self.batch_size)
        return max(1, self.batch_size // mb)

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)
