"""The yardstick: the operations and bytes the algorithm needs, from its
shapes alone, and the card's peaks.

Work is counted from the recipe's shapes and never from the program's launch
counts, so it reads the same whatever implements it.  One forward of one row
costs 2 * sum(in * out) over the layers it needs (the bias adds and the
tanh are left out); a training sample costs three forwards of both heads
(the forward and the two products of the backward).  Bytes: each input read
once and each output written once, float32 weights and values, int32
observations, one byte a mask entry.

Peaks (NVIDIA's H100 SXM data sheet, dense, at its 700 W limit): float32
inputs are multiplied at most at the TF32 tensor-core rate, so no
implementation exact to float32 reads above 100% of it; the float32 CUDA
cores' 67 TFLOP/s can be beaten (kernel A computes on the tensor cores).
"""

from __future__ import annotations

OBS, ACT = 297, 45
PEAK_FLOPS = 494.7e12  # TF32 tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3


def head_flops(H: int, out: int) -> int:
    """One row through 297 -> H -> H -> out."""
    return 2 * (OBS * H + H * H + H * out)


def head_params(H: int, out: int) -> int:
    return OBS * H + H + H * H + H + H * out + out


def forward_flops(H: int, actor: bool = True, critic: bool = True) -> int:
    return (head_flops(H, ACT) if actor else 0) + (head_flops(H, 1) if critic else 0)


def forward_bytes(B: int, H: int, actor: bool = True, critic: bool = True,
                  weight_sets: int = 1) -> int:
    """A forward of B rows: the weights of `weight_sets` nets, the
    observations and the mask read once, the logits and values written once."""
    w = (head_params(H, ACT) if actor else 0) + (head_params(H, 1) if critic else 0)
    return 4 * w * weight_sets + B * (4 * OBS + ACT) + B * 4 * (ACT * actor + critic)


class Work:
    """A list of forwards without gradient (kernel A's work) and the
    learner's operations, for one operation of a cell."""

    def __init__(self, H: int):
        self.H = H
        self.calls = []  # (rows, actor, critic, weight sets, repeats)
        self.learner_flops = 0

    def forward(self, rows: int, actor=True, critic=True, weight_sets=1, repeats=1) -> "Work":
        if rows > 0 and repeats > 0:
            self.calls.append((rows, actor, critic, weight_sets, repeats))
        return self

    @property
    def forward_flops(self) -> int:
        return sum(n * r * forward_flops(self.H, a, c) for n, a, c, _, r in self.calls)

    @property
    def flops(self) -> int:
        return self.forward_flops + self.learner_flops

    def least_seconds(self) -> float:
        """The sum over the forwards of the larger of their operations over
        the peak rate and their bytes over the peak bandwidth."""
        return sum(r * max(n * forward_flops(self.H, a, c) / PEAK_FLOPS,
                           forward_bytes(n, self.H, a, c, w) / PEAK_BYTES)
                   for n, a, c, w, r in self.calls)


def search_forwards(work: Work, games: int, m: int, k0: int, horizon: int,
                    repeats: int = 1) -> Work:
    """A Gumbel search over `games` games: the root prior, then for each of
    log2(m) rounds `horizon` actor plies and the critic's leaves on its
    games * m * k0 lanes."""
    lanes = games * m * k0
    rounds = int(m).bit_length() - 1
    work.forward(games, critic=False, repeats=repeats)
    work.forward(lanes, critic=False, repeats=repeats * rounds * horizon)
    work.forward(lanes, actor=False, repeats=repeats * rounds)
    return work


def update_work(recipe: dict, search_rows: int, optimizer_steps: int) -> Work:
    """One PPO update of `recipe`: the agent with its value every turn, the
    bootstrap, the pool slots' actors on the other rows, the league slot's
    search on its `search_rows` games, and `optimizer_steps` minibatch
    steps of the learner."""
    H, N, T = recipe["hidden"], recipe["num_envs"], recipe["num_steps"]
    work = Work(H)
    work.forward(N, repeats=T)
    work.forward(N)
    work.forward(N - search_rows, critic=False, weight_sets=recipe["pool_size"] + 1, repeats=T)
    if search_rows:
        search_forwards(work, search_rows, recipe["search_m"], recipe["search_k0"],
                        recipe["search_horizon"], repeats=T)
    mb = min(recipe["minibatch_size"], N * T)
    work.learner_flops = optimizer_steps * mb * 3 * forward_flops(H)
    return work


def eval_work(H: int, bot: dict, games: int, turns: int) -> Work:
    """One eval: every turn the bot's search and the opponent's greedy
    forward on all `games` rows (the lockstep loop computes every row)."""
    work = Work(H)
    search_forwards(work, games, bot["m"], bot["k0"], bot["horizon"], repeats=turns)
    work.forward(games, critic=False, repeats=turns)
    return work
