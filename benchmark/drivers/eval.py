"""Cells of kind "eval": `eval/suite.eval_vs_opponent` back to back, a
search bot over the configuration's agent net against that net's greedy
policy, the bot in the first seat, each eval on new deals from `--seed`.

The bot and the opponent are built as `splendax_torch/bench.py`'s
`search_bots` builds them (a frozen copy): one `PreparedWeights` handle of
the net, shared, so it is prepared once.  Set-up loads the net and plays
one eval (the warm-up: every kernel built and loaded, the handle prepared,
every shape used).  The window plays evals until the first one that ends at
or after `--seconds`; an operation is one eval, its units the moves the bot
chose for games still in play.  The benchmark's wrappers around the two
policies and their forwards keep, for the evals that the seed picks for the
check, each turn's game states, the generator's state as the bot drew, the
logits of the search's root prior and of the opponent, and both moves
(references only, no copy in the window); the reference follows them after
the window (`reference/follow.check_eval`).
"""

from __future__ import annotations

import contextlib
import json
import os
import random

import torch

from splendax_torch.eval import suite
from splendax_torch.models import actor_critic as ac
from splendax_torch.ops import fused_actor_critic as fac
from splendax_torch.search import gumbel

from .. import harness, yardstick
from ..harness import ROOT, log, patched, to_host
from ..reference import follow
from . import launches


def bots(params, bot: dict) -> tuple:
    """(the bot, the greedy opponent) over `params`, as `search_bots`
    builds them: PolicySpecs on one PreparedWeights handle."""
    net = fac.PreparedWeights(ac.kernel_weights(params))
    spec = gumbel.gumbel_search_policy(m=bot["m"], k0=bot["k0"], horizon=bot["horizon"],
                                       params=net, c_scale=bot["c_scale"],
                                       greedy_final=bot["greedy_final"])
    return spec, (suite._greedy_model_fn, net)


class Run:
    kind = "eval"

    def __init__(self, cell: dict, seed: int, device, small: dict | None = None):
        self.cell, self.device = cell, torch.device(device)
        traffic = {**cell["traffic"], **(small or {})}
        self.bot, self.games = traffic["bot"], traffic["games"]
        # This driver and the reference's search know one bot and one
        # opponent; another needs a driver and a reference of its own.
        if self.bot["algo"] != "gumbel" or traffic["opponent"] != "greedy":
            raise ValueError(f"the eval driver runs the Gumbel bot against the greedy net, not "
                             f"{self.bot['algo']!r} against {traffic['opponent']!r}")
        rng = random.Random(seed)
        self.warm_seed = rng.getrandbits(62)
        self.seeds = rng
        # The evals of the window that the check follows: four of the first
        # five, drawn from the seed (some 12,000 of the bot's moves).
        self.checked = set(rng.sample(range(5), 4))
        if "checked" in traffic:  # a CPU test's one-eval window
            self.checked = set(traffic["checked"])
        self.capture_s = 0.0
        self.evals, self.captured = [], []
        self.hidden = None

    def build_kernels(self) -> float:
        return harness.build_kernels(self.device)

    def sync(self) -> None:
        harness.synchronize(self.device)

    def warm(self) -> None:
        path = os.path.join(ROOT, self.cell["config"]["agent"])
        params = ac.import_params_npz(path, device=self.device)
        self.hidden = params.hidden
        spec, opp = bots(params, self.bot)
        self.current = None
        self.spec = (self._agent(spec[0]), spec[1])
        self.opp = (self._opponent(opp[0]), opp[1])
        self._pending = {}
        self._patches = contextlib.ExitStack()
        self._patches.enter_context(patched(suite, "_match", self._on_match))
        # The root prior of the bot's search and the opponent's forward:
        # kernel A's outputs that the check holds against the reference.
        self._patches.enter_context(patched(gumbel, "fused_masked_forward",
                                            lambda f: self._spy(f, "logits")))
        self._patches.enter_context(patched(suite, "fused_masked_forward",
                                            lambda f: self._spy(f, "opp_logits")))
        derived, before = {}, launches.counters()
        with launches.derived_modes(derived):
            self._eval(self.warm_seed)
        self.sync()
        n = {k: v - before[k] for k, v in launches.counters().items()}
        if self.device.type == "cuda":
            for problem in launches.route_problems(n, derived, self.hidden):
                log("bench: launch check:", problem)
            log("bench: warm-up eval launches", json.dumps(n))
        self.evals = []

    def finish(self) -> None:
        """Play, after a window too short to hold them, the evals the check
        follows (a short trial's window; a cell's window of run_seconds
        holds them)."""
        while len(self.evals) <= max(self.checked):
            log("bench: the window ended before the followed evals; playing them after")
            self.op()

    def _on_match(self, orig):
        def match(*args, **kw):
            out = orig(*args, **kw)
            self.evals[-1]["match"] = out
            return out
        return match

    def _spy(self, fn, key: str):
        def forward(weights, obs, mask, with_value=True):
            out = fn(weights, obs, mask, with_value)
            if self.current is not None:
                self._pending[key] = out[0]
            return out
        return forward

    def _agent(self, fn):
        def agent(ctx, obs, mask, state, generator):
            gen = generator.get_state() if self.current is not None else None
            action = fn(ctx, obs, mask, state, generator)
            if self.current is not None:
                self.current["turns"].append({"gen": gen, "state": dict(state.items()),
                                              "obs": obs, "mask": mask, "action": action,
                                              "logits": self._pending.pop("logits")})
            return action
        agent.privileged = getattr(fn, "privileged", False)
        return agent

    def _opponent(self, fn):
        def opponent(ctx, obs, mask, state, generator):
            action = fn(ctx, obs, mask, state, generator)
            if self.current is not None:
                self.current["turns"][-1].update(opp_obs=obs, opp_mask=mask,
                                                 opp_state=dict(state.items()),
                                                 opp_action=action,
                                                 opp_logits=self._pending.pop("opp_logits"))
            return action
        return opponent

    def _eval(self, seed: int) -> dict:
        self.evals.append({"seed": seed})
        res = suite.eval_vs_opponent(self.spec, self.opp, self.games, seed=seed,
                                     device=self.device)
        self.evals[-1]["result"] = res
        return self.evals[-1]

    def op(self) -> int:
        """One eval; returns the moves the bot chose for games in play."""
        i = len(self.evals)
        seed = self.seeds.getrandbits(62)
        self.current = {"seed": seed, "games": self.games, "turns": []} \
            if i in self.checked else None
        ev = self._eval(seed)
        if self.current is not None:
            self.current["match"] = ev["match"]
            self.captured.append(self.current)
            self.current = None
        self.sync()
        return int(ev["match"][4].sum())

    @contextlib.contextmanager
    def spans(self, spans):
        """The bot's search and the opponent's forward, each a span."""
        agent, opp = self.spec[0], self.opp[0]
        self.spec = (spans.wrap(agent, "search"), self.spec[1])
        self.opp = (spans.wrap(opp, "opponent"), self.opp[1])
        try:
            yield
        finally:
            self.spec, self.opp = (agent, self.spec[1]), (opp, self.opp[1])

    def turns(self, op_index: int) -> int:
        return int(self.evals[op_index]["match"][4].max())

    def work(self, op_index: int) -> yardstick.Work:
        return yardstick.eval_work(self.hidden, self.bot, self.games, self.turns(op_index))

    def failed_ops(self) -> int:
        """Evals that played an illegal move."""
        return sum(ev["result"]["illegal_action_rate"] > 0 for ev in self.evals)

    def info(self) -> dict:
        return {"evals": [{k: ev["result"][k] for k in ("win_rate", "avg_turns")}
                          for ev in self.evals], "checked": sorted(self.checked)}

    def release(self) -> None:
        self._patches.close()
        self.spec = self.opp = None

    def check(self, controls=(), faults=()) -> dict:
        cap = {"bot": self.bot, "agent": os.path.join(ROOT, self.cell["config"]["agent"]),
               "evals": [to_host(ev) for ev in self.captured]}
        return follow.check_eval(cap, self.device, controls, faults)
