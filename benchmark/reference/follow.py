"""The reference follows what the program produced, step by step, and the
numbers that decide `correct`.

A capture (built by the harness while the program ran) holds only plain
tensors on the host: game states as dicts of the GameState fields, the
random generators' states at the points where the program drew, and the
program's outputs.  The reference never reads the program's weights: it
loads the committed nets itself.  It restarts every turn from the
program's state at that turn (the state itself is judged by the turn
before), so an error shows where it is made and does not compound.  Each
turn the reference:

  * replays the turn's random draws from the generator state the program
    drew them from, in the program's order (the port's draw order is part
    of what the benchmark freezes);
  * computes every network output in float64 (`model.forward`) and judges
    the program's choices by their gap below the reference's best score:
    a choice the reference would also make reads 0, a near tie reads the
    rounding, an illegal or wrong move reads far more;
  * replays both plies and the autoreset with the frozen engine and counts
    every row where a state field, the observation, the mask, the reward,
    the done flag or the new opponent slot differs (`engine`, exact);
  * runs the league slot's or the eval bot's Gumbel search itself on the
    same draws and counts the moves where its choice differs (`search_miss`,
    a share).

After the turns: GAE and the normalised advantages from the reference's own
values, and the first three optimizer steps of the epochs, at the learning
rate and entropy coefficient the reference anneals to the update's index,
on the program's minibatch rows (its permutation replayed from the
generator).

An update cell follows two updates.  The warm-up starts from the committed
nets, zero Adam moments and the deal from the seed.  A window update can
only start from the program's own state: the parameters and Adam's moments
and step count that the update before it left at the end of its epochs,
and the game state its rollout ended in.  The reference takes those as the
start, so what happens between two updates is judged too: the CURRENT
slot's and the agent's forwards run the handed-over parameters, the
snapshot pushes since the warm-up (every `snapshot_every_updates`, FIFO
from the pool's count of snapshots) put the handed-over parameters of the
pushing update into their slot, the first turn's state is the one the last
rollout ended in, and Adam continues from the handed-over moments.  A "candidate" is the program, or for the control and
the planted faults the reference itself computed otherwise (`check_update`,
`check_eval`); each is judged against the float64 reference.

Numbers (all lower is better):
  engine       rows that differ anywhere in the engine's outputs (exact: 0)
  agent_gap    the agent's sampled move: max over rows of the gap of its
               Gumbel-perturbed score below the reference's best
  opp_gap      each pool slot's (or the eval opponent's) greedy move: max gap
  search_miss  share of search moves where the candidate's choice is not the
               reference's
  fwd_err      max |value - reference| and |log-prob - reference| of the
               agent's forwards, the bootstrap included; in an eval, max
               |logit - reference| of the search's root prior and the
               opponent's forward at the legal actions
  gae_err      max |normalised advantage - reference| and |return - ref|
  loss_gap     the first step's |loss - ref| over the sum of the reference
               loss's terms' magnitudes (the clipped surrogate, the value term,
               the entropy term: a loss can sum to near 0)
  grad_gap     max over leaves of | |g| - |g_ref| | / max(|g_ref|, median
               leaf's |g_ref|), g the first clipped gradient as Adam got it
  delta_gap    the worst leaf's such gap of the parameters' change after
               three steps; leaves whose reference gradient is under a
               thousandth of the median leaf's are left out (they move by
               round-off alone)

Each number is the worst over the two updates (`engine` and `search_miss`
count over both).  The later steps' losses are not compared: where half of
a critic layer's gradient lies under Adam's eps (1e-5), each step there is
linear in a sum that cancels over the minibatch, so float32 round-off moves
the third step's loss by up to 6e-5 of its scale on some seeds (PERF.md
gives the readings).
"""

from __future__ import annotations

import statistics

import torch

from . import learner, model, search
from .engine import core, encode, ring, rules
from .engine.state import GameState, initial_state

NUMBERS_UPDATE = ("engine", "agent_gap", "opp_gap", "search_miss", "fwd_err", "gae_err",
                  "loss_gap", "grad_gap", "delta_gap")
NUMBERS_EVAL = ("engine", "opp_gap", "search_miss", "fwd_err")
QUIET_LEAF = 1e-3  # a leaf whose reference gradient norm is under this share of the median's
FAULTS = ("unchanged", "half_batch", "altered")


def to_state(d: dict, device) -> GameState:
    return GameState(**{k: v.to(device) for k, v in d.items()})


def state_rows_differ(a: GameState, b: GameState) -> torch.Tensor:
    """bool [B]: rows where any field differs."""
    out = torch.zeros(a.batch_size, dtype=torch.bool, device=a.to_play.device)
    for k, v in a.items():
        w = getattr(b, k)
        out |= (v != w).reshape(v.shape[0], -1).any(1)
    return out


def rows_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a != b).reshape(a.shape[0], -1).any(1)


def generator_at(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def choice_gap(score: torch.Tensor, choice: torch.Tensor, rows: torch.Tensor) -> float:
    """Max over `rows` of the gap of `choice`'s score below the row's best."""
    if not bool(rows.any()):
        return 0.0
    s = score[rows]
    return float((s.max(1).values - s.gather(1, choice[rows][:, None])[:, 0]).max())


def logit_err(t: "Tally", logits, ref, mask, rows) -> None:
    """`fwd_err`: the largest gap of a legal action's logit from the
    reference's, over `rows`."""
    on = mask & rows[:, None]
    if bool(on.any()):
        t.top("fwd_err", float((logits.double() - ref.double()).abs()[on].max()))


class Tally:
    """The running numbers of one candidate."""

    def __init__(self):
        self.max = {}
        self.miss, self.moves, self.engine = 0, 0, 0

    def top(self, name: str, value: float) -> None:
        self.max[name] = max(self.max.get(name, 0.0), float(value))

    def numbers(self, names) -> dict:
        out = {n: self.max.get(n, 0.0) for n in names}
        out["engine"] = self.engine
        if "search_miss" in names:
            out["search_miss"] = self.miss / self.moves if self.moves else 0.0
        return out


def _leaf_gaps(cand, ref, quiet=None) -> list:
    """Each leaf's | |cand| - |ref| | over max(|ref|, the median leaf's |ref|),
    leaving out the leaves `quiet` marks."""
    cn = [float(c.double().norm()) for c in cand]
    rn = [float(r.double().norm()) for r in ref]
    med = statistics.median(rn)
    return [abs(c - r) / max(r, med, 1e-30) for i, (c, r) in enumerate(zip(cn, rn))
            if quiet is None or not quiet[i]] or [0.0]


# ---------------------------------------------------------------- the update

def _learner(cap, device, prec, values, last_value, half: bool = False):
    """GAE, the normalised advantages, and the first three optimizer steps
    in `prec` -> dict(adv, ret, losses, g1, delta)."""
    R = cap["recipe"]
    lr, ent_coef = learner.anneal(R, cap["update_idx"])
    traj = cap["traj"]
    T, N = traj["reward"].shape
    reward, done = traj["reward"].to(device), traj["done"].to(device)
    adv, ret = learner.gae(reward, done, values, last_value, R["gamma"], R["gae_lambda"])
    b_adv = learner.normalise(adv.reshape(-1))
    ret = ret.reshape(-1)
    ep = cap["epochs"]
    B = T * N
    mb = min(R["minibatch_size"], B)
    # The minibatches of the first three steps: each epoch a permutation
    # drawn from the generator, its rows in minibatches in order; the
    # target-KL stop ends an epoch after the step whose approx-KL (the
    # program's, judged by loss_gap beside its loss) passed it.
    gen = generator_at(ep["gen"], device)
    perm = torch.randperm(B, generator=gen, device=device)
    rows, i = [], 0
    for k in range(3):
        rows.append(perm[i * mb:(i + 1) * mb])
        i += 1
        if i == B // mb or (R["target_kl"] > 0 and ep["approx_kl"][k] > R["target_kl"]):
            perm, i = torch.randperm(B, generator=gen, device=device), 0
    agent = [w.to(model.dtype_of(prec)) for w in cap["agent_w"]]
    params = [w.clone().requires_grad_() for w in agent]
    adam0 = cap["adam0"]
    opt = learner.Adam(params, *adam0) if adam0 else learner.Adam(params)
    obs_all, mask_all = traj["obs"].reshape(B, -1), traj["mask"].reshape(B, -1)
    act_all = traj["action"].reshape(B)
    losses, scales, g1 = [], [], None
    for k in range(3):
        idx = rows[k][: mb // 2] if half else rows[k]
        cpu_idx = idx.cpu()
        obs = obs_all[cpu_idx].to(device)
        mask = mask_all[cpu_idx].to(device)
        act = act_all[cpu_idx].to(device)
        logp_old, v_old = ep["logp_ref"][idx], values.reshape(-1)[idx]
        loss, _, scale = learner.ppo_loss(params, R, ent_coef, obs, mask, act, logp_old,
                                   v_old.to(params[0].dtype), b_adv[idx].to(params[0].dtype),
                                   ret[idx].to(params[0].dtype), prec)
        grads = learner.clip_grads(torch.autograd.grad(loss, params))
        if k == 0:
            g1 = [g.detach().clone() for g in grads]
        opt.step(params, grads, lr)
        losses.append(float(loss.detach()))
        scales.append(float(scale))
    delta = [(p.detach() - w) for p, w in zip(params, agent)]
    return dict(adv=b_adv, ret=ret, losses=losses, scales=scales, g1=g1, delta=delta)


def _program_learner(cap):
    """The program's own learner outputs from the capture: the first
    gradient from Adam's first moment before and after the first step, the
    change in the reference's [in, out] layout."""
    ep = cap["epochs"]
    g1 = _ref_layout([(m1.double() - learner.B1 * m0.double()) / (1 - learner.B1)
                      for m1, m0 in zip(ep["mu1"], ep["mu0"])])
    delta = _ref_layout([p3.double() - p0.double()
                         for p3, p0 in zip(ep["params3"], ep["params0"])])
    return dict(adv=ep["adv"], ret=ep["ret"], losses=ep["losses"], g1=g1, delta=delta)


def _judge_learner(t: Tally, cand: dict, ref: dict) -> None:
    dev = ref["adv"].device
    t.top("gae_err", max(float((cand["adv"].to(dev).double() - ref["adv"]).abs().max()),
                         float((cand["ret"].to(dev).double() - ref["ret"]).abs().max())))
    t.top("loss_gap", abs(cand["losses"][0] - ref["losses"][0]) / ref["scales"][0])
    g_ref = [g.double() for g in ref["g1"]]
    rn = [float(g.norm()) for g in g_ref]
    med = statistics.median(rn)
    quiet = [r < QUIET_LEAF * med for r in rn]
    t.top("grad_gap", max(_leaf_gaps([g.to(dev) for g in cand["g1"]], g_ref)))
    t.top("delta_gap", max(_leaf_gaps([d.to(dev) for d in cand["delta"]], ref["delta"], quiet)))


@torch.no_grad()
def _turns(cap, device, precs, tallies, faults):
    """Follow the rollout's turns.  Returns the values [T, N] and the
    bootstrap [N] of each precision in `precs` (the first is "f64")."""
    R = cap["recipe"]
    traj = cap["traj"]
    T, N = traj["reward"].shape
    S, stride = cap["search_rows"], cap["search_stride"]
    srows = torch.arange(0, S * stride, stride, device=device)
    pool_size = len(cap["slots"]) - 1
    ref_t = tallies["f64"]
    values = {p: torch.empty((T, N), dtype=model.dtype_of(p), device=device) for p in precs}
    logp = {p: torch.empty((T, N), dtype=model.dtype_of(p), device=device) for p in precs}

    # The start: in the warm-up the games dealt from the seed and their
    # opponents (drawn once over the empty pool, then over the full one); in
    # a window update the games and opponents the last rollout ended with.
    # Then the ring dealt from the generator as the rollout began.
    first = cap["turns"][0]
    if cap.get("prev_end") is None:
        g = torch.Generator(device=device).manual_seed(cap["seed"])
        bad = state_rows_differ(initial_state(N, g, device), to_state(first["state"], device))
        for _ in range(2):
            torch.rand(N, generator=g, device=device)
        bad |= _new_opponents(cap, g, N, srows, device) != first["opp_idx"].to(device)
    else:
        prev = cap["prev_end"]
        bad = (state_rows_differ(to_state(prev["state"], device), to_state(first["state"], device))
               | rows_differ(prev["obs"].to(device), traj["obs"][0].to(device))
               | rows_differ(prev["mask"].to(device), traj["mask"][0].to(device))
               | (prev["opp_idx"].to(device) != first["opp_idx"].to(device)))
    ref_t.engine += int(bad.sum())
    g = generator_at(cap["gen_rollout"], device)
    fresh = ring.make_ring(R["reset_ring_mult"] * N, g, device, window=N)
    ref_t.engine += int(rows_differ(fresh.packed, cap["ring_packed"].to(device)).sum())
    prog = tallies.get("program")
    for t in range(T):
        turn = cap["turns"][t]
        st = to_state(turn["state"], device)
        obs, mask = traj["obs"][t].to(device), traj["mask"][t].to(device)
        opp_idx = turn["opp_idx"].to(device)
        action = traj["action"][t].to(device)
        bad = rows_differ(obs, encode.encode_observation(st)) | rows_differ(
            mask, rules.legal_mask(st))
        gen = {p: generator_at(turn["gen"], device) for p in precs}
        noise = {p: model.gumbel_noise((N, model.ACT_DIM), gen[p], device) for p in precs}
        out = {}
        for p in precs:
            logits, value = model.forward(cap["agent_w"], obs, mask, p)
            lp = torch.log_softmax(logits, -1)
            values[p][t] = value
            logp[p][t] = lp.gather(1, action[:, None])[:, 0]
            out[p] = torch.argmax(logits + noise[p].to(logits.dtype), -1)
            if p == "f64":
                agent_score = logits + noise[p].double()
        legal = mask.any(1)
        if prog is not None:
            prog.top("agent_gap", choice_gap(agent_score, action, legal))
            prog.top("fwd_err", max(
                float((traj["value"][t].to(device).double() - values["f64"][t]).abs().max()),
                float((traj["logp"][t].to(device).double() - logp["f64"][t]).abs().max())))
        for p in precs[1:]:
            tallies[p].top("agent_gap", choice_gap(agent_score, out[p], legal))
            tallies[p].top("fwd_err", max(float((values[p][t].double() - values["f64"][t])
                                                .abs().max()),
                                          float((logp[p][t].double() - logp["f64"][t])
                                                .abs().max())))
        if "altered" in faults:
            tallies["altered"].top("agent_gap", choice_gap(agent_score, _altered(out["f64"], mask),
                                                           legal))

        # The agent's ply, then the opponents' choices on its result.
        state1, out_a = core.step(st, action)
        obs1, mask1 = out_a.obs, out_a.action_mask
        opp_phase = ~out_a.terminated & (state1.to_play == 1) & mask1.any(1)
        prog_opp = turn["opp_action"].to(device)
        for s in range(pool_size + 1):
            on = opp_idx == s
            if not bool(on.any()):
                continue
            rows = torch.nonzero(on)[:, 0]
            w = cap["slot_w"][s]
            ref_logits, _ = model.forward(w, obs1[rows], mask1[rows], "f64", with_value=False)
            live = opp_phase[rows]
            if prog is not None:
                prog.top("opp_gap", choice_gap(ref_logits, prog_opp[rows], live))
            for p in precs[1:]:
                lg, _ = model.forward(w, obs1[rows], mask1[rows], p, with_value=False)
                tallies[p].top("opp_gap", choice_gap(ref_logits, torch.argmax(lg, -1), live))
            if "altered" in faults:
                tallies["altered"].top("opp_gap", choice_gap(
                    ref_logits, _altered(torch.argmax(ref_logits, -1), mask1[rows]), live))
        if S > 0:
            cur = cap["slot_w"][pool_size]
            live = opp_phase[srows]
            picks = {}
            for p in precs:
                fwd = _fwd(cur, p)
                picks[p] = search.gumbel_search(
                    fwd, obs1[srows], mask1[srows], state1.map(lambda x: x[srows]), gen[p],
                    R["search_m"], R["search_k0"], R["search_horizon"], greedy_final=True)
            n_live = int(live.sum())
            cands = {"program": prog_opp[srows]} if prog is not None else {}
            cands.update({p: picks[p] for p in precs[1:]})
            if "altered" in faults:
                cands["altered"] = _altered(picks["f64"], mask1[srows])
            for name, pick in cands.items():
                tallies[name].miss += int((live & (pick != picks["f64"])).sum())
                tallies[name].moves += n_live
        # The opponent's ply with the program's move, and the autoreset.
        state2, fb = core.step_core(state1, prog_opp)
        two = ~out_a.terminated & (state1.to_play == 1)
        done = out_a.terminated | (two & fb["terminated"])
        nxt = GameState(**{k: torch.where(two.view((-1,) + (1,) * (v.dim() - 1)),
                                          getattr(state2, k), v) for k, v in state1.items()})
        reward = torch.where(two, torch.where(fb["terminated"], fb["final_rewards"][:, 0], 0.0),
                             out_a.reward).to(torch.float32)
        fresh_state, _, fresh = ring.take(fresh, done)
        carry = core.select(done, fresh_state, nxt)
        if t + 1 < T:
            want_state = to_state(cap["turns"][t + 1]["state"], device)
            want_obs, want_mask = traj["obs"][t + 1].to(device), traj["mask"][t + 1].to(device)
            want_opp = cap["turns"][t + 1]["opp_idx"].to(device)
        else:
            want_state = to_state(cap["end"]["state"], device)
            want_obs, want_mask = cap["end"]["obs"].to(device), cap["end"]["mask"].to(device)
            want_opp = cap["end"]["opp_idx"].to(device)
        new_idx = _new_opponents(cap, gen["f64"], N, srows, device)
        bad |=(state_rows_differ(carry, want_state)
                | rows_differ(encode.encode_observation(carry), want_obs)
                | rows_differ(rules.legal_mask(carry), want_mask)
                | (reward != traj["reward"][t].to(device))
                | (done != traj["done"][t].to(device))
                | (torch.where(done, new_idx, opp_idx) != want_opp))
        ref_t.engine += int(bad.sum())
    # The bootstrap.
    end_obs, end_mask = cap["end"]["obs"].to(device), cap["end"]["mask"].to(device)
    last = {}
    for p in precs:
        _, last[p] = model.forward(cap["agent_w"], end_obs, end_mask, p)
    if prog is not None:
        prog.top("fwd_err", float((cap["last_value"].to(device).double() - last["f64"])
                                  .abs().max()))
    for p in precs[1:]:
        tallies[p].top("fwd_err", float((last[p].double() - last["f64"]).abs().max()))
    return values, last, logp


def _new_opponents(cap, gen, N: int, srows, device) -> torch.Tensor:
    """The opponent slot of N new episodes: CURRENT with probability
    p_current, else a uniform frozen slot; the league slot's static rows
    pinned to the sentinel one past CURRENT."""
    pool_size = len(cap["slots"]) - 1
    use_current = torch.rand(N, generator=gen, device=device) < cap["recipe"]["p_current"]
    u = torch.rand(N, generator=gen, device=device)
    filled = max(cap["pool_filled"], 1)
    idx = torch.where(use_current, pool_size, torch.clamp((u * filled).long(), max=filled - 1))
    if srows.numel():
        static = torch.zeros(N, dtype=torch.bool, device=device)
        static[srows] = True
        idx = torch.where(static, pool_size + 1, idx)
    return idx


def _fwd(weights, prec):
    def fwd(obs, mask, with_value):
        return model.forward_rows(weights, obs, mask, prec, with_value)
    return fwd


def _altered(choice: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row's next legal action after `choice` (cyclic): an answer
    altered where it is produced."""
    n = mask.shape[1]
    ar = torch.arange(n, device=mask.device)
    dist = (ar[None] - choice[:, None] - 1) % n
    return torch.argmin(torch.where(mask, dist, n), 1)


def _ref_layout(leaves) -> list:
    """The program's parameters (nn.Linear weights [out, in]) in the
    reference's [in, out] layout, float64."""
    return [x.double().t() if x.dim() == 2 else x.double() for x in leaves]


def _start_of(cap: dict, upd: dict, npz: dict, device) -> dict:
    """The weights an update starts from: the agent's (also the CURRENT
    slot's), every pool slot's, and Adam's state (None: zero moments)."""
    slots = [npz[p] for p in cap["slots"]]
    if upd.get("prev_end") is None:  # the warm-up
        return dict(agent_w=npz[cap["agent"]], slot_w=slots[:-1] + [npz[cap["agent"]]],
                    adam0=None)
    hand = cap["handover"]
    R = cap["recipe"]
    every = max(1, R["snapshot_every_updates"])
    pool_size = len(slots) - 1
    n = cap["n_snapshots0"]
    for u in range(cap["start"], upd["update_idx"]):
        if R["self_play"] and (u + 1) % every == 0:
            slots[n % pool_size] = [w.to(device) for w in _ref_layout(hand[u]["params"])]
            n += 1
    last = hand[upd["update_idx"] - 1]
    agent = [w.to(device) for w in _ref_layout(last["params"])]
    adam0 = ([m.to(device) for m in _ref_layout(last["mu"])],
             [v.to(device) for v in _ref_layout(last["nu"])], last["count"])
    return dict(agent_w=agent, slot_w=slots[:-1] + [agent], adam0=adam0)


def check_update(cap: dict, device, controls=(), faults=()) -> dict:
    """{candidate: numbers} over the followed updates: "program" always;
    each precision of `controls` (the reference put in the program's place)
    and each planted fault of `faults` (FAULTS) when asked."""
    precs = ("f64",) + tuple(controls)
    names = ["program", *controls, *faults]
    tallies = {"f64": Tally(), **{n: Tally() for n in names}}
    npz = {path: model.load_npz(path, device) for path in {cap["agent"], *cap["slots"]}}
    for upd in cap["updates"]:
        u = dict(cap, **upd, **_start_of(cap, upd, npz, device))
        values, last, logp = _turns(u, device, precs, tallies, faults)
        ref = None
        for p in precs:
            u["epochs"]["logp_ref"] = logp[p].reshape(-1)
            lrn = _learner(u, device, p, values[p], last[p])
            if p == "f64":
                ref = lrn
                _judge_learner(tallies["program"], _program_learner(u), ref)
            else:
                _judge_learner(tallies[p], lrn, ref)
        if "half_batch" in faults:
            u["epochs"]["logp_ref"] = logp["f64"].reshape(-1)
            _judge_learner(tallies["half_batch"], _learner(u, device, "f64", values["f64"],
                                                           last["f64"], half=True), ref)
        if "unchanged" in faults:
            _judge_learner(tallies["unchanged"], dict(
                ref, g1=[torch.zeros_like(g) for g in ref["g1"]],
                delta=[torch.zeros_like(d) for d in ref["delta"]]), ref)
    if "altered" in faults:
        tallies["altered"].engine = 1  # an altered reward is one row the engine flags
    out = {}
    for n in names:
        nums = tallies[n].numbers(NUMBERS_UPDATE)
        if n == "program":
            nums["engine"] = tallies["f64"].engine
        if cap["search_rows"] == 0:
            nums.pop("search_miss")
        out[n] = nums
    return out


# ---------------------------------------------------------------- the eval

@torch.no_grad()
def check_eval(cap: dict, device, controls=(), faults=()) -> dict:
    """{candidate: numbers} over the captured evals (`check_update`'s
    candidates; the faults apply to the search's and the opponent's
    answers)."""
    bot = cap["bot"]
    if bot["algo"] != "gumbel":
        raise ValueError(f"the reference searches with Gumbel only, not {bot['algo']!r}")
    net = model.load_npz(cap["agent"], device)
    precs = ("f64",) + tuple(controls)
    names = ["program", *controls, *[f for f in faults if f == "altered"]]
    tallies = {n: Tally() for n in names}
    t = tallies["program"]
    if "altered" in tallies:
        tallies["altered"].engine = 1
    for ev in cap["evals"]:
        n = ev["games"]
        gen = torch.Generator(device=device).manual_seed(ev["seed"])
        st = initial_state(n, gen, device)
        active = torch.ones(n, dtype=torch.bool, device=device)
        final_r = torch.zeros(n, dtype=torch.float32, device=device)
        checks = torch.zeros(n, dtype=torch.int64, device=device)
        t.engine += int(state_rows_differ(st, to_state(ev["turns"][0]["state"], device)).sum())
        for i, turn in enumerate(ev["turns"]):
            st = to_state(turn["state"], device)
            obs, mask = turn["obs"].to(device), turn["mask"].to(device)
            t.engine += int((active & (rows_differ(obs, encode.encode_observation(st))
                                     | rows_differ(mask, rules.legal_mask(st)))).sum())
            picks = {p: search.gumbel_search(_fwd(net, p), obs, mask, st,
                                             generator_at(turn["gen"], device), bot["m"],
                                             bot["k0"], bot["horizon"], bot["c_scale"],
                                             bot["greedy_final"]) for p in precs}
            action = turn["action"].to(device)
            live = active & mask.any(1)
            root = {p: model.forward(net, obs, mask, p, False)[0] for p in precs}
            logit_err(tallies["program"], turn["logits"].to(device), root["f64"], mask, live)
            for p in precs[1:]:
                logit_err(tallies[p], root[p], root["f64"], mask, live)
            cands = {"program": action, **{p: picks[p] for p in precs[1:]}}
            if "altered" in names:
                cands["altered"] = _altered(picks["f64"], mask)
            for name, pick in cands.items():
                tallies[name].miss += int((live & (pick != picks["f64"])).sum())
                tallies[name].moves += int(live.sum())
            state1, out_a = core.step(st, action)
            t.engine += int(rows_differ(turn["opp_obs"].to(device), out_a.obs).sum()
                          + rows_differ(turn["opp_mask"].to(device), out_a.action_mask).sum()
                          + state_rows_differ(state1, to_state(turn["opp_state"], device)).sum())
            two = ~out_a.terminated & (state1.to_play == 1)
            ref_logits, _ = model.forward(net, out_a.obs, out_a.action_mask, "f64", False)
            opp_rows = active & two & out_a.action_mask.any(1)
            opp = turn["opp_action"].to(device)
            tallies["program"].top("opp_gap", choice_gap(ref_logits, opp, opp_rows))
            logit_err(tallies["program"], turn["opp_logits"].to(device), ref_logits,
                      out_a.action_mask, opp_rows)
            for p in precs[1:]:
                lg, _ = model.forward(net, out_a.obs, out_a.action_mask, p, False)
                tallies[p].top("opp_gap", choice_gap(ref_logits, torch.argmax(lg, -1), opp_rows))
                logit_err(tallies[p], lg, ref_logits, out_a.action_mask, opp_rows)
            if "altered" in names:
                tallies["altered"].top("opp_gap", choice_gap(
                    ref_logits, _altered(torch.argmax(ref_logits, -1), out_a.action_mask),
                    opp_rows))
            state2, fb = core.step_core(state1, opp)
            done = out_a.terminated | (two & fb["terminated"])
            nxt = GameState(**{k: torch.where(two.view((-1,) + (1,) * (v.dim() - 1)),
                                              getattr(state2, k), v) for k, v in state1.items()})
            reward = torch.where(two, torch.where(fb["terminated"], fb["final_rewards"][:, 0],
                                                  0.0), out_a.reward).to(torch.float32)
            checks += active
            final_r = torch.where(active & done, reward, final_r)
            kept = GameState(**{k: torch.where(active.view((-1,) + (1,) * (v.dim() - 1)),
                                               getattr(nxt, k), v) for k, v in st.items()})
            if i + 1 < len(ev["turns"]):
                t.engine += int(state_rows_differ(kept, to_state(ev["turns"][i + 1]["state"],
                                                               device)).sum())
            st = kept
            active = active & ~done
        final_p, turns_p, _, _, checks_p = (torch.as_tensor(x).to(device) for x in ev["match"])
        t.engine += int(bool(active.any())) * n
        t.engine += int(((final_r != final_p) | (st.turn_count != turns_p)
                       | (checks != checks_p)).sum())
    return {name: tallies[name].numbers(NUMBERS_EVAL) for name in names}

