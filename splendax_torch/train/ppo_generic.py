"""Vanilla CleanRL-style PPO for generic Gymnasium envs (PyTorch).

Counterpart of `splendax/train/ppo_generic.py`: the same algorithm,
hyperparameters and diagnostics as the reference `ppo_cleanRL.py`:
orthogonal-init actor and critic MLPs, vectorized rollout storage, GAE,
clipped PPO with value clip, entropy bonus, grad clip, approx-KL, clipfrac
and explained-variance diagnostics, the optional target-KL early stop and
the SPS print.  The MLPs are plain `nn.Linear` layers on `device` (the card
unless the caller names another); the host loops the (generic, Python) envs.

Works on any Discrete-action Box-observation env: CartPole-v1 by default,
and on "SplendaxTorch-v0" (though the masked trainer `train.train` is the
right tool for Splendor).  Without gymnasium it runs on the stand-ins of
`env._gym`, which know the port's own env.

Test hooks of `main`: `init_params` (numpy, the JAX package's `init_agent`
layout) replaces the initial weights, and `noise[t]` (f32 [num_envs,
act_dim]) replaces the Gumbel noise of env step t's action sample, the
argmax of logits + noise, as `jax.random.categorical` samples.

Run: python -m splendax_torch.train.ppo_generic --env-id CartPole-v1
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.actor_critic import gumbel_noise
from . import optim


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CleanRL-style PPO (PyTorch)")
    # Reference Args dataclass defaults (ppo_cleanRL.py:17-78).
    p.add_argument("--env-id", type=str, default="CartPole-v1")
    p.add_argument("--total-timesteps", type=int, default=500_000)
    p.add_argument("--learning-rate", type=float, default=2.5e-4)
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--anneal-lr", action="store_true", default=True)
    p.add_argument("--no-anneal-lr", dest="anneal_lr", action="store_false")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--clip-coef", type=float, default=0.2)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--vf-coef", type=float, default=0.5)
    p.add_argument("--max-grad-norm", type=float, default=0.5)
    p.add_argument("--target-kl", type=float, default=None)
    p.add_argument("--norm-adv", action="store_true", default=True)
    p.add_argument("--clip-vloss", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--hidden", type=int, default=64)
    return p.parse_args(argv)


class Agent(nn.Module):
    """Critic obs -> H -> H -> 1 and actor obs -> H -> H -> act_dim, tanh on
    the hidden layers."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int, device="cuda"):
        super().__init__()

        def mlp(out):
            return nn.Sequential(nn.Linear(obs_dim, hidden), nn.Tanh(), nn.Linear(hidden, hidden),
                                 nn.Tanh(), nn.Linear(hidden, out))

        self.critic, self.actor = mlp(1).to(device), mlp(act_dim).to(device)

    def linears(self):
        """The six Linear layers: critic 0..2, then actor 0..2."""
        return [m for head in (self.critic, self.actor) for m in head if isinstance(m, nn.Linear)]

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.critic(obs)[:, 0]


def init_agent(generator: torch.Generator, obs_dim: int, act_dim: int, hidden: int,
               device="cuda") -> Agent:
    """Orthogonal init, sqrt(2) hidden gain, 0.01 policy head, 1.0 value
    head, zero biases (reference layer_init, ppo_cleanRL.py:94-97)."""
    agent = Agent(obs_dim, act_dim, hidden, device)
    gains = (np.sqrt(2), np.sqrt(2), 1.0, np.sqrt(2), np.sqrt(2), 0.01)
    with torch.no_grad():
        for layer, gain in zip(agent.linears(), gains):
            w = torch.empty(layer.weight.shape)
            nn.init.orthogonal_(w, gain, generator=generator)
            layer.weight.copy_(w)
            layer.bias.zero_()
    return agent


def load_params(agent: Agent, params: dict) -> None:
    """Copy the JAX package's `init_agent` layout (`{"critic": [{"w": [in,
    out], "b"}, ...], "actor": [...]}`, numpy) into `agent`."""
    layers = [lyr for head in ("critic", "actor") for lyr in params[head]]
    with torch.no_grad():
        for layer, lyr in zip(agent.linears(), layers):
            layer.weight.copy_(torch.as_tensor(np.asarray(lyr["w"], np.float32).T.copy()))
            layer.bias.copy_(torch.as_tensor(np.array(lyr["b"], np.float32)))


def gae(rewards, values, dones, last_value, last_done, gamma: float, lam: float):
    """Generalized advantage estimation over [T, N], backwards in time ->
    (advantages, returns)."""
    adv = torch.zeros_like(values)
    lastgaelam = torch.zeros_like(last_value)
    next_value, next_nonterminal = last_value, 1.0 - last_done
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * next_value * next_nonterminal - values[t]
        lastgaelam = delta + gamma * lam * next_nonterminal * lastgaelam
        adv[t] = lastgaelam
        next_value, next_nonterminal = values[t], 1.0 - dones[t]
    return adv, adv + values


def ppo_loss(args, agent: Agent, mb_obs, mb_act, mb_logp, mb_adv, mb_ret, mb_val):
    """The clipped PPO loss -> (loss, (pg_loss, v_loss, entropy, approx_kl,
    clipfrac))."""
    logp = torch.log_softmax(agent.actor(mb_obs), dim=-1)
    new_logp = logp.gather(1, mb_act[:, None])[:, 0]
    entropy = -(torch.exp(logp) * logp).sum(1)
    logratio = new_logp - mb_logp
    ratio = torch.exp(logratio)
    if args.norm_adv:
        mb_adv = (mb_adv - mb_adv.mean()) / (mb_adv.std(correction=0) + 1e-8)
    pg1 = -mb_adv * ratio
    pg2 = -mb_adv * torch.clamp(ratio, 1 - args.clip_coef, 1 + args.clip_coef)
    pg_loss = torch.maximum(pg1, pg2).mean()
    value = agent.value(mb_obs)
    if args.clip_vloss:
        v_clip = mb_val + torch.clamp(value - mb_val, -args.clip_coef, args.clip_coef)
        v_loss = 0.5 * torch.maximum((value - mb_ret) ** 2, (v_clip - mb_ret) ** 2).mean()
    else:
        v_loss = 0.5 * ((value - mb_ret) ** 2).mean()
    ent = entropy.mean()
    loss = pg_loss - args.ent_coef * ent + args.vf_coef * v_loss
    with torch.no_grad():
        approx_kl = ((ratio - 1) - logratio).mean()
        clipfrac = ((ratio - 1.0).abs() > args.clip_coef).float().mean()
    return loss, (pg_loss.detach(), v_loss.detach(), ent.detach(), approx_kl, clipfrac)


def main(argv=None, device="cuda", init_params=None, noise=None):
    args = parse_args(argv)
    device = resolve_device(device)

    from ..env import gym_compat  # noqa: F401  registers SplendaxTorch-v0
    from ..env._gym import gym

    def thunk():
        env = gym.make(args.env_id)
        env = gym.wrappers.RecordEpisodeStatistics(env)
        return env

    envs = gym.vector.SyncVectorEnv([thunk for _ in range(args.num_envs)])
    obs_dim = int(np.prod(envs.single_observation_space.shape))
    act_dim = int(envs.single_action_space.n)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    agent = init_agent(torch.Generator().manual_seed(args.seed), obs_dim, act_dim, args.hidden,
                       device)
    if init_params is not None:
        load_params(agent, init_params)
    params = list(agent.parameters())
    opt_state = optim.init(params)

    batch_size = args.num_envs * args.num_steps
    mb_size = batch_size // args.num_minibatches
    num_updates = args.total_timesteps // batch_size
    obs, _ = envs.reset(seed=args.seed)
    done = np.zeros(args.num_envs, np.float32)
    global_step, t0 = 0, time.time()
    returns_window = []

    def on_device(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    for update in range(1, num_updates + 1):
        lr = (args.learning_rate * (1.0 - (update - 1.0) / num_updates)
              if args.anneal_lr else args.learning_rate)
        b_obs = torch.zeros((args.num_steps, args.num_envs, obs_dim), device=device)
        b_act = torch.zeros((args.num_steps, args.num_envs), dtype=torch.int64, device=device)
        b_logp, b_rew, b_done, b_val = (torch.zeros((args.num_steps, args.num_envs), device=device)
                                        for _ in range(4))

        for step in range(args.num_steps):
            x = on_device(obs).reshape(args.num_envs, obs_dim)
            with torch.no_grad():
                logits = agent.actor(x)
                g = (gumbel_noise(logits.shape, generator, device) if noise is None else
                     torch.as_tensor(np.asarray(noise[global_step // args.num_envs]),
                                     device=device))
                a = torch.argmax(logits + g, dim=-1)
                b_logp[step] = torch.log_softmax(logits, dim=-1).gather(1, a[:, None])[:, 0]
                b_val[step] = agent.value(x)
            global_step += args.num_envs
            b_obs[step], b_act[step], b_done[step] = x, a, on_device(done)
            obs, r, term, trunc, infos = envs.step(a.cpu().numpy())
            done = np.logical_or(term, trunc).astype(np.float32)
            b_rew[step] = on_device(r)
            if "episode" in infos:
                fin = infos.get("_episode", infos["episode"].get("_r"))
                for i in np.flatnonzero(fin):
                    returns_window.append(float(infos["episode"]["r"][i]))

        with torch.no_grad():
            last_value = agent.value(on_device(obs).reshape(args.num_envs, obs_dim))
            adv, ret = gae(b_rew, b_val, b_done, last_value, on_device(done), args.gamma,
                           args.gae_lambda)
        flat = [x.reshape((batch_size,) + tuple(x.shape[2:]))
                for x in (b_obs, b_act, b_logp, adv, ret, b_val)]

        rng = np.random.RandomState(args.seed + update)
        stop = False
        for _ in range(args.update_epochs):
            perm = rng.permutation(batch_size)
            for start in range(0, batch_size, mb_size):
                idx = torch.as_tensor(perm[start:start + mb_size], device=device)
                loss, aux = ppo_loss(args, agent, *(x[idx] for x in flat))
                grads = torch.autograd.grad(loss, params)
                optim.step(params, grads, opt_state, lr, max_norm=args.max_grad_norm)
                if args.target_kl is not None and float(aux[3]) > args.target_kl:
                    stop = True
                    break
            if stop:
                break

        pg_loss, v_loss, ent, approx_kl, clipfrac = (float(x) for x in aux)
        y_pred, y_true = flat[5].cpu().numpy(), ret.cpu().numpy().reshape(-1)
        var_y = np.var(y_true)
        explained_var = np.nan if var_y == 0 else 1 - np.var(y_true - y_pred) / var_y
        sps = int(global_step / (time.time() - t0))
        avg_ret = np.mean(returns_window[-20:]) if returns_window else float("nan")
        print(f"update={update}/{num_updates} SPS={sps} return~{avg_ret:.1f} "
              f"pg={pg_loss:.4f} v={v_loss:.4f} ent={ent:.3f} kl={approx_kl:.4f} "
              f"clipfrac={clipfrac:.3f} ev={explained_var:.3f}")

    envs.close()
    return agent, returns_window


if __name__ == "__main__":
    main()
