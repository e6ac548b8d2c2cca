"""Hybrid DQN controller — the reference's actual agent, kept as baseline.

Rebuilds HybridRLAnnealer (rl_integration/hybrid_agent.py:131-522): a DQN
(MLP, target network with soft updates tau=0.005, epsilon-greedy) plus a
*hybrid decision* rule — with probability ``annealing_weight`` a cooling
heuristic overrides the Q-net (hybrid_agent.py:226-271), and that weight
adapts from relative episode performance (:381-406). Differences:
the replay buffer is a fixed-size ring of device tensors, and act/learn steps
are jitted over the batched env."""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from spinglass_tpu.core import pytree
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.rl import env as env_mod
from spinglass_tpu.rl.env import EnvConfig
from spinglass_tpu.rl.mlp import MLP


@dataclass(frozen=True)
class DQNConfig:
    """Reference HybridAgentConfig (hybrid_agent.py:19-51)."""

    hidden_sizes: Tuple[int, ...] = (128, 128)
    lr: float = 1e-3
    gamma: float = 0.99
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 2000
    tau: float = 0.005                  # soft target update
    buffer_size: int = 4096
    batch_size: int = 128
    annealing_weight: float = 0.3       # prob of using the cooling heuristic
    weight_adapt_rate: float = 0.05
    prioritized_replay: bool = False    # proportional PER (training_pipeline.py:82-133)
    per_alpha: float = 0.6              # prioritization exponent
    per_beta: float = 0.4               # importance-sampling exponent
    per_eps: float = 1e-3               # priority floor
    steps_per_dispatch: int = 1         # act+learn steps scanned per device
    # dispatch (amortizes the fixed cost of each dispatch)
    seed: int = 0


class QNetwork(MLP):
    """MLP + LayerNorm Q-net (reference DQNNetwork, hybrid_agent.py:54-99)."""

    def __init__(self, n_actions: int,
                 hidden_sizes: Tuple[int, ...] = (128, 128)):
        super().__init__(hidden_sizes, n_actions, activation=jax.nn.relu,
                         layer_norm=True)
        self.n_actions = n_actions


@pytree.dataclass
class ReplayBuffer:
    """Fixed-size ring buffer of device tensors (reference's Python deque,
    hybrid_agent.py:102-128, made jit-compatible)."""

    obs: jax.Array       # [S, obs_dim]
    action: jax.Array    # [S]
    reward: jax.Array    # [S]
    next_obs: jax.Array  # [S, obs_dim]
    done: jax.Array      # [S]
    ptr: jax.Array       # i32
    size: jax.Array      # i32

    @staticmethod
    def create(capacity: int, obs_dim: int) -> "ReplayBuffer":
        return ReplayBuffer(
            obs=jnp.zeros((capacity, obs_dim), jnp.float32),
            action=jnp.zeros((capacity,), jnp.int32),
            reward=jnp.zeros((capacity,), jnp.float32),
            next_obs=jnp.zeros((capacity, obs_dim), jnp.float32),
            done=jnp.zeros((capacity,), bool),
            ptr=jnp.asarray(0, jnp.int32),
            size=jnp.asarray(0, jnp.int32),
        )

    def push_batch(self, obs, action, reward, next_obs, done) -> "ReplayBuffer":
        b = obs.shape[0]
        cap = self.obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % cap
        return self.replace(
            obs=self.obs.at[idx].set(obs),
            action=self.action.at[idx].set(action),
            reward=self.reward.at[idx].set(reward),
            next_obs=self.next_obs.at[idx].set(next_obs),
            done=self.done.at[idx].set(done),
            ptr=(self.ptr + b) % cap,
            size=jnp.minimum(self.size + b, cap),
        )

    def sample(self, key, batch_size: int):
        idx = jax.random.randint(key, (batch_size,), 0,
                                 jnp.maximum(self.size, 1))
        return {k: getattr(self, k)[idx]
                for k in ("obs", "action", "reward", "next_obs", "done")}


@pytree.dataclass
class PrioritizedReplayBuffer:
    """Proportional prioritized experience replay, fully on-device.

    Rebuilds the reference's PrioritizedReplayBuffer (rl_integration/
    training_pipeline.py:82-133: priority ∝ |TD error|^alpha, importance
    weights (N p_i)^-beta normalized by the max) with fixed shapes: sampling
    is one ``jax.random.categorical`` over masked log-priorities instead of
    the reference's O(S) numpy cumulative-sum walk, so it jits and stays on
    the device with the learner.
    """

    obs: jax.Array        # [S, obs_dim]
    action: jax.Array     # [S]
    reward: jax.Array     # [S]
    next_obs: jax.Array   # [S, obs_dim]
    done: jax.Array       # [S]
    priority: jax.Array   # [S] f32, 0 on never-written slots
    ptr: jax.Array        # i32
    size: jax.Array       # i32

    @staticmethod
    def create(capacity: int, obs_dim: int) -> "PrioritizedReplayBuffer":
        return PrioritizedReplayBuffer(
            obs=jnp.zeros((capacity, obs_dim), jnp.float32),
            action=jnp.zeros((capacity,), jnp.int32),
            reward=jnp.zeros((capacity,), jnp.float32),
            next_obs=jnp.zeros((capacity, obs_dim), jnp.float32),
            done=jnp.zeros((capacity,), bool),
            priority=jnp.zeros((capacity,), jnp.float32),
            ptr=jnp.asarray(0, jnp.int32),
            size=jnp.asarray(0, jnp.int32),
        )

    def push_batch(self, obs, action, reward, next_obs,
                   done) -> "PrioritizedReplayBuffer":
        b = obs.shape[0]
        cap = self.obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % cap
        # new transitions enter at the current max priority so they are
        # sampled at least once (standard PER; matches the reference's
        # max-priority insertion)
        p_new = jnp.maximum(jnp.max(self.priority), 1.0)
        return self.replace(
            obs=self.obs.at[idx].set(obs),
            action=self.action.at[idx].set(action),
            reward=self.reward.at[idx].set(reward),
            next_obs=self.next_obs.at[idx].set(next_obs),
            done=self.done.at[idx].set(done),
            priority=self.priority.at[idx].set(p_new),
            ptr=(self.ptr + b) % cap,
            size=jnp.minimum(self.size + b, cap),
        )

    def sample(self, key, batch_size: int, alpha: float, beta: float):
        """Returns (batch dict, indices, importance weights)."""
        cap = self.obs.shape[0]
        valid = jnp.arange(cap) < self.size
        logits = jnp.where(
            valid, alpha * jnp.log(jnp.maximum(self.priority, 1e-12)),
            -jnp.inf)
        idx = jax.random.categorical(key, logits, shape=(batch_size,))
        probs = jax.nn.softmax(logits)
        n = jnp.maximum(self.size, 1).astype(jnp.float32)
        w = (n * jnp.maximum(probs[idx], 1e-12)) ** (-beta)
        w = w / jnp.maximum(jnp.max(w), 1e-12)
        batch = {k: getattr(self, k)[idx]
                 for k in ("obs", "action", "reward", "next_obs", "done")}
        return batch, idx, w

    def update_priorities(self, idx, td_abs,
                          eps: float) -> "PrioritizedReplayBuffer":
        return self.replace(priority=self.priority.at[idx].set(td_abs + eps))


@pytree.dataclass
class DQNState:
    params: dict
    target_params: dict
    opt_state: optax.OptState
    buffer: ReplayBuffer
    env_state: env_mod.EnvState
    obs: jax.Array
    key: jax.Array
    step: jax.Array
    annealing_weight: jax.Array
    rl_perf_ema: jax.Array       # episode-performance EMAs for adaptation
    heur_perf_ema: jax.Array


def heuristic_action(obs: jax.Array) -> jax.Array:
    """Cooling heuristic (reference _get_annealing_recommendation,
    hybrid_agent.py:247-271): cool steadily, reheat on plateau."""
    acc = obs[..., 4]
    plateau_frac = obs[..., 8]
    cool = jnp.full(obs.shape[:-1], 3, jnp.int32)       # multiplier 0.9
    reheat = jnp.full(obs.shape[:-1], 8, jnp.int32)     # multiplier 1.5
    freeze = jnp.full(obs.shape[:-1], 1, jnp.int32)     # multiplier 0.7
    action = jnp.where(plateau_frac > 0.5, reheat,
                       jnp.where(acc > 0.6, freeze, cool))
    return action


def make_dqn(problem: IsingProblem, env_cfg: EnvConfig,
             cfg: Optional[DQNConfig] = None, engine="auto"):
    """``engine``: "auto" builds the fast sweep engine (env.default_engine);
    None keeps the blocked XLA fallback; or pass a SweepEngine."""
    cfg = cfg or DQNConfig()
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    model = QNetwork(n_actions=env_mod.N_ACTIONS,
                     hidden_sizes=cfg.hidden_sizes)
    tx = optax.adam(cfg.lr)

    def init_fn(key: Optional[jax.Array] = None) -> DQNState:
        key = key if key is not None else jax.random.key(cfg.seed)
        key, k_env, k_par = jax.random.split(key, 3)
        env_state, obs = env_mod.reset(problem, env_cfg, k_env, engine)
        params = model.init(k_par, obs)
        buf_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                   else ReplayBuffer)
        return DQNState(
            params=params, target_params=params, opt_state=tx.init(params),
            buffer=buf_cls.create(cfg.buffer_size,
                                  env_mod.obs_dim(problem, env_cfg)),
            env_state=env_state, obs=obs, key=key,
            step=jnp.asarray(0, jnp.int32),
            annealing_weight=jnp.asarray(cfg.annealing_weight, jnp.float32),
            rl_perf_ema=jnp.asarray(0.0, jnp.float32),
            heur_perf_ema=jnp.asarray(0.0, jnp.float32),
        )

    def epsilon(step):
        frac = jnp.clip(step / cfg.epsilon_decay_steps, 0.0, 1.0)
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _act_and_learn_raw(state: DQNState, prob=None, eng_ops=None):
        """One env step for all B envs + one gradient step. prob/eng_ops
        as traced args keep the instance arrays out of the HLO
        (anneal.engines.SweepEngine jit-boundary contract)."""
        prob = prob if prob is not None else problem
        eng = (engine.bind(eng_ops)
               if eng_ops is not None and engine is not None else engine)
        key, k_eps, k_rand, k_hyb, k_env, k_reset, k_samp = jax.random.split(
            state.key, 7)
        b = env_cfg.n_envs
        # hybrid decision (hybrid_agent.py:226-245)
        q = model.apply(state.params, state.obs)
        greedy = jnp.argmax(q, axis=-1)
        rand_a = jax.random.randint(k_rand, (b,), 0, env_mod.N_ACTIONS)
        eps_mask = jax.random.uniform(k_eps, (b,)) < epsilon(state.step)
        rl_action = jnp.where(eps_mask, rand_a, greedy)
        heur = heuristic_action(state.obs)
        use_heur = jax.random.uniform(k_hyb, (b,)) < state.annealing_weight
        action = jnp.where(use_heur, heur, rl_action)

        env_state, next_obs, reward, done = env_mod.step(
            prob, env_cfg, state.env_state, action, k_env, eng)
        buffer = state.buffer.push_batch(state.obs, action, reward,
                                         next_obs, done)
        env_state, next_obs_reset = env_mod.auto_reset(
            prob, env_cfg, env_state, k_reset, eng)

        # adapt the hybrid weight from per-choice reward EMAs
        # (hybrid_agent.py:381-406, per-step instead of per-episode)
        rl_r = jnp.sum(jnp.where(~use_heur, reward, 0.0)) / jnp.maximum(
            jnp.sum(~use_heur), 1)
        h_r = jnp.sum(jnp.where(use_heur, reward, 0.0)) / jnp.maximum(
            jnp.sum(use_heur), 1)
        rl_ema = 0.99 * state.rl_perf_ema + 0.01 * rl_r
        h_ema = 0.99 * state.heur_perf_ema + 0.01 * h_r
        w = state.annealing_weight + cfg.weight_adapt_rate * jnp.sign(
            h_ema - rl_ema) * 0.01
        w = jnp.clip(w, 0.05, 0.95)

        # DQN TD update (importance-weighted when PER is on)
        if cfg.prioritized_replay:
            batch, samp_idx, is_w = buffer.sample(
                k_samp, cfg.batch_size, cfg.per_alpha, cfg.per_beta)
        else:
            batch = buffer.sample(k_samp, cfg.batch_size)
            samp_idx, is_w = None, jnp.ones((cfg.batch_size,), jnp.float32)

        def loss_fn(params):
            qs = model.apply(params, batch["obs"])
            q_sel = jnp.take_along_axis(qs, batch["action"][:, None],
                                        axis=-1)[:, 0]
            q_next = model.apply(state.target_params, batch["next_obs"])
            target = batch["reward"] + cfg.gamma * jnp.max(q_next, -1) * (
                1.0 - batch["done"].astype(jnp.float32))
            td = q_sel - lax.stop_gradient(target)
            return jnp.mean(is_w * td ** 2), jnp.abs(td)

        (loss, td_abs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        if cfg.prioritized_replay:
            buffer = buffer.update_priorities(samp_idx, td_abs, cfg.per_eps)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        target_params = jax.tree.map(
            lambda t, p: (1 - cfg.tau) * t + cfg.tau * p,
            state.target_params, params)

        new_state = state.replace(
            params=params, target_params=target_params, opt_state=opt_state,
            buffer=buffer, env_state=env_state, obs=next_obs_reset, key=key,
            step=state.step + 1, annealing_weight=w,
            rl_perf_ema=rl_ema, heur_perf_ema=h_ema)
        metrics = dict(loss=loss, mean_reward=jnp.mean(reward),
                       epsilon=epsilon(state.step), annealing_weight=w,
                       mean_best_energy=jnp.mean(env_state.best_energy))
        return new_state, metrics

    from spinglass_tpu.anneal.engines import bind_call

    act_and_learn = bind_call(_act_and_learn_raw, problem, engine)
    return init_fn, act_and_learn, model


def save_params(params, path: str) -> None:
    """Flat npz checkpoint (reference torch.save, hybrid_agent.py:464-491)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in flat})


def load_params(template, path: str):
    with np.load(path) as z:
        flat, treedef = jax.tree_util.tree_flatten_with_path(template)
        leaves = [jnp.asarray(z[jax.tree_util.keystr(k)]) for k, _ in flat]
        return jax.tree_util.tree_unflatten(treedef, leaves)
