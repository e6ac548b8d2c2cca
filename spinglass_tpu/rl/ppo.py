"""PPO controller over the vectorized annealer environment.

The BASELINE.json north star names a PPO-style controller (the reference's
README promises PPOController but ships none — SURVEY header; its real agent
is the DQN hybrid, kept in rl/dqn.py as the baseline variant). This is an
on-device actor-learner: rollouts are a jitted lax.scan over the batched env,
GAE + clipped-surrogate updates run in the same jit, and the whole train step
is data-parallel shardable (params replicated, env batch sharded — see
distributed/rl_sharded.py).

Action modes (matching reference environment.py:88-113):
  discrete   — categorical over the temperature-multiplier ladder
  continuous — diagonal-Gaussian head over [temp_mult, sweep_frac]
               (reference's Box action space, environment.py:97-104)
  hybrid     — categorical temp_index + Gaussian sweep_frac dict action
               (reference's Dict space, environment.py:105-113)

The env hot path runs through anneal.engines.make_engine (the dense block
kernel on a GPU, sorted sliced-ELL for sparse EllProblem) unless an explicit
``engine`` is passed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield
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
from spinglass_tpu.rl.env import EnvConfig, EnvState
from spinglass_tpu.rl.mlp import MLP

_LOG2PI = float(np.log(2.0 * np.pi))


@dataclass(frozen=True)
class PPOConfig:
    hidden_sizes: Tuple[int, ...] = (128, 128)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    rollout_len: int = 16
    n_epochs: int = 4
    n_minibatches: int = 4
    max_grad_norm: float = 0.5
    n_updates: int = 50
    updates_per_dispatch: int = 1   # >1 scans this many PPO updates inside
    # ONE jitted dispatch, amortizing the fixed cost of each dispatch
    seed: int = 0


class ActorCritic:
    """MLP trunk + policy head(s) per action mode + value head.

    The heads are one linear output layer, split into the value, the logits
    and the raw Gaussian means. continuous: state-independent log_std
    parameters (standard PPO choice), mean squashed to the env's valid ranges
    with a scaled tanh so clipping in the env never hides probability mass.
    init(key, obs) -> params; apply(params, obs) -> (dist, value)."""

    def __init__(self, action_mode: str = "discrete",
                 n_actions: int = env_mod.N_ACTIONS,
                 hidden_sizes: Tuple[int, ...] = (128, 128)):
        if action_mode not in ("discrete", "continuous", "hybrid"):
            raise ValueError(action_mode)
        self.action_mode = action_mode
        self.n_actions = n_actions
        self.hidden_sizes = tuple(hidden_sizes)
        self.n_logits = 0 if action_mode == "continuous" else n_actions
        self.n_means = {"discrete": 0, "continuous": 2, "hybrid": 1}[
            action_mode]
        self.mlp = MLP(self.hidden_sizes, 1 + self.n_logits + self.n_means)

    def init(self, key: jax.Array, obs: jax.Array) -> dict:
        params = {"mlp": self.mlp.init(key, obs)}
        if self.n_means:
            params["log_std"] = jnp.full((self.n_means,), -0.7, jnp.float32)
        return params

    def apply(self, params: dict, obs: jax.Array):
        out = self.mlp.apply(params["mlp"], obs)
        value = out[..., 0]
        logits = out[..., 1:1 + self.n_logits]
        raw = out[..., 1 + self.n_logits:]
        if self.action_mode == "discrete":
            return {"logits": logits}, value
        if self.action_mode == "continuous":
            # temp_mult in [0.5, 2.0], sweep_frac in [0.1, 1.0]
            mean = jnp.stack([
                1.25 + 0.75 * jnp.tanh(raw[..., 0]),
                0.55 + 0.45 * jnp.tanh(raw[..., 1]),
            ], axis=-1)
            return {"mean": mean,
                    "log_std": jnp.broadcast_to(params["log_std"],
                                                mean.shape)}, value
        mean = 0.55 + 0.45 * jnp.tanh(raw[..., 0])
        return {"logits": logits, "mean": mean,
                "log_std": jnp.broadcast_to(params["log_std"], mean.shape)
                }, value


def _gauss_logp(mean, log_std, x):
    var = jnp.exp(2.0 * log_std)
    return jnp.sum(-0.5 * ((x - mean) ** 2 / var + 2.0 * log_std + _LOG2PI),
                   axis=-1)


def _gauss_entropy(log_std):
    return jnp.sum(log_std + 0.5 * (_LOG2PI + 1.0), axis=-1)


def make_policy(action_mode: str):
    """(sample, log_prob, entropy) triple for the mode; actions match what
    env._decode_action expects."""
    if action_mode == "discrete":
        def sample(dist, key):
            return jax.random.categorical(key, dist["logits"])

        def log_prob(dist, action):
            return jnp.take_along_axis(jax.nn.log_softmax(dist["logits"]),
                                       action[..., None], axis=-1)[..., 0]

        def entropy(dist):
            logp = jax.nn.log_softmax(dist["logits"])
            return -jnp.sum(jnp.exp(logp) * logp, axis=-1)

        return sample, log_prob, entropy

    if action_mode == "continuous":
        def sample(dist, key):
            eps = jax.random.normal(key, dist["mean"].shape)
            return dist["mean"] + jnp.exp(dist["log_std"]) * eps

        def log_prob(dist, action):
            return _gauss_logp(dist["mean"], dist["log_std"], action)

        def entropy(dist):
            return _gauss_entropy(dist["log_std"])

        return sample, log_prob, entropy

    if action_mode == "hybrid":
        def sample(dist, key):
            k1, k2 = jax.random.split(key)
            idx = jax.random.categorical(k1, dist["logits"])
            eps = jax.random.normal(k2, dist["mean"].shape)
            frac = dist["mean"] + jnp.exp(dist["log_std"]) * eps
            return {"temp_index": idx, "sweep_frac": frac}

        def log_prob(dist, action):
            logp_d = jnp.take_along_axis(
                jax.nn.log_softmax(dist["logits"]),
                action["temp_index"][..., None], axis=-1)[..., 0]
            logp_c = _gauss_logp(dist["mean"][..., None],
                                 dist["log_std"][..., None],
                                 action["sweep_frac"][..., None])
            return logp_d + logp_c

        def entropy(dist):
            logp = jax.nn.log_softmax(dist["logits"])
            return (-jnp.sum(jnp.exp(logp) * logp, axis=-1)
                    + _gauss_entropy(dist["log_std"][..., None]))

        return sample, log_prob, entropy

    raise ValueError(action_mode)


@pytree.dataclass
class TrainState:
    params: dict
    opt_state: optax.OptState
    env_state: EnvState
    obs: jax.Array
    key: jax.Array
    update: jax.Array


def make_ppo(problem: IsingProblem, env_cfg: EnvConfig,
             cfg: Optional[PPOConfig] = None, engine="auto"):
    """Returns (init_fn, update_fn, model). update_fn is one fully-jitted
    PPO iteration: rollout + GAE + clipped updates.

    ``engine``: "auto" builds the fast sweep engine host-side (the block
    kernel on a GPU, sparse ELL for EllProblem); None forces the plain
    blocked XLA sweep;
    or pass a SweepEngine."""
    cfg = cfg or PPOConfig()
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    model = ActorCritic(action_mode=env_cfg.action_mode,
                        n_actions=env_mod.N_ACTIONS,
                        hidden_sizes=cfg.hidden_sizes)
    sample_a, log_prob, entropy_fn = make_policy(env_cfg.action_mode)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))

    def init_fn(key: Optional[jax.Array] = None) -> TrainState:
        key = key if key is not None else jax.random.key(cfg.seed)
        key, k_env, k_par = jax.random.split(key, 3)
        env_state, obs = env_mod.reset(problem, env_cfg, k_env, engine)
        params = model.init(k_par, obs)
        return TrainState(params=params, opt_state=tx.init(params),
                          env_state=env_state, obs=obs, key=key,
                          update=jnp.asarray(0, jnp.int32))

    def rollout(state: TrainState, prob=None, eng=None):
        prob = prob if prob is not None else problem
        eng = eng if eng is not None else engine

        def step_fn(carry, _):
            env_state, obs, key = carry
            key, k_act, k_env, k_reset = jax.random.split(key, 4)
            dist, value = model.apply(state.params, obs)
            action = sample_a(dist, k_act)
            logp = log_prob(dist, action)
            env_state, next_obs, reward, done = env_mod.step(
                prob, env_cfg, env_state, action, k_env, eng)
            env_state, next_obs = env_mod.auto_reset(
                prob, env_cfg, env_state, k_reset, eng)
            traj = dict(obs=obs, action=action, logp=logp, value=value,
                        reward=reward, done=done)
            return (env_state, next_obs, key), traj

        (env_state, obs, key), traj = lax.scan(
            step_fn, (state.env_state, state.obs, state.key), None,
            length=cfg.rollout_len)
        _, last_value = model.apply(state.params, obs)
        return state.replace(env_state=env_state, obs=obs, key=key), traj, last_value

    def gae(traj, last_value):
        """Generalized advantage estimation over the [T, B] rollout."""
        def scan_fn(carry, x):
            adv_next, v_next = carry
            reward, value, done = x
            nonterm = 1.0 - done.astype(jnp.float32)
            delta = reward + cfg.gamma * v_next * nonterm - value
            adv = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
            return (adv, value), adv

        (_, _), advs = lax.scan(
            scan_fn, (jnp.zeros_like(last_value), last_value),
            (traj["reward"], traj["value"], traj["done"]), reverse=True)
        returns = advs + traj["value"]
        return advs, returns

    def loss_fn(params, batch):
        dist, value = model.apply(params, batch["obs"])
        logp = log_prob(dist, batch["action"])
        ratio = jnp.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        unclipped = ratio * adv
        clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
        value_loss = jnp.mean((value - batch["ret"]) ** 2)
        entropy = jnp.mean(entropy_fn(dist))
        loss = (policy_loss + cfg.value_coef * value_loss
                - cfg.entropy_coef * entropy)
        return loss, dict(policy_loss=policy_loss, value_loss=value_loss,
                          entropy=entropy)

    def _update_raw(state: TrainState, prob=None, eng_ops=None):
        # prob/eng_ops as traced args keep the problem + engine arrays out
        # of the compiled HLO (anneal.engines.SweepEngine jit-boundary
        # contract) — at 10k+-spin sparse RL the embedded ELL/bucket
        # tables otherwise ride along with every PPO compile
        eng = (engine.bind(eng_ops)
               if eng_ops is not None and engine is not None else engine)
        state, traj, last_value = rollout(state, prob, eng)
        advs, rets = gae(traj, last_value)
        t, b = advs.shape

        def _flat(x):
            return x.reshape((t * b,) + x.shape[2:])

        flat = dict(
            obs=_flat(traj["obs"]),
            action=jax.tree.map(_flat, traj["action"]),
            logp=_flat(traj["logp"]),
            adv=advs.reshape(t * b),
            ret=rets.reshape(t * b),
        )

        def epoch_fn(carry, key_ep):
            params, opt_state = carry
            perm = jax.random.permutation(key_ep, t * b)
            mbs = cfg.n_minibatches
            mb_idx = perm.reshape(mbs, (t * b) // mbs)

            def mb_fn(carry, idx):
                params, opt_state = carry
                batch = jax.tree.map(lambda x: x[idx], flat)
                (loss, aux), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, batch)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), aux

            (params, opt_state), aux = lax.scan(mb_fn, (params, opt_state),
                                                mb_idx)
            return (params, opt_state), aux

        key, k_ep = jax.random.split(state.key)
        ep_keys = jax.random.split(k_ep, cfg.n_epochs)
        (params, opt_state), aux = lax.scan(
            epoch_fn, (state.params, state.opt_state), ep_keys)
        metrics = dict(
            mean_reward=jnp.mean(traj["reward"]),
            mean_best_energy=jnp.mean(state.env_state.best_energy),
            policy_loss=jnp.mean(aux["policy_loss"]),
            value_loss=jnp.mean(aux["value_loss"]),
            entropy=jnp.mean(aux["entropy"]),
        )
        state = state.replace(params=params, opt_state=opt_state, key=key,
                              update=state.update + 1)
        return state, metrics

    # jitted wrapper with .raw/.call_args so train() can scan updates
    # inside ONE dispatch without re-embedding the arrays (engines.
    # bind_call is the shared operands-contract plumbing)
    from spinglass_tpu.anneal.engines import bind_call

    update_fn = bind_call(_update_raw, problem, engine)
    return init_fn, update_fn, model


def train(problem: IsingProblem, env_cfg: Optional[EnvConfig] = None,
          cfg: Optional[PPOConfig] = None, verbose: bool = False,
          engine="auto", resume_state: Optional[TrainState] = None) -> dict:
    """Full training loop; returns params + per-update metric history.

    ``resume_state``: continue from a prior TrainState (see
    utils.checkpoint.save_pytree / load_pytree for persistence)."""
    env_cfg = env_cfg or EnvConfig()
    cfg = cfg or PPOConfig()
    init_fn, update_fn, model = make_ppo(problem, env_cfg, cfg, engine)
    state = resume_state if resume_state is not None else init_fn()
    start = int(state.update)
    history = []
    update_times = []
    t0 = time.perf_counter()
    n_run = max(cfg.n_updates - start, 0)
    kd = max(1, cfg.updates_per_dispatch)
    if kd > 1:
        # update_fn.raw/.call_args come from engines.bind_call; calling the
        # jitted update_fn INSIDE this traced scan would capture the
        # operand arrays as constants (ADR-0004), so the unjitted body is
        # mandatory here — fail loudly if a custom update_fn lacks it
        raw, call_args = update_fn.raw, update_fn.call_args

        @jax.jit
        def _multi(st, *args):
            def body(st, _):
                return raw(st, *args)
            return lax.scan(body, st, None, length=kd)

        def multi_update(st):
            return _multi(st, *call_args)

    # Remainder updates (n_run % kd) run FIRST as single dispatches: the
    # standalone update_fn executable is distinct from the scanned one, so
    # its compile must land inside the warmup prefix rather than polluting
    # a "steady-state" entry mid-run (found in r4 review).
    rem = n_run % kd if kd > 1 else 0
    u = 0
    while u < n_run:
        t_u = time.perf_counter()
        if kd > 1 and u >= rem:
            state, ms = multi_update(state)
            ms = {k: np.asarray(v) for k, v in ms.items()}  # syncs
            step_metrics = [{k: float(v[i]) for k, v in ms.items()}
                            for i in range(kd)]
        else:
            state, metrics = update_fn(state)
            # the float() conversions force a device sync, so t_u deltas
            # are honest wall times (no extra block_until_ready needed)
            step_metrics = [{k: float(v) for k, v in metrics.items()}]
        dt = time.perf_counter() - t_u
        history.extend(step_metrics)
        update_times.extend([dt / len(step_metrics)] * len(step_metrics))
        u += len(step_metrics)
        if verbose and (u % 10 < len(step_metrics) or u >= n_run):
            print(f"update {start + u - 1}: {history[-1]}")
    total = time.perf_counter() - t0
    # steady state = everything after the warmup prefix: remainder singles
    # (each may compile) + the first scanned DISPATCH (kd updates) when
    # batching; 2 single updates otherwise — the second often still pays
    # allocator warmup
    n_warm = min(rem + kd if kd > 1 else 2, max(n_run - 1, 0))
    steady = sum(update_times[n_warm:])
    env_steps = n_run * cfg.rollout_len * env_cfg.n_envs
    steady_steps = max(n_run - n_warm, 1) * cfg.rollout_len * env_cfg.n_envs
    try:  # prometheus gauges (no-op cost when nothing scrapes them)
        from spinglass_tpu.utils.metrics_exporter import publish_rl_metrics

        publish_rl_metrics(
            steady_steps / steady if steady > 0 else 0.0,
            history[-1]["mean_best_energy"] if history else float("nan"))
    except Exception:  # pragma: no cover - metrics must never break a run
        pass
    return {
        "params": state.params,
        "state": state,
        "history": history,
        # steady-state rate (first-2-updates' compile/warmup excluded)
        "env_steps_per_second": steady_steps / steady if steady > 0 else 0.0,
        "env_steps_per_second_incl_compile": env_steps / total
        if total > 0 else 0.0,
        "total_time": total,
        "update_times": update_times,
        "final_mean_best_energy": history[-1]["mean_best_energy"]
        if history else float("nan"),
    }
