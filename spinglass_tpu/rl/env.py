"""Vectorized annealer-as-environment.

Rebuilds the reference's SpinGlassEnv (rl_integration/environment.py:51-537) —
a single-problem Gymnasium loop whose every step runs the whole GPUAnnealer —
as a pure-functional *batched* environment: B annealing trajectories step in
lockstep under jit (the formulation SURVEY §7 step 6 calls for). The RL agent
controls the temperature schedule; the environment IS the annealer.

Everything is a pure function of (problem, EnvState, action, key), with the
problem passed as a pytree *argument* so new random instances do not trigger
recompilation (unlike engine closures).

Engine plumbing: ``reset``/``step``/``auto_reset`` accept an optional
``engine`` (anneal.engines.SweepEngine) built host-side via ``make_engine``.
With an engine the hot path runs the dense blocked sweep (with its GPU
kernel on a GPU) or the sorted sliced-ELL sweep for sparse ``EllProblem``s (so RL over 10k+-spin
sparse instances works); without one it falls back to the dense blocked XLA
sweep. The learners (rl/ppo.py, rl/dqn.py) build an engine automatically.
EnvState.spins stays in [B, Np] layout; layout conversion happens once per
env step around the sweeps_per_step scan (2 transposes per 10 sweeps for
the "nr"-layout Pallas engine — negligible).

Observation (obs_mode="global", default): 16 global features per env,
mirroring environment.py:400-440's global feature vector:
  [E/E0, E_best/E0, dE_last/|E0|, log10(T), acceptance, progress,
   magnetization, E z-score, plateau fraction, last-action one-hot-ish slots]
obs_mode="spins" (reference environment.py:115-154's spins+globals space):
  concat(spins[:n_padded] masked to 0 at padding, global16) — a spin-level
  policy for small instances. obs_dim(problem, cfg) gives the static width;
  PPO sizes its heads from reset()'s obs automatically, DQN's replay buffer
  uses obs_dim().
Action modes (environment.py:88-113):
  discrete   — index into N_TEMP_MULTIPLIERS temperature multipliers
  continuous — [temp_multiplier in [0.5, 2], sweep_fraction in [0, 1]]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core import pytree
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels import sweeps as sweep_kernels
from spinglass_tpu.rl import rewards as reward_mod

# numpy on purpose: a module-level jnp constant would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize in
# multi-process workers (it must run before any backend init)
TEMP_MULTIPLIERS = np.asarray(
    [0.5, 0.7, 0.8, 0.9, 0.95, 1.05, 1.1, 1.25, 1.5, 2.0], np.float32)
N_ACTIONS = 10
OBS_DIM = 16


@dataclass(frozen=True)
class EnvConfig:
    """Static env parameters (reference SpinGlassEnvConfig,
    environment.py:17-48)."""

    n_envs: int = 64
    sweeps_per_step: int = 10
    max_steps: int = 100
    action_mode: str = "discrete"        # discrete | continuous
    obs_mode: str = "global"             # global | spins (env.py:115-154
    # of the reference: spin values + global features for small instances)
    initial_temp: float = 2.0
    init_temp_range: Optional[Tuple[float, float]] = None  # when set, each
    # reset draws the starting temperature log-uniformly per env from this
    # range instead of the fixed initial_temp. A fixed multiplier schedule
    # cannot adapt to a randomized start; an observation-driven controller
    # (obs carries log10 T) can — the setting where learned control
    # demonstrably beats any fixed geometric schedule (rl/evaluate.py)
    min_temp: float = 1e-3
    max_temp: float = 50.0
    update_rule: str = "metropolis"
    block_size: int = 128
    plateau_patience: int = 10           # termination on plateau (env:442-456)
    plateau_tolerance: float = 1e-6
    reward: reward_mod.RewardConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.reward is None:
            object.__setattr__(self, "reward", reward_mod.RewardConfig())


@pytree.dataclass
class EnvState:
    spins: jax.Array          # [B, Np]
    energy: jax.Array         # [B]
    best_energy: jax.Array    # [B]
    initial_energy: jax.Array  # [B]
    prev_energy: jax.Array    # [B]
    temp: jax.Array           # [B]
    acc_rate: jax.Array       # [B]
    step: jax.Array           # [B] i32
    plateau: jax.Array        # [B] i32 — steps since last improvement
    episode: jax.Array        # [B] i32 — completed episodes (curriculum)
    reward_state: reward_mod.RewardState
    done: jax.Array           # [B] bool


def _env_energy(problem, spins, engine=None):
    """Exact batched energies in [B, Np] layout, via the engine when given
    (required for EllProblem, where no dense J exists)."""
    if engine is not None:
        return engine.energy(engine.to_layout(spins))
    return energy_ops.energy(problem, spins)


def reset(problem: IsingProblem, cfg: EnvConfig, key: jax.Array,
          engine=None) -> Tuple[EnvState, jax.Array]:
    """Fresh trajectories: random spins, initial temperature."""
    b = cfg.n_envs
    k_spins, k_temp = jax.random.split(key)
    spins = random_spins(k_spins, (b, problem.n_padded), problem.active_mask)
    e = _env_energy(problem, spins, engine)
    if cfg.init_temp_range is not None:
        lo, hi = cfg.init_temp_range
        t0 = jnp.exp(jax.random.uniform(
            k_temp, (b,), jnp.float32,
            minval=float(np.log(lo)), maxval=float(np.log(hi))))
    else:
        t0 = jnp.full((b,), cfg.initial_temp, jnp.float32)
    state = EnvState(
        spins=spins,
        energy=e,
        best_energy=e,
        initial_energy=e,
        prev_energy=e,
        temp=t0,
        acc_rate=jnp.zeros((b,), jnp.float32),
        step=jnp.zeros((b,), jnp.int32),
        plateau=jnp.zeros((b,), jnp.int32),
        episode=jnp.zeros((b,), jnp.int32),
        reward_state=reward_mod.init_state(cfg.reward, b),
        done=jnp.zeros((b,), bool),
    )
    return state, observe(problem, cfg, state)


def _decode_action(cfg: EnvConfig, action) -> Tuple[jax.Array, jax.Array]:
    """action -> (temp multiplier [B], sweep fraction [B])
    (reference environment.py:276-316).

    hybrid (environment.py:88-113 dict action space): a dict with a discrete
    ladder index ``temp_index`` [B] i32 and a continuous ``sweep_frac`` [B]."""
    if cfg.action_mode == "discrete":
        mult = jnp.asarray(TEMP_MULTIPLIERS)[action]
        frac = jnp.ones_like(mult)
    elif cfg.action_mode == "continuous":
        mult = jnp.clip(action[..., 0], 0.5, 2.0)
        frac = jnp.clip(action[..., 1], 0.1, 1.0)
    elif cfg.action_mode == "hybrid":
        mult = jnp.asarray(TEMP_MULTIPLIERS)[action["temp_index"]]
        frac = jnp.clip(action["sweep_frac"], 0.1, 1.0)
    else:
        raise ValueError(cfg.action_mode)
    return mult, frac


def step(problem: IsingProblem, cfg: EnvConfig, state: EnvState,
         action: jax.Array, key: jax.Array, engine=None
         ) -> Tuple[EnvState, jax.Array, jax.Array, jax.Array]:
    """One env step: apply temperature action, run sweeps_per_step Metropolis
    sweeps at constant T (reference environment.py:318-336), shape reward.

    With ``engine`` (from anneal.engines.make_engine) the sweeps run through
    that engine (the GPU block kernel / sparse ELL engine) instead of the
    plain blocked XLA sweep (reference capability environment.py:318-336).

    Returns (state, obs [B, OBS_DIM], reward [B], done [B])."""
    mult, frac = _decode_action(cfg, action)
    temp = jnp.clip(state.temp * mult, cfg.min_temp, cfg.max_temp)
    beta = 1.0 / temp

    # env axis position for the active-mask broadcast in the engine layout
    env_axis_last = engine is not None and engine.layout == "nr"

    def one_sweep(carry, k):
        spins, energy, cnt_acc, n_done = carry
        # sweep fraction gates each sweep: envs with frac budgets skip
        # trailing sweeps (constant shapes; skipped sweeps are identity)
        i = n_done
        active = (i < jnp.round(frac * cfg.sweeps_per_step)).astype(jnp.float32)
        if engine is not None:
            new_spins, de, cnt = engine.sweep(spins, beta, k)
        else:
            u = jax.random.uniform(k, spins.shape, jnp.float32)
            new_spins, de, cnt = sweep_kernels.blocked_sweep(
                problem, spins, beta, u, block_size=cfg.block_size,
                rule=cfg.update_rule)
        act_b = active[None, :] if env_axis_last else active[:, None]
        spins = jnp.where(act_b > 0, new_spins, spins)
        energy = energy + jnp.where(active > 0, de, 0.0)
        cnt_acc = cnt_acc + jnp.where(active > 0, cnt, 0)
        return (spins, energy, cnt_acc, n_done + 1), None

    keys = jax.random.split(key, cfg.sweeps_per_step)
    spins0 = engine.to_layout(state.spins) if engine is not None else state.spins
    init = (spins0, state.energy,
            jnp.zeros((cfg.n_envs,), jnp.int32),
            jnp.zeros((cfg.n_envs,), jnp.int32))
    (spins, energy, cnt, _), _ = lax.scan(one_sweep, init, keys)
    # exact resync to kill drift (one matmul / sparse pass per env step)
    if engine is not None:
        energy = engine.energy(spins)
        spins = engine.from_layout(spins)
    else:
        energy = energy_ops.energy(problem, spins)

    n_sweeps_eff = jnp.maximum(jnp.round(frac * cfg.sweeps_per_step), 1.0)
    acc_rate = cnt.astype(jnp.float32) / (n_sweeps_eff * problem.n_spins)
    improved = energy < state.best_energy - 1e-9
    best = jnp.minimum(state.best_energy, energy)
    plateau = jnp.where(improved, 0, state.plateau + 1)

    new_state = state.replace(
        spins=spins, energy=energy, best_energy=best,
        prev_energy=state.energy, temp=temp, acc_rate=acc_rate,
        step=state.step + 1, plateau=plateau,
    )
    reward, rstate = reward_mod.compute(
        cfg.reward, new_state.reward_state,
        energy=energy, prev_energy=state.energy, best_energy=best,
        initial_energy=state.initial_energy, acc_rate=acc_rate,
        temp=temp, step=new_state.step, max_steps=cfg.max_steps,
        improved=improved, mult=mult, episode=state.episode)
    new_state = new_state.replace(reward_state=rstate)

    done = (new_state.step >= cfg.max_steps) | (
        plateau >= cfg.plateau_patience)
    new_state = new_state.replace(done=done)
    return new_state, observe(problem, cfg, new_state), reward, done


def obs_dim(problem, cfg: EnvConfig) -> int:
    """Static observation width for (problem, cfg) — replay buffers and
    external adapters need it host-side; PPO infers it from reset()."""
    if cfg.obs_mode == "spins":
        return int(problem.n_padded) + OBS_DIM
    if cfg.obs_mode == "global":
        return OBS_DIM
    raise ValueError(f"obs_mode must be 'global' or 'spins', "
                     f"got {cfg.obs_mode!r}")


def observe(problem: IsingProblem, cfg: EnvConfig, state: EnvState
            ) -> jax.Array:
    """[B, obs_dim] features. obs_mode="global": the 16 global features
    (reference environment.py:400-440). obs_mode="spins": the spin vector
    (padding slots zeroed) concatenated with those 16 globals (reference
    environment.py:115-154)."""
    e0 = jnp.abs(state.initial_energy) + 1e-8
    de = state.energy - state.prev_energy
    mag = energy_ops.magnetization(problem, state.spins)
    zstat = (state.energy - jnp.mean(state.energy)) / (
        jnp.std(state.energy) + 1e-8)
    feats = [
        state.energy / e0,
        state.best_energy / e0,
        de / e0,
        jnp.log10(jnp.maximum(state.temp, 1e-8)),
        state.acc_rate,
        state.step.astype(jnp.float32) / cfg.max_steps,
        mag,
        zstat,
        state.plateau.astype(jnp.float32) / cfg.plateau_patience,
        (state.energy - state.best_energy) / e0,
        jnp.tanh(state.energy / e0),
        jnp.abs(mag),
        state.acc_rate - 0.44,
        jnp.log10(jnp.maximum(state.temp, 1e-8)) / 3.0,
        jnp.ones_like(mag),
        jnp.zeros_like(mag),
    ]
    glob = jnp.stack(feats, axis=-1)
    if cfg.obs_mode == "spins":
        spins = state.spins.astype(jnp.float32) * jnp.asarray(
            problem.active_mask, jnp.float32)[None, :]
        return jnp.concatenate([spins, glob], axis=-1)
    return glob


def auto_reset(problem: IsingProblem, cfg: EnvConfig, state: EnvState,
               key: jax.Array, engine=None) -> Tuple[EnvState, jax.Array]:
    """Reset only the done trajectories (standard vectorized-env pattern)."""
    fresh, fresh_obs = reset(problem, cfg, key, engine)
    done = state.done
    # the episode counter survives resets: it counts COMPLETED episodes
    # (curriculum staging, reference reward_shaping.py:352 reset())
    fresh = fresh.replace(
        episode=state.episode + done.astype(jnp.int32))

    def pick(f, s):
        mask = done.reshape((-1,) + (1,) * (s.ndim - 1))
        return jnp.where(mask, f, s)

    mixed = jax.tree.map(pick, fresh, state)
    return mixed, observe(problem, cfg, mixed)


def default_engine(problem, cfg: EnvConfig):
    """Host-side engine construction for the env hot path (the env must not
    bypass make_engine): the blocked sweep with its GPU kernel on a GPU,
    sorted sparse ELL for EllProblem, plain blocked XLA otherwise."""
    from spinglass_tpu.anneal.engines import make_engine

    return make_engine(problem, update_rule=cfg.update_rule,
                       block_size=cfg.block_size)
