"""Composable reward shaping for the annealer environment.

Rebuilds the reference's RewardComponent stack
(rl_integration/reward_shaping.py:14-443) as pure functions with a carried
normalization state:

* energy-delta with adaptive normalization (reward_shaping.py:59-93)
* acceptance-rate targeting 0.44 (:96-120)
* temperature-schedule conformance — rapid-change penalty + deviation from
  the expected progress-linear schedule (:123-155, TemperatureReward)
* exploration novelty bonus — the reference keeps a host-side set of visited
  (energy, temperature, action) signatures (:158-186); here that becomes a
  per-env hashed count table carried in RewardState, with the same decaying
  bonus scale — fully vectorized/jittable
* convergence bonus (:190-216)
* efficiency penalty (:220-248)

combined with clipping, EMA smoothing, and curriculum-stage scaling
(:253-344, ``_get_curriculum_scale``: scale = 1 + stage * ramp / stages with
the stage advanced by completed episodes)."""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from spinglass_tpu.core import pytree

N_NOVELTY_BINS = 256


@dataclass(frozen=True)
class RewardConfig:
    """Weights + shaping knobs (reference RewardConfig,
    reward_shaping.py:14-43)."""

    energy_weight: float = 1.0
    acceptance_weight: float = 0.2
    temperature_weight: float = 0.05     # schedule-conformance (ref :123)
    exploration_weight: float = 0.02     # novelty bonus (ref :158)
    convergence_weight: float = 0.5
    efficiency_weight: float = 0.05
    target_acceptance: float = 0.44
    exploration_decay: float = 0.995     # per-step bonus-scale decay (ref :162)
    clip: float = 10.0
    smoothing: float = 0.0               # EMA on the final reward (0 = off)
    norm_decay: float = 0.99             # adaptive |dE| normalization EMA
    curriculum: bool = False             # episode-staged scaling (ref :334)
    curriculum_stages: int = 5
    difficulty_ramp: float = 1.0


@pytree.dataclass
class RewardState:
    de_scale: jax.Array        # [B] EMA of |dE| for adaptive normalization
    reward_ema: jax.Array      # [B]
    prev_temp: jax.Array       # [B] for the rapid-change penalty
    novelty_counts: jax.Array  # [B, N_NOVELTY_BINS] visited-signature table
    novelty_scale: jax.Array   # [B] decaying exploration bonus scale


def init_state(cfg: RewardConfig, n_envs: int) -> RewardState:
    return RewardState(
        de_scale=jnp.ones((n_envs,), jnp.float32),
        reward_ema=jnp.zeros((n_envs,), jnp.float32),
        prev_temp=jnp.full((n_envs,), -1.0, jnp.float32),
        novelty_counts=jnp.zeros((n_envs, N_NOVELTY_BINS), jnp.float32),
        novelty_scale=jnp.ones((n_envs,), jnp.float32),
    )


def _novelty_bin(energy, initial_energy, temp, mult):
    """Hashed signature of (normalized energy, temperature, action) — the
    jittable analog of the reference's state-signature set
    (reward_shaping.py:166-169)."""
    q_e = jnp.round(100.0 * energy / (jnp.abs(initial_energy) + 1e-8))
    q_t = jnp.round(10.0 * jnp.log10(jnp.maximum(temp, 1e-8)))
    q_m = jnp.round(10.0 * mult)
    sig = (q_e.astype(jnp.int32) * 31 + q_t.astype(jnp.int32) * 17
           + q_m.astype(jnp.int32) * 7)
    return jnp.abs(sig) % N_NOVELTY_BINS


def compute(cfg: RewardConfig, state: RewardState, *, energy, prev_energy,
            best_energy, initial_energy, acc_rate, temp, step, max_steps,
            improved, mult=None, episode=None):
    """Returns (reward [B], new RewardState).

    ``mult``: decoded temperature multiplier (novelty signature component);
    ``episode`` [B]: completed-episode counter for curriculum staging."""
    de = prev_energy - energy  # positive = improvement
    scale = cfg.norm_decay * state.de_scale + (1 - cfg.norm_decay) * jnp.abs(de)
    scale = jnp.maximum(scale, 1e-6)
    r_energy = de / scale

    r_accept = -jnp.abs(acc_rate - cfg.target_acceptance)

    # temperature-schedule conformance (reference reward_shaping.py:131-150):
    # penalize >50% per-step temperature changes and deviation from the
    # progress-linear expected schedule T* = 10 (1 - p) + 0.01 p
    progress = step.astype(jnp.float32) / max_steps
    had_prev = state.prev_temp > 0
    change_rate = jnp.abs(temp - state.prev_temp) / jnp.maximum(
        state.prev_temp, 1e-6)
    r_rapid = jnp.where(had_prev & (change_rate > 0.5), -change_rate, 0.0)
    expected_temp = 10.0 * (1.0 - progress) + 0.01 * progress
    r_align = -jnp.abs(temp - expected_temp) / expected_temp
    r_temp = r_rapid + 0.1 * r_align

    # exploration novelty (reference reward_shaping.py:158-186)
    mult_sig = mult if mult is not None else jnp.ones_like(temp)
    bins = _novelty_bin(energy, initial_energy, temp, mult_sig)
    b_idx = jnp.arange(bins.shape[0])
    count = state.novelty_counts[b_idx, bins]
    r_explore = jnp.where(count < 0.5, state.novelty_scale, 0.0)
    novelty_counts = state.novelty_counts.at[b_idx, bins].add(1.0)
    novelty_scale = state.novelty_scale * cfg.exploration_decay

    r_converge = jnp.where(improved, 1.0, 0.0) * progress

    r_eff = -progress

    reward = (cfg.energy_weight * r_energy
              + cfg.acceptance_weight * r_accept
              + cfg.temperature_weight * r_temp
              + cfg.exploration_weight * r_explore
              + cfg.convergence_weight * r_converge
              + cfg.efficiency_weight * r_eff)

    if cfg.curriculum:
        # reference _get_curriculum_scale (reward_shaping.py:334-344): stage
        # advances every 1000/stages completed episodes
        ep = (episode.astype(jnp.float32) if episode is not None
              else jnp.zeros_like(reward))
        per_stage = max(1000 // cfg.curriculum_stages, 1)
        stage = jnp.minimum(ep // per_stage,
                            float(cfg.curriculum_stages - 1))
        reward = reward * (1.0 + stage * cfg.difficulty_ramp
                           / cfg.curriculum_stages)

    reward = jnp.clip(reward, -cfg.clip, cfg.clip)
    if cfg.smoothing > 0:
        reward_ema = (cfg.smoothing * state.reward_ema
                      + (1 - cfg.smoothing) * reward)
        reward = reward_ema
    else:
        reward_ema = reward
    return reward, RewardState(de_scale=scale, reward_ema=reward_ema,
                               prev_temp=temp,
                               novelty_counts=novelty_counts,
                               novelty_scale=novelty_scale)
