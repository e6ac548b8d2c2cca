"""Temperature schedules as pure, jittable functions of the sweep index.

Rebuilds all 9 reference schedules (annealing/temperature_scheduler.py:69-269)
plus CONSTANT (used by the RL environment). Stateless schedules are closed-form
T(t); ADAPTIVE carries (temp, acceptance-EMA) through the annealing scan, which
replaces the reference's window-buffer implementation
(temperature_scheduler.py:206-249) with an EMA targeting the same 0.44
acceptance rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield
from enum import Enum
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from spinglass_tpu.core import pytree


class ScheduleType(Enum):
    LINEAR = "linear"
    EXPONENTIAL = "exponential"
    GEOMETRIC = "geometric"
    LOGARITHMIC = "logarithmic"
    POWER_LAW = "power_law"
    FAST = "fast"
    BOLTZMANN = "boltzmann"
    ADAPTIVE = "adaptive"
    CUSTOM = "custom"
    CONSTANT = "constant"


@dataclass(frozen=True)
class ScheduleConfig:
    """Static schedule parameters (reference temperature_scheduler.py:24-40)."""

    schedule_type: ScheduleType = ScheduleType.GEOMETRIC
    initial_temp: float = 10.0
    final_temp: float = 0.01
    total_sweeps: int = 1000
    # geometric decay; None (default) solves alpha from the endpoints so the
    # schedule actually reaches final_temp at total_sweeps — a fixed alpha
    # only cools correctly for one specific horizon
    alpha: Optional[float] = None
    power: float = 2.0             # power-law exponent
    target_acceptance: float = 0.44
    adaptation_rate: float = 0.05
    ema_decay: float = 0.9         # adaptive acceptance EMA
    custom_fn: Optional[Callable[[jax.Array], jax.Array]] = None


@pytree.dataclass
class ScheduleState:
    """Carried schedule state; `temp` is the temperature for the *next* sweep."""

    temp: jax.Array          # f32 scalar
    acc_ema: jax.Array       # f32 scalar, acceptance-rate EMA (adaptive only)


def init_state(cfg: ScheduleConfig) -> ScheduleState:
    return ScheduleState(
        temp=jnp.asarray(cfg.initial_temp, jnp.float32),
        acc_ema=jnp.asarray(cfg.target_acceptance, jnp.float32),
    )


def temperature_at(cfg: ScheduleConfig, t: jax.Array) -> jax.Array:
    """Closed-form T(t) for the stateless schedules; t is the sweep index."""
    t = jnp.asarray(t, jnp.float32)
    t0, t1 = cfg.initial_temp, cfg.final_temp
    total = max(cfg.total_sweeps - 1, 1)
    frac = jnp.clip(t / total, 0.0, 1.0)
    st = cfg.schedule_type
    if st == ScheduleType.LINEAR:
        temp = t0 + (t1 - t0) * frac
    elif st == ScheduleType.EXPONENTIAL:
        # lam solved from endpoints: T(t) = T0 * exp(-lam t), T(total) = T1
        lam = math.log(t0 / max(t1, 1e-12)) / total
        temp = t0 * jnp.exp(-lam * t)
    elif st == ScheduleType.GEOMETRIC:
        temp = t0 * jnp.power(resolve_alpha(cfg), t)
    elif st == ScheduleType.LOGARITHMIC:
        temp = t0 * math.log(2.0) / jnp.log(2.0 + t)
    elif st == ScheduleType.POWER_LAW:
        temp = t0 * jnp.power(1.0 - frac, cfg.power) + t1 * frac
    elif st == ScheduleType.FAST:
        temp = t0 / (1.0 + t)
    elif st == ScheduleType.BOLTZMANN:
        # T0/log(t) Boltzmann annealing, normalized so T(0) = T0
        temp = t0 * math.log(math.e) / jnp.log(math.e + t)
    elif st == ScheduleType.CONSTANT:
        temp = jnp.asarray(t0, jnp.float32)
    elif st == ScheduleType.CUSTOM:
        if cfg.custom_fn is None:
            raise ValueError("CUSTOM schedule requires custom_fn")
        temp = jnp.asarray(cfg.custom_fn(t), jnp.float32)
    elif st == ScheduleType.ADAPTIVE:
        raise ValueError("ADAPTIVE has no closed form; use update()")
    else:
        raise ValueError(st)
    return jnp.maximum(temp, t1)


def resolve_alpha(cfg: ScheduleConfig) -> float:
    """Geometric decay rate: explicit, or solved so T(total) = final_temp."""
    if cfg.alpha is not None:
        return cfg.alpha
    total = max(cfg.total_sweeps - 1, 1)
    return float((max(cfg.final_temp, 1e-12) / cfg.initial_temp)
                 ** (1.0 / total))


def update(cfg: ScheduleConfig, state: ScheduleState, t: jax.Array,
           acceptance_rate: jax.Array) -> ScheduleState:
    """Advance the schedule by one sweep. Jittable; t is the sweep just finished."""
    if cfg.schedule_type == ScheduleType.ADAPTIVE:
        ema = cfg.ema_decay * state.acc_ema + (1.0 - cfg.ema_decay) * acceptance_rate
        # geometric base decay, nudged toward the target acceptance rate
        # (reference temperature_scheduler.py:206-249)
        base = state.temp * resolve_alpha(cfg)
        adj = 1.0 + cfg.adaptation_rate * jnp.sign(ema - cfg.target_acceptance)
        temp = jnp.clip(base * adj, cfg.final_temp, cfg.initial_temp * 10.0)
        return ScheduleState(temp=temp, acc_ema=ema)
    return ScheduleState(temp=temperature_at(cfg, t + 1), acc_ema=state.acc_ema)


def schedule_trajectory(cfg: ScheduleConfig, n_sweeps: Optional[int] = None) -> jax.Array:
    """[n_sweeps] temperature trajectory (host-side helper for plots/tests;
    reference temperature_scheduler.py:339-421)."""
    n = n_sweeps or cfg.total_sweeps
    if cfg.schedule_type == ScheduleType.ADAPTIVE:
        st = init_state(cfg)
        temps = []
        for t in range(n):
            temps.append(float(st.temp))
            st = update(cfg, st, jnp.asarray(t), jnp.asarray(cfg.target_acceptance))
        return jnp.asarray(temps)
    return temperature_at(cfg, jnp.arange(n))


def recommend_schedule(n_spins: int, problem_class: str = "general") -> ScheduleConfig:
    """Heuristic recommender (reference temperature_scheduler.py:423-462)."""
    t0 = max(2.0, 0.5 * math.sqrt(n_spins))
    if problem_class in ("tsp", "routing", "scheduling"):
        return ScheduleConfig(ScheduleType.GEOMETRIC, initial_temp=t0,
                              final_temp=0.01, alpha=0.995)
    if problem_class in ("maxcut", "spin_glass"):
        return ScheduleConfig(ScheduleType.ADAPTIVE, initial_temp=t0, final_temp=0.01)
    return ScheduleConfig(ScheduleType.GEOMETRIC, initial_temp=t0, final_temp=0.01)
