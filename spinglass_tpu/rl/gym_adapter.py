"""Gymnasium adapter for the functional annealing environment.

The reference exposes its RL environment as a ``gymnasium.Env``
(rl_integration/environment.py:51 ``class SpinGlassEnv(gym.Env)``); this
framework's native environment is a pure-functional BATCHED env (rl/env.py —
vectorized over n_envs, jit/scan-friendly, used by the PPO/DQN trainers).
This module closes the literal API-surface gap:
a single-instance ``gymnasium.Env`` shim over the functional core so
external RL libraries (SB3, CleanRL, ...) can drive the annealer directly.

The shim is intentionally thin: each ``step`` dispatches one jitted
functional step with B=1. For throughput, use the native batched API — the
adapter exists for ecosystem compatibility, not speed.

Termination semantics: plateau exhaustion -> ``terminated`` (the episode's
MDP reached its absorbing state); step-budget exhaustion -> ``truncated``
(gymnasium's time-limit convention).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

try:
    import gymnasium
    from gymnasium import spaces
except ImportError as _e:  # pragma: no cover - gymnasium is an extra
    gymnasium = None
    _gym_err = _e


def _require_gym():
    if gymnasium is None:  # pragma: no cover
        raise ImportError(
            "gymnasium is required for SpinGlassGymEnv (pip install "
            "gymnasium); the native batched env (spinglass_tpu.rl.env) has "
            "no such dependency") from _gym_err


class SpinGlassGymEnv(gymnasium.Env if gymnasium else object):
    """``gymnasium.Env`` over one annealing episode on a fixed problem.

    Observation: ``Box(-inf, inf, (16,))`` — the functional env's global
    feature vector (rl/env.py OBS_DIM).
    Action (by ``cfg.action_mode``):
      discrete   -> ``Discrete(10)`` temperature-multiplier index
      continuous -> ``Box([0.5, 0.1], [2.0, 1.0])`` (temp mult, sweep frac)
      hybrid     -> ``Dict(temp_index=Discrete(10), sweep_frac=Box)``
    """

    metadata = {"render_modes": []}

    def __init__(self, problem, cfg=None, engine="auto",
                 seed: Optional[int] = None):
        _require_gym()
        import jax

        from spinglass_tpu.rl import env as fenv

        if cfg is None:
            cfg = fenv.EnvConfig(n_envs=1)
        if cfg.n_envs != 1:
            # single-env semantics; the batched API serves n_envs > 1
            import dataclasses

            cfg = dataclasses.replace(cfg, n_envs=1)
        self.problem = problem
        self.cfg = cfg
        self._fenv = fenv
        self._engine = (fenv.default_engine(problem, cfg)
                        if engine == "auto" else engine)
        eng = self._engine
        if eng is not None and hasattr(eng, "operands"):
            # ADR-0004 operands-as-arguments contract:
            # problem + engine arrays cross the jit boundary as traced
            # ARGUMENTS, not closure constants, so large instances don't
            # embed J in the HLO (278 MB executables) and a new problem
            # object of the same shape reuses the compile.
            raw_reset = jax.jit(
                lambda key, prob, ops: fenv.reset(prob, cfg, key,
                                                  eng.bind(ops)))
            raw_step = jax.jit(
                lambda state, action, key, prob, ops: fenv.step(
                    prob, cfg, state, action, key, eng.bind(ops)))
            ops = eng.operands()
            self._reset_fn = lambda key: raw_reset(key, problem, ops)
            self._step_fn = (lambda state, action, key:
                             raw_step(state, action, key, problem, ops))
        else:  # engine=None (pure blocked-XLA fallback): problem still a
            # traced argument; there are no engine arrays to route
            raw_reset = jax.jit(
                lambda key, prob: fenv.reset(prob, cfg, key, eng))
            raw_step = jax.jit(
                lambda state, action, key, prob: fenv.step(
                    prob, cfg, state, action, key, eng))
            self._reset_fn = lambda key: raw_reset(key, problem)
            self._step_fn = (lambda state, action, key:
                             raw_step(state, action, key, problem))
        self._key = jax.random.key(0 if seed is None else seed)
        self._state = None

        self.observation_space = spaces.Box(
            -np.inf, np.inf, (fenv.obs_dim(problem, cfg),), np.float32)
        if cfg.action_mode == "discrete":
            self.action_space = spaces.Discrete(fenv.N_ACTIONS)
        elif cfg.action_mode == "continuous":
            self.action_space = spaces.Box(
                low=np.array([0.5, 0.1], np.float32),
                high=np.array([2.0, 1.0], np.float32))
        elif cfg.action_mode == "hybrid":
            self.action_space = spaces.Dict({
                "temp_index": spaces.Discrete(fenv.N_ACTIONS),
                "sweep_frac": spaces.Box(0.1, 1.0, (1,), np.float32),
            })
        else:  # pragma: no cover - EnvConfig validates earlier
            raise ValueError(cfg.action_mode)

    # -- gymnasium API ------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        import jax

        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.key(seed)
        self._key, k = jax.random.split(self._key)
        self._state, obs = self._reset_fn(k)
        return np.asarray(obs[0]), self._info()

    def step(self, action):
        import jax
        import jax.numpy as jnp

        if self._state is None:
            raise RuntimeError("call reset() before step()")
        if self.cfg.action_mode == "discrete":
            act = jnp.asarray([int(action)], jnp.int32)
        elif self.cfg.action_mode == "continuous":
            act = jnp.asarray(np.asarray(action, np.float32)[None, :])
        else:
            act = {"temp_index": jnp.asarray([int(action["temp_index"])],
                                             jnp.int32),
                   "sweep_frac": jnp.asarray(
                       np.asarray(action["sweep_frac"],
                                  np.float32).reshape(1))}
        self._key, k = jax.random.split(self._key)
        self._state, obs, reward, done = self._step_fn(self._state, act, k)
        # independent flags (gymnasium allows both True): plateau is the
        # MDP's absorbing state -> terminated; the step budget -> truncated.
        # Deriving terminated as done && !truncated would hide a genuine
        # plateau-termination landing exactly on the budget step, making
        # external learners bootstrap a terminal state (r4 review).
        truncated = bool(self._state.step[0] >= self.cfg.max_steps)
        terminated = bool(self._state.plateau[0]
                          >= self.cfg.plateau_patience)
        return (np.asarray(obs[0]), float(reward[0]), terminated, truncated,
                self._info())

    def _info(self) -> dict:
        s = self._state
        return {
            "energy": float(s.energy[0]),
            "best_energy": float(s.best_energy[0]),
            "temperature": float(s.temp[0]),
            "acceptance_rate": float(s.acc_rate[0]),
            "step": int(s.step[0]),
        }

    def render(self) -> Any:  # pragma: no cover - no render modes
        return None
