"""Gymnasium adapter (reference SpinGlassEnv gym.Env parity,
rl_integration/environment.py:51)."""

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.rl.env import EnvConfig
from spinglass_tpu.rl.gym_adapter import SpinGlassGymEnv


@pytest.fixture(scope="module")
def problem():
    j = topology.fully_connected(24, dist="gaussian", scale=0.2, seed=3)
    return IsingProblem.from_dense(j)


class TestGymAdapter:
    def test_passes_gymnasium_env_checker(self, problem):
        """gymnasium's own API-compliance checker: spaces, reset/step
        signatures, determinism under a fixed seed, dtype contracts."""
        from gymnasium.utils.env_checker import check_env

        env = SpinGlassGymEnv(problem, EnvConfig(
            n_envs=1, sweeps_per_step=2, max_steps=6))
        check_env(env, skip_render_check=True)

    def test_discrete_episode(self, problem):
        env = SpinGlassGymEnv(problem, EnvConfig(
            n_envs=1, sweeps_per_step=2, max_steps=5), seed=0)
        obs, info = env.reset(seed=1)
        assert obs.shape == (16,)
        assert np.isfinite(info["energy"])
        total_r = 0.0
        for t in range(5):
            obs, r, terminated, truncated, info = env.step(
                env.action_space.sample())
            total_r += r
            if terminated or truncated:
                break
        assert truncated or terminated      # max_steps=5 forces an end
        assert info["best_energy"] <= info["energy"] + 1e-6
        assert np.isfinite(total_r)

    def test_continuous_mode_space_and_step(self, problem):
        env = SpinGlassGymEnv(problem, EnvConfig(
            n_envs=1, action_mode="continuous", sweeps_per_step=2,
            max_steps=4), seed=0)
        assert isinstance(env.action_space, gymnasium.spaces.Box)
        obs, _ = env.reset(seed=2)
        obs, r, term, trunc, info = env.step(
            np.array([1.5, 0.5], np.float32))
        assert obs.shape == (16,)
        assert np.isfinite(r)
        # temperature must have moved by about the multiplier
        assert info["temperature"] == pytest.approx(
            2.0 * 1.5, rel=0.2)

    def test_batched_cfg_coerced_to_single(self, problem):
        env = SpinGlassGymEnv(problem, EnvConfig(n_envs=32, max_steps=3))
        assert env.cfg.n_envs == 1
        obs, _ = env.reset(seed=0)
        assert obs.shape == (16,)

    def test_spins_obs_mode_widens_space(self, problem):
        """obs_mode='spins' flows through the adapter: the observation
        space and returned observations carry spins + the 16 globals."""
        from spinglass_tpu.rl import env as fenv

        cfg = EnvConfig(n_envs=1, obs_mode="spins", sweeps_per_step=2,
                        max_steps=3)
        env = SpinGlassGymEnv(problem, cfg, seed=0)
        want = fenv.obs_dim(problem, cfg)
        assert env.observation_space.shape == (want,)
        obs, _ = env.reset(seed=1)
        assert obs.shape == (want,)
        spins = obs[:problem.n_spins]
        assert set(np.unique(spins)) <= {-1.0, 1.0}
        obs2, r, term, trunc, info = env.step(0)
        assert obs2.shape == (want,)
