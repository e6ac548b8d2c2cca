"""RL-layer tests: env semantics, reward shaping, PPO/DQN learning smoke
(reference assertion ideas from the hybrid-agent/environment design,
SURVEY §2.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.rl import dqn as dqn_mod
from spinglass_tpu.rl import env as env_mod
from spinglass_tpu.rl import ppo as ppo_mod
from spinglass_tpu.rl import rewards as rew_mod
from spinglass_tpu.rl.env import EnvConfig
from spinglass_tpu.rl.train import RLTrainingPipeline, TrainingConfig


def _problem(n=24, seed=0):
    j = topology.fully_connected(n, dist="gaussian",
                                 scale=1.0 / np.sqrt(n), seed=seed)
    return IsingProblem.from_dense(j)


CFG = EnvConfig(n_envs=8, sweeps_per_step=3, max_steps=12, block_size=128)


class TestEnv:
    def test_reset_shapes(self, key):
        p = _problem()
        state, obs = env_mod.reset(p, CFG, key)
        assert obs.shape == (8, env_mod.OBS_DIM)
        assert state.spins.shape == (8, p.n_padded)
        assert np.all(np.isfinite(np.asarray(obs)))

    def test_step_advances_and_rewards(self, key):
        p = _problem()
        state, obs = env_mod.reset(p, CFG, key)
        action = jnp.zeros((8,), jnp.int32)  # strongest cooling
        k2 = jax.random.key(1)
        state2, obs2, reward, done = env_mod.step(p, CFG, state, action, k2)
        assert np.all(np.asarray(state2.step) == 1)
        assert reward.shape == (8,)
        assert np.all(np.isfinite(np.asarray(reward)))
        # temperature multiplied by 0.5 (action 0)
        np.testing.assert_allclose(np.asarray(state2.temp),
                                   np.asarray(state.temp) * 0.5, rtol=1e-6)

    def test_energy_tracking_consistent(self, key):
        from spinglass_tpu.core import energy as E
        p = _problem()
        state, _ = env_mod.reset(p, CFG, key)
        state2, _, _, _ = env_mod.step(p, CFG, state, jnp.full((8,), 5), key)
        np.testing.assert_allclose(
            np.asarray(state2.energy),
            np.asarray(E.energy(p, state2.spins)), rtol=1e-4, atol=1e-3)
        assert np.all(np.asarray(state2.best_energy)
                      <= np.asarray(state2.energy) + 1e-5)

    def test_done_at_max_steps(self, key):
        p = _problem()
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=3,
                        plateau_patience=1000)
        state, _ = env_mod.reset(p, cfg, key)
        for i in range(3):
            state, _, _, done = env_mod.step(
                p, cfg, state, jnp.full((4,), 5), jax.random.key(i))
        assert np.all(np.asarray(done))

    def test_auto_reset_restores_done_envs(self, key):
        p = _problem()
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=1,
                        plateau_patience=1000)
        state, _ = env_mod.reset(p, cfg, key)
        state, _, _, done = env_mod.step(p, cfg, state, jnp.full((4,), 5),
                                         jax.random.key(1))
        assert np.all(np.asarray(done))
        state2, obs = env_mod.auto_reset(p, cfg, state, jax.random.key(2))
        assert np.all(np.asarray(state2.step) == 0)
        assert not np.any(np.asarray(state2.done))

    def test_continuous_action_mode(self, key):
        p = _problem()
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=5,
                        action_mode="continuous")
        state, _ = env_mod.reset(p, cfg, key)
        action = jnp.tile(jnp.asarray([[1.5, 0.5]]), (4, 1))
        state2, _, r, _ = env_mod.step(p, cfg, state, action, key)
        np.testing.assert_allclose(np.asarray(state2.temp),
                                   np.asarray(state.temp) * 1.5, rtol=1e-6)


class TestRewards:
    def test_energy_improvement_rewarded(self):
        cfg = rew_mod.RewardConfig(acceptance_weight=0.0,
                                   convergence_weight=0.0,
                                   efficiency_weight=0.0)
        st = rew_mod.init_state(cfg, 2)
        args = dict(best_energy=jnp.zeros(2), initial_energy=-jnp.ones(2),
                    acc_rate=jnp.full((2,), 0.44), temp=jnp.ones(2),
                    step=jnp.ones((2,), jnp.int32), max_steps=10,
                    improved=jnp.zeros(2, bool))
        r_up, _ = rew_mod.compute(cfg, st, energy=jnp.asarray([-5.0, -5.0]),
                                  prev_energy=jnp.asarray([0.0, 0.0]), **args)
        r_down, _ = rew_mod.compute(cfg, st, energy=jnp.asarray([5.0, 5.0]),
                                    prev_energy=jnp.asarray([0.0, 0.0]), **args)
        assert np.all(np.asarray(r_up) > 0)
        assert np.all(np.asarray(r_down) < 0)

    def test_acceptance_target(self):
        cfg = rew_mod.RewardConfig(energy_weight=0.0, convergence_weight=0.0,
                                   efficiency_weight=0.0)
        st = rew_mod.init_state(cfg, 1)
        base = dict(energy=jnp.zeros(1), prev_energy=jnp.zeros(1),
                    best_energy=jnp.zeros(1), initial_energy=jnp.ones(1),
                    temp=jnp.ones(1), step=jnp.ones((1,), jnp.int32),
                    max_steps=10, improved=jnp.zeros(1, bool))
        r_good, _ = rew_mod.compute(cfg, st, acc_rate=jnp.asarray([0.44]),
                                    **base)
        r_bad, _ = rew_mod.compute(cfg, st, acc_rate=jnp.asarray([0.9]),
                                   **base)
        assert float(r_good[0]) > float(r_bad[0])

    def test_reward_clipping(self):
        cfg = rew_mod.RewardConfig(clip=1.0)
        st = rew_mod.init_state(cfg, 1)
        r, _ = rew_mod.compute(
            cfg, st, energy=jnp.asarray([-1e6]), prev_energy=jnp.zeros(1),
            best_energy=jnp.zeros(1), initial_energy=jnp.ones(1),
            acc_rate=jnp.asarray([0.44]), temp=jnp.ones(1),
            step=jnp.ones((1,), jnp.int32), max_steps=10,
            improved=jnp.ones(1, bool))
        assert abs(float(r[0])) <= 1.0


class TestPPO:
    def test_update_runs_and_improves_energy(self):
        p = _problem(16, seed=1)
        cfg = ppo_mod.PPOConfig(rollout_len=4, n_epochs=2, n_minibatches=2,
                                n_updates=3, hidden_sizes=(32,))
        init_fn, update_fn, model = ppo_mod.make_ppo(p, CFG, cfg)
        state = init_fn()
        metrics = None
        for _ in range(3):
            state, metrics = update_fn(state)
        assert np.isfinite(float(metrics["policy_loss"]))
        assert np.isfinite(float(metrics["mean_reward"]))
        assert np.isfinite(float(metrics["mean_best_energy"]))

    def test_params_change(self):
        p = _problem(16)
        cfg = ppo_mod.PPOConfig(rollout_len=4, n_epochs=1, n_minibatches=1,
                                hidden_sizes=(16,))
        init_fn, update_fn, _ = ppo_mod.make_ppo(p, CFG, cfg)
        state = init_fn()
        before = jax.tree.map(lambda x: np.asarray(x).copy(), state.params)
        state, _ = update_fn(state)
        changed = jax.tree.map(
            lambda a, b: not np.allclose(a, np.asarray(b)), before,
            state.params)
        assert any(jax.tree.leaves(changed))


class TestDQN:
    def test_buffer_ring_semantics(self):
        buf = dqn_mod.ReplayBuffer.create(4, 2)
        obs = jnp.ones((3, 2))
        buf = buf.push_batch(obs, jnp.zeros((3,), jnp.int32),
                             jnp.ones((3,)), obs, jnp.zeros((3,), bool))
        assert int(buf.size) == 3 and int(buf.ptr) == 3
        buf = buf.push_batch(obs * 2, jnp.ones((3,), jnp.int32),
                             jnp.ones((3,)), obs, jnp.zeros((3,), bool))
        assert int(buf.size) == 4 and int(buf.ptr) == 2  # wrapped

    def test_act_and_learn_step(self):
        p = _problem(16)
        cfg = dqn_mod.DQNConfig(hidden_sizes=(16,), batch_size=8,
                                buffer_size=64)
        init_fn, step_fn, model = dqn_mod.make_dqn(p, CFG, cfg)
        state = init_fn()
        for _ in range(3):
            state, m = step_fn(state)
        assert np.isfinite(float(m["loss"]))
        assert 0.05 <= float(m["annealing_weight"]) <= 0.95
        assert int(state.buffer.size) == 24  # 3 steps x 8 envs

    def test_heuristic_action_logic(self):
        obs = np.zeros((2, env_mod.OBS_DIM), np.float32)
        obs[0, 8] = 0.9   # plateau → reheat (action 8)
        obs[1, 4] = 0.7   # high acceptance → freeze (action 1)
        a = dqn_mod.heuristic_action(jnp.asarray(obs))
        assert a[0] == 8 and a[1] == 1

    def test_params_save_load_roundtrip(self, tmp_path):
        p = _problem(16)
        init_fn, _, _ = dqn_mod.make_dqn(p, CFG, dqn_mod.DQNConfig(
            hidden_sizes=(8,)))
        state = init_fn()
        path = str(tmp_path / "params.npz")
        dqn_mod.save_params(state.params, path)
        loaded = dqn_mod.load_params(state.params, path)
        chex_equal = jax.tree.map(
            lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
            state.params, loaded)
        assert all(jax.tree.leaves(chex_equal))


class TestPipeline:
    def test_ppo_pipeline_smoke(self, tmp_path):
        pipe = RLTrainingPipeline(
            TrainingConfig(agent="ppo", n_updates=2, checkpoint_interval=1,
                           checkpoint_dir=str(tmp_path)),
            env_cfg=EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=6),
            ppo_cfg=ppo_mod.PPOConfig(rollout_len=3, n_epochs=1,
                                      n_minibatches=1, hidden_sizes=(16,)),
            problem=_problem(16))
        out = pipe.train()
        assert out["env_steps_per_second"] > 0
        assert len(out["metrics"]) == 2
        import os
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path))

    def test_dqn_pipeline_smoke(self):
        pipe = RLTrainingPipeline(
            TrainingConfig(agent="dqn", n_updates=2),
            env_cfg=EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=6),
            dqn_cfg=dqn_mod.DQNConfig(hidden_sizes=(8,), batch_size=4,
                                      buffer_size=32),
            problem=_problem(16))
        out = pipe.train()
        assert len(out["metrics"]) == 2


class TestPrioritizedReplay:
    """PER parity with the reference PrioritizedReplayBuffer
    (training_pipeline.py:82-133): proportional sampling, IS weights,
    priority updates, and an end-to-end DQN step with PER enabled."""

    def test_sampling_prefers_high_priority(self):
        import jax

        buf = dqn_mod.PrioritizedReplayBuffer.create(8, 2)
        obs = jnp.arange(16, dtype=jnp.float32).reshape(8, 2)
        buf = buf.push_batch(obs, jnp.arange(8, dtype=jnp.int32),
                             jnp.zeros(8), obs, jnp.zeros(8, bool))
        # concentrate priority on slot 3
        pr = jnp.full((8,), 1e-3).at[3].set(100.0)
        buf = buf.replace(priority=pr)
        _, idx, w = buf.sample(jax.random.key(0), 256, alpha=1.0, beta=0.4)
        frac3 = float(jnp.mean((idx == 3).astype(jnp.float32)))
        assert frac3 > 0.9
        # rare (low-priority) samples get the LARGER importance weight
        if bool(jnp.any(idx != 3)):
            w_rare = float(jnp.max(jnp.where(idx != 3, w, 0.0)))
            w_common = float(jnp.max(jnp.where(idx == 3, w, 0.0)))
            assert w_rare >= w_common
        assert float(jnp.max(w)) <= 1.0 + 1e-6

    def test_update_priorities(self):
        buf = dqn_mod.PrioritizedReplayBuffer.create(4, 2)
        obs = jnp.zeros((4, 2))
        buf = buf.push_batch(obs, jnp.zeros(4, jnp.int32), jnp.zeros(4),
                             obs, jnp.zeros(4, bool))
        buf = buf.update_priorities(jnp.array([1, 2]),
                                    jnp.array([5.0, 0.5]), eps=1e-3)
        assert abs(float(buf.priority[1]) - 5.001) < 1e-5
        assert abs(float(buf.priority[2]) - 0.501) < 1e-5

    def test_new_transitions_get_max_priority(self):
        buf = dqn_mod.PrioritizedReplayBuffer.create(8, 2)
        obs = jnp.zeros((2, 2))
        buf = buf.push_batch(obs, jnp.zeros(2, jnp.int32), jnp.zeros(2),
                             obs, jnp.zeros(2, bool))
        buf = buf.update_priorities(jnp.array([0]), jnp.array([7.0]), 0.0)
        buf = buf.push_batch(obs, jnp.zeros(2, jnp.int32), jnp.zeros(2),
                             obs, jnp.zeros(2, bool))
        assert float(buf.priority[2]) == 7.0

    def test_dqn_step_with_per(self):
        import jax

        problem = _problem(16)
        env_cfg = env_mod.EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
        cfg = dqn_mod.DQNConfig(buffer_size=64, batch_size=16,
                                prioritized_replay=True)
        init_fn, step_fn, _ = dqn_mod.make_dqn(problem, env_cfg, cfg)
        state = init_fn(jax.random.key(0))
        for _ in range(3):
            state, metrics = step_fn(state)
        assert np.isfinite(float(metrics["loss"]))
        # priorities were refreshed by the TD errors of sampled transitions
        assert float(jnp.max(state.buffer.priority)) > 0.0


class TestContinuousHybridPPO:
    """Continuous/hybrid policy heads (reference environment.py:88-113 Box/
    Dict action spaces)."""

    def test_continuous_ppo_trains(self):
        p = _problem()
        env_cfg = EnvConfig(n_envs=8, sweeps_per_step=2, max_steps=10,
                            action_mode="continuous")
        cfg = ppo_mod.PPOConfig(rollout_len=4, n_epochs=1, n_minibatches=2,
                                n_updates=2, hidden_sizes=(32,))
        init_fn, update_fn, model = ppo_mod.make_ppo(p, env_cfg, cfg)
        state = init_fn()
        p0 = jax.tree.leaves(state.params)[0]
        state, m = update_fn(state)
        state, m = update_fn(state)
        assert np.isfinite(float(m["mean_reward"]))
        assert np.isfinite(float(m["entropy"]))
        p1 = jax.tree.leaves(state.params)[0]
        assert not np.allclose(np.asarray(p0), np.asarray(p1))

    def test_continuous_actions_in_range(self, key):
        env_cfg = EnvConfig(n_envs=8, action_mode="continuous")
        model = ppo_mod.ActorCritic(action_mode="continuous",
                                    hidden_sizes=(16,))
        obs = jnp.zeros((8, env_mod.OBS_DIM))
        params = model.init(key, obs)
        dist, value = model.apply(params, obs)
        # means squashed into the env's valid box
        assert float(dist["mean"][..., 0].min()) >= 0.5
        assert float(dist["mean"][..., 0].max()) <= 2.0
        assert float(dist["mean"][..., 1].min()) >= 0.1
        assert float(dist["mean"][..., 1].max()) <= 1.0
        assert value.shape == (8,)

    def test_hybrid_ppo_trains(self):
        p = _problem()
        env_cfg = EnvConfig(n_envs=8, sweeps_per_step=2, max_steps=10,
                            action_mode="hybrid")
        cfg = ppo_mod.PPOConfig(rollout_len=4, n_epochs=1, n_minibatches=2,
                                n_updates=2, hidden_sizes=(32,))
        init_fn, update_fn, model = ppo_mod.make_ppo(p, env_cfg, cfg)
        state = init_fn()
        state, m = update_fn(state)
        assert np.isfinite(float(m["mean_reward"]))

    def test_policy_logprob_matches_sampling(self, key):
        """log_prob(sample) is finite and self-consistent for every mode."""
        for mode in ("discrete", "continuous", "hybrid"):
            model = ppo_mod.ActorCritic(action_mode=mode, hidden_sizes=(16,))
            obs = jax.random.normal(key, (6, env_mod.OBS_DIM))
            params = model.init(key, obs)
            dist, _ = model.apply(params, obs)
            sample, log_prob, entropy = ppo_mod.make_policy(mode)
            a = sample(dist, key)
            lp = log_prob(dist, a)
            assert lp.shape == (6,)
            assert np.all(np.isfinite(np.asarray(lp)))
            assert np.all(np.isfinite(np.asarray(entropy(dist))))


class TestEngineEnv:
    """Engine-plumbed env: the hot path goes through
    make_engine; the blocked XLA engine reproduces the legacy path."""

    def test_engine_env_matches_legacy_blocked(self, key):
        from spinglass_tpu.anneal.engines import BlockedEngine

        p = _problem()
        eng = BlockedEngine(p, block_size=CFG.block_size)
        k1, k2 = jax.random.split(key)
        s_legacy, o_legacy = env_mod.reset(p, CFG, k1)
        s_eng, o_eng = env_mod.reset(p, CFG, k1, eng)
        np.testing.assert_allclose(np.asarray(o_legacy), np.asarray(o_eng),
                                   rtol=1e-5, atol=1e-5)
        action = jnp.full((CFG.n_envs,), 3)
        s1, o1, r1, d1 = env_mod.step(p, CFG, s_legacy, action, k2)
        s2, o2, r2, d2 = env_mod.step(p, CFG, s_eng, action, k2, eng)
        np.testing.assert_array_equal(np.asarray(s1.spins),
                                      np.asarray(s2.spins))
        np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                                   rtol=1e-4, atol=1e-4)

    def test_rl_over_sparse_ellproblem(self, key):
        """PPO trains against a sparse EllProblem through the sorted sparse
        engine (reference capability: RL over 10k+ instances; scaled down
        for CPU CI)."""
        from spinglass_tpu.kernels.sparse import EllProblem

        coo = topology.sparse_random_graph_coo(200, avg_degree=5.0,
                                               dist="gaussian", seed=11)
        ell = EllProblem.from_coo(200, *coo)
        env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
        cfg = ppo_mod.PPOConfig(rollout_len=3, n_epochs=1, n_minibatches=2,
                                n_updates=1, hidden_sizes=(16,))
        init_fn, update_fn, model = ppo_mod.make_ppo(ell, env_cfg, cfg)
        state = init_fn()
        e0 = float(jnp.mean(state.env_state.energy))
        state, m = update_fn(state)
        assert np.isfinite(float(m["mean_reward"]))
        # the annealer-env actually anneals the sparse problem
        assert float(m["mean_best_energy"]) < e0


class TestRewardComponents:
    """New reward components (reference reward_shaping.py:123-186,
    253-344)."""

    def _state(self, b=4):
        return rew_mod.init_state(rew_mod.RewardConfig(), b)

    def _compute(self, cfg, state, **over):
        b = state.de_scale.shape[0]
        kw = dict(energy=jnp.full((b,), -10.0),
                  prev_energy=jnp.full((b,), -10.0),
                  best_energy=jnp.full((b,), -10.0),
                  initial_energy=jnp.full((b,), -5.0),
                  acc_rate=jnp.full((b,), 0.44),
                  temp=jnp.full((b,), 5.0),
                  step=jnp.full((b,), 1, jnp.int32), max_steps=10,
                  improved=jnp.zeros((b,), bool),
                  mult=jnp.ones((b,)),
                  episode=jnp.zeros((b,), jnp.int32))
        kw.update(over)
        return rew_mod.compute(cfg, state, **kw)

    def test_rapid_temp_change_penalized(self):
        cfg = rew_mod.RewardConfig(energy_weight=0.0, acceptance_weight=0.0,
                                   exploration_weight=0.0,
                                   convergence_weight=0.0,
                                   efficiency_weight=0.0,
                                   temperature_weight=1.0)
        st = self._state()
        # establish prev_temp = 5
        _, st = self._compute(cfg, st, temp=jnp.full((4,), 5.0))
        r_stable, _ = self._compute(cfg, st, temp=jnp.full((4,), 5.5))
        r_rapid, _ = self._compute(cfg, st, temp=jnp.full((4,), 20.0))
        assert float(r_rapid[0]) < float(r_stable[0])

    def test_schedule_conformance_rewarded(self):
        cfg = rew_mod.RewardConfig(energy_weight=0.0, acceptance_weight=0.0,
                                   exploration_weight=0.0,
                                   convergence_weight=0.0,
                                   efficiency_weight=0.0,
                                   temperature_weight=1.0)
        st = self._state()
        # at progress 0.1 the expected schedule temp is ~9; conforming beats
        # far-off temps
        _, st1 = self._compute(cfg, st, temp=jnp.full((4,), 9.0))
        r_conform, _ = self._compute(cfg, st1, temp=jnp.full((4,), 9.0))
        _, st2 = self._compute(cfg, st, temp=jnp.full((4,), 0.5))
        r_off, _ = self._compute(cfg, st2, temp=jnp.full((4,), 0.5))
        assert float(r_conform[0]) > float(r_off[0])

    def test_novelty_bonus_once_per_signature(self):
        cfg = rew_mod.RewardConfig(energy_weight=0.0, acceptance_weight=0.0,
                                   temperature_weight=0.0,
                                   convergence_weight=0.0,
                                   efficiency_weight=0.0,
                                   exploration_weight=1.0)
        st = self._state()
        r1, st = self._compute(cfg, st)
        r2, st = self._compute(cfg, st)   # same signature again
        assert float(r1[0]) > 0.5         # first visit: bonus ~ scale
        assert float(r2[0]) < 1e-6        # repeat visit: no bonus
        r3, st = self._compute(cfg, st, temp=jnp.full((4,), 0.2))
        assert float(r3[0]) > 0.5         # new signature: bonus again

    def test_curriculum_scales_with_episodes(self):
        cfg = rew_mod.RewardConfig(acceptance_weight=0.0,
                                   temperature_weight=0.0,
                                   exploration_weight=0.0,
                                   convergence_weight=0.0,
                                   efficiency_weight=0.0,
                                   curriculum=True, curriculum_stages=5,
                                   difficulty_ramp=1.0)
        st = self._state()
        good = dict(energy=jnp.full((4,), -11.0),
                    prev_energy=jnp.full((4,), -10.0))
        r_ep0, _ = self._compute(cfg, st, episode=jnp.zeros((4,), jnp.int32),
                                 **good)
        r_ep999, _ = self._compute(
            cfg, st, episode=jnp.full((4,), 999, jnp.int32), **good)
        assert float(r_ep999[0]) > float(r_ep0[0]) * 1.5

    def test_hybrid_action_decoding(self, key):
        p = _problem()
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8,
                        action_mode="hybrid")
        state, obs = env_mod.reset(p, cfg, key)
        action = {"temp_index": jnp.full((4,), 9, jnp.int32),
                  "sweep_frac": jnp.full((4,), 0.5)}
        s2, o2, r, d = env_mod.step(p, cfg, state, action, key)
        # multiplier 2.0 applied
        np.testing.assert_allclose(np.asarray(s2.temp),
                                   np.asarray(state.temp) * 2.0, rtol=1e-6)

    def test_episode_counter_increments_on_done(self, key):
        p = _problem()
        cfg = EnvConfig(n_envs=4, sweeps_per_step=1, max_steps=2)
        state, _ = env_mod.reset(p, cfg, key)
        for i in range(2):
            state, _, _, done = env_mod.step(
                p, cfg, state, jnp.full((4,), 5), jax.random.fold_in(key, i))
        assert bool(jnp.all(state.done))
        state, _ = env_mod.auto_reset(p, cfg, state, key)
        np.testing.assert_array_equal(np.asarray(state.episode),
                                      np.ones(4, np.int32))
        np.testing.assert_array_equal(np.asarray(state.step),
                                      np.zeros(4, np.int32))


class TestRLCheckpointResume:
    def test_pipeline_resume_continues(self, tmp_path):
        """Kill-and-resume on the PPO pipeline: the resumed run picks up at
        the saved update index with the full TrainState (reference
        training_pipeline.py:437-507)."""
        d = str(tmp_path / "rl_ckpt")
        p = _problem()
        env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
        ppo_cfg = ppo_mod.PPOConfig(rollout_len=2, n_epochs=1,
                                    n_minibatches=1, hidden_sizes=(16,))
        cfg = TrainingConfig(agent="ppo", n_updates=4, checkpoint_interval=2,
                             checkpoint_dir=d, seed=3)
        pipe = RLTrainingPipeline(cfg, env_cfg, ppo_cfg, problem=p)
        out_full = pipe.train()
        assert len(pipe.metrics) == 4

        # resumed pipeline starts after the last saved update (update 3,
        # saved at (3+1) % 2 == 0) and so trains 0 further updates; with the
        # mid checkpoint deleted it would continue from update 1.
        import os
        pipe2 = RLTrainingPipeline(
            TrainingConfig(agent="ppo", n_updates=4, checkpoint_interval=2,
                           checkpoint_dir=d, seed=3, resume=True),
            env_cfg, ppo_cfg, problem=p)
        out2 = pipe2.train()
        assert len(pipe2.metrics) == 0  # nothing left to do
        # params preserved through resume
        for a, b in zip(jax.tree.leaves(out_full["params"]),
                        jax.tree.leaves(out2["params"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestSpinsObsMode:
    """obs_mode="spins": spin values + the 16 globals (reference
    environment.py:115-154's observation space)."""

    def test_obs_width_and_masking(self, key):
        p = _problem(n=24)
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8,
                        obs_mode="spins")
        assert env_mod.obs_dim(p, cfg) == p.n_padded + env_mod.OBS_DIM
        state, obs = env_mod.reset(p, cfg, key)
        assert obs.shape == (4, p.n_padded + env_mod.OBS_DIM)
        spins_part = np.asarray(obs[:, :p.n_padded])
        # active slots carry +-1 spins, padding slots are zeroed
        assert set(np.unique(spins_part[:, :p.n_spins])) <= {-1.0, 1.0}
        assert np.all(spins_part[:, p.n_spins:] == 0.0)
        # spins in the obs are the state's spins
        np.testing.assert_array_equal(
            spins_part[:, :p.n_spins],
            np.asarray(state.spins, np.float32)[:, :p.n_spins])
        # the trailing 16 features match the global-mode observation
        glob = env_mod.observe(
            p, EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8), state)
        np.testing.assert_array_equal(np.asarray(obs[:, p.n_padded:]),
                                      np.asarray(glob))

    def test_obs_mode_validated(self, key):
        p = _problem()
        with pytest.raises(ValueError, match="obs_mode"):
            env_mod.obs_dim(p, EnvConfig(obs_mode="bogus"))

    def test_step_and_auto_reset_keep_width(self, key):
        p = _problem(n=24)
        cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=3,
                        obs_mode="spins")
        state, obs = env_mod.reset(p, cfg, key)
        for i in range(4):
            state, obs, r, done = env_mod.step(
                p, cfg, state, jnp.zeros((4,), jnp.int32), jax.random.key(i))
            state, obs = env_mod.auto_reset(p, cfg, state, jax.random.key(99))
            assert obs.shape == (4, p.n_padded + env_mod.OBS_DIM)
            assert np.all(np.isfinite(np.asarray(obs)))

    def test_ppo_trains_on_spins_obs(self):
        """PPO sizes its input layer from the wider obs and trains on a
        64-spin problem."""
        p = _problem(n=64, seed=1)
        env_cfg = EnvConfig(n_envs=8, sweeps_per_step=3, max_steps=10,
                            obs_mode="spins")
        cfg = ppo_mod.PPOConfig(n_updates=3, rollout_len=4, n_epochs=1,
                                n_minibatches=2, hidden_sizes=(32,), seed=0)
        out = ppo_mod.train(p, env_cfg, cfg)
        assert len(out["history"]) == 3
        assert np.isfinite(out["final_mean_best_energy"])
        # first Dense layer consumed the widened observation
        first_kernel = out["params"]["mlp"]["hidden"][0]["w"]
        assert first_kernel.shape[0] == env_mod.obs_dim(p, env_cfg)

    def test_dqn_buffer_sized_for_spins_obs(self):
        p = _problem(n=24)
        env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8,
                            obs_mode="spins")
        cfg = dqn_mod.DQNConfig(buffer_size=32, batch_size=4,
                                hidden_sizes=(16,), seed=0)
        init_fn, step_fn, _model = dqn_mod.make_dqn(p, env_cfg, cfg)
        st = init_fn()
        assert st.buffer.obs.shape[1] == env_mod.obs_dim(p, env_cfg)
        st, m = step_fn(st)
        assert np.all(np.isfinite(np.asarray(st.obs)))


class TestUpdatesPerDispatchParity:
    def test_history_parity_with_remainder(self):
        """updates_per_dispatch>1 (lax.scan over the raw update body) must
        reproduce the kd=1 history exactly, including when n_updates % kd
        != 0 (remainder singles run first)."""
        p = _problem(n=16, seed=2)
        env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
        base = dict(n_updates=5, rollout_len=3, n_epochs=1, n_minibatches=1,
                    hidden_sizes=(16,), seed=5)
        out1 = ppo_mod.train(p, env_cfg,
                             ppo_mod.PPOConfig(**base, updates_per_dispatch=1))
        out3 = ppo_mod.train(p, env_cfg,
                             ppo_mod.PPOConfig(**base, updates_per_dispatch=3))
        assert len(out1["history"]) == len(out3["history"]) == 5
        for h1, h3 in zip(out1["history"], out3["history"]):
            assert h1.keys() == h3.keys()
            for k in h1:
                np.testing.assert_allclose(h1[k], h3[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


class TestDQNStepsPerDispatch:
    @pytest.mark.slow  # two pipeline compiles ~19 s; the shared scan
    # mechanism is covered non-slow by TestUpdatesPerDispatchParity (PPO)
    def test_history_parity(self):
        """DQNConfig.steps_per_dispatch>1 (scan over the raw act+learn
        body, the PPO updates_per_dispatch analog) must reproduce the
        kd=1 metric history exactly, including a non-divisible tail."""
        p = _problem(n=16, seed=2)
        env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
        base = dict(buffer_size=32, batch_size=8, hidden_sizes=(8,), seed=3)
        outs = []
        for kd in (1, 2):
            cfg = TrainingConfig(agent="dqn", n_updates=3, seed=3)
            pipe = RLTrainingPipeline(
                cfg, env_cfg,
                dqn_cfg=dqn_mod.DQNConfig(**base, steps_per_dispatch=kd),
                problem=p)
            pipe.train()
            outs.append(pipe.metrics)
        assert len(outs[0]) == len(outs[1]) == 3
        for m1, m2 in zip(outs[0], outs[1]):
            assert m1.keys() == m2.keys()
            for k in m1:
                np.testing.assert_allclose(m1[k], m2[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
