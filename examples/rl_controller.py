"""Train a PPO temperature controller over the vectorized annealer-env.

Run: python examples/rl_controller.py [--updates 30] [--platform cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=30)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem
    from spinglass_tpu.rl.env import EnvConfig
    from spinglass_tpu.rl.ppo import PPOConfig, train

    n = 64
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=0)
    out = train(
        IsingProblem.from_dense(j),
        EnvConfig(n_envs=args.envs, sweeps_per_step=5, max_steps=40),
        PPOConfig(n_updates=args.updates, rollout_len=16),
        verbose=True)
    print(f"env-steps/s:       {out['env_steps_per_second']:.0f}")
    print(f"final mean best E: {out['final_mean_best_energy']:.2f}")

    # --- gymnasium interoperability (round 4) ---------------------------
    # the same annealer-environment as a standard gymnasium.Env, for
    # external RL libraries (SB3, CleanRL, ...)
    try:
        from spinglass_tpu.rl.gym_adapter import SpinGlassGymEnv
    except ImportError:
        print("gymnasium not installed; skipping the adapter demo")
        return
    env = SpinGlassGymEnv(IsingProblem.from_dense(j),
                          EnvConfig(n_envs=1, sweeps_per_step=5,
                                    max_steps=10), seed=0)
    obs, info = env.reset(seed=1)
    total = 0.0
    for _ in range(10):
        obs, r, terminated, truncated, info = env.step(
            env.action_space.sample())
        total += r
        if terminated or truncated:
            break
    print(f"gym episode reward {total:.3f}, "
          f"best E {info['best_energy']:.2f}")


if __name__ == "__main__":
    main()
