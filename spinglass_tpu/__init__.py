"""spinglass_tpu — a spin-glass annealing + RL framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of
``danieleschmidt/spin-glass-anneal-rl`` (see SURVEY.md): combinatorial
problems compile to Ising/QUBO models, batched Monte-Carlo annealers (SA,
parallel tempering) minimize them with matrix-product sweeps, and a PPO/DQN
controller learns temperature schedules over the annealer-as-environment.

Graceful degradation (reference spin_glass_rl/__init__.py:14-67): when JAX is
unavailable, the package still imports and exposes the stdlib-only
MinimalIsingModel/MinimalAnnealer under the main names.
"""

__version__ = "0.1.0"

try:
    import jax as _jax  # noqa: F401

    _HAS_JAX = True
except ImportError:
    _HAS_JAX = False

if _HAS_JAX:
    from spinglass_tpu.core.problem import IsingProblem, random_spins
    from spinglass_tpu.core.energy import (
        energy, local_fields, delta_energy, magnetization,
    )
    from spinglass_tpu.anneal.sa import SAConfig, anneal, anneal_scan
    from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
    from spinglass_tpu.anneal.result import AnnealResult
else:  # stdlib-only fallback tier
    from spinglass_tpu.core.minimal import (  # noqa: F401
        MinimalAnnealer, MinimalIsingModel, create_test_problem,
    )

    IsingModel = MinimalIsingModel
    Annealer = MinimalAnnealer


def get_available_features() -> dict:
    """Feature detection mirroring the reference package root
    (spin_glass_rl/__init__.py:70-88)."""
    if not _HAS_JAX:
        return {
            "backend": "none", "gpu": False, "n_devices": 0,
            "dense_kernel": None, "annealing": "minimal",
            "parallel_tempering": False, "problems": False, "rl": False,
        }
    import jax

    backend = jax.default_backend()
    return {
        "backend": backend,
        "gpu": backend == "gpu",
        "n_devices": jax.device_count(),
        # route of the dense sweep's in-block updates (anneal.engines)
        "dense_kernel": "pallas_triton" if backend == "gpu" else "xla",
        "annealing": True,
        "parallel_tempering": True,
        "problems": True,
        "rl": True,
    }
