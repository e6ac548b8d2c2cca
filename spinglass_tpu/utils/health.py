"""Health checks (reference utils/health_checks.py:40-638): system resources,
device compute probe, model validity, micro-anneal, dependency audit."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional


class HealthStatus(Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"


@dataclass
class CheckResult:
    name: str
    status: HealthStatus
    message: str = ""
    duration: float = 0.0
    details: dict = field(default_factory=dict)


def check_system_resources(min_free_mem_gb: float = 0.5) -> CheckResult:
    """Reference SystemResourceCheck (health_checks.py:83-149)."""
    t0 = time.perf_counter()
    try:
        import psutil

        vm = psutil.virtual_memory()
        free_gb = vm.available / 1e9
        status = (HealthStatus.HEALTHY if free_gb >= min_free_mem_gb
                  else HealthStatus.DEGRADED)
        return CheckResult("system_resources", status,
                           f"{free_gb:.1f} GB free host memory",
                           time.perf_counter() - t0,
                           {"free_gb": free_gb, "percent": vm.percent})
    except ImportError:
        return CheckResult("system_resources", HealthStatus.DEGRADED,
                           "psutil unavailable", time.perf_counter() - t0)


def check_device_compute() -> CheckResult:
    """Tiny on-device matmul probe (reference CUDAHealthCheck,
    health_checks.py:150-224)."""
    t0 = time.perf_counter()
    try:
        import jax
        import jax.numpy as jnp

        x = jnp.ones((128, 128))
        y = jnp.matmul(x, x)
        jax.block_until_ready(y)
        ok = bool(jnp.isclose(y[0, 0], 128.0))
        return CheckResult(
            "device_compute",
            HealthStatus.HEALTHY if ok else HealthStatus.UNHEALTHY,
            f"backend={jax.default_backend()} devices={jax.device_count()}",
            time.perf_counter() - t0,
            {"backend": jax.default_backend(),
             "n_devices": jax.device_count()})
    except Exception as e:
        return CheckResult("device_compute", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_model(problem) -> CheckResult:
    """Reference SpinGlassModelCheck (health_checks.py:225-296)."""
    t0 = time.perf_counter()
    try:
        from spinglass_tpu.utils.validation import validate_problem

        validate_problem(problem)
        return CheckResult("model", HealthStatus.HEALTHY,
                           f"{problem.n_spins} spins valid",
                           time.perf_counter() - t0)
    except Exception as e:
        return CheckResult("model", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_annealer() -> CheckResult:
    """Micro-anneal end-to-end (reference AnnealerHealthCheck,
    health_checks.py:297-366)."""
    t0 = time.perf_counter()
    try:
        import numpy as np

        from spinglass_tpu.anneal.sa import SAConfig, anneal
        from spinglass_tpu.core import topology
        from spinglass_tpu.core.problem import IsingProblem

        j = topology.fully_connected(8, dist="ferromagnetic", scale=1.0)
        res = anneal(IsingProblem.from_dense(j),
                     SAConfig(n_sweeps=50, n_replicas=4, use_pallas="never",
                              enable_early_stop=False))
        ok = np.isfinite(res.best_energy) and res.best_energy <= 0
        return CheckResult(
            "annealer", HealthStatus.HEALTHY if ok else HealthStatus.UNHEALTHY,
            f"micro-anneal best={res.best_energy:.2f}",
            time.perf_counter() - t0)
    except Exception as e:
        return CheckResult("annealer", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_dependencies() -> CheckResult:
    """Reference DependencyCheck (health_checks.py:367-431)."""
    t0 = time.perf_counter()
    missing = []
    for mod in ("jax", "optax", "numpy"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    status = HealthStatus.HEALTHY if not missing else HealthStatus.UNHEALTHY
    return CheckResult("dependencies", status,
                       "all present" if not missing else f"missing: {missing}",
                       time.perf_counter() - t0)


DEFAULT_CHECKS: List[Callable[[], CheckResult]] = [
    check_system_resources, check_device_compute, check_annealer,
    check_dependencies,
]


class HealthMonitor:
    """Run all checks, aggregate (reference HealthMonitor,
    health_checks.py:432-560)."""

    def __init__(self, checks: Optional[list] = None):
        self.checks = checks or list(DEFAULT_CHECKS)

    def run(self) -> dict:
        results = [c() for c in self.checks]
        worst = HealthStatus.HEALTHY
        for r in results:
            if r.status == HealthStatus.UNHEALTHY:
                worst = HealthStatus.UNHEALTHY
                break
            if r.status == HealthStatus.DEGRADED:
                worst = HealthStatus.DEGRADED
        return {
            "status": worst.value,
            "checks": {r.name: {"status": r.status.value, "message": r.message,
                                "duration": r.duration} for r in results},
        }
