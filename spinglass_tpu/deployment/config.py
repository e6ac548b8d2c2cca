"""Production configuration: env-layered dataclasses.

Rebuilds deployment/production_config.py:32-447 for this stack: every
field has an env-var override SGT_<SECTION>_<FIELD>, and environment presets
(development / staging / production) adjust logging + safety defaults."""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class Environment(Enum):
    DEVELOPMENT = "development"
    STAGING = "staging"
    PRODUCTION = "production"


def _env_override(prefix: str, cfg):
    for f in dataclasses.fields(cfg):
        var = f"SGT_{prefix}_{f.name}".upper()
        if var in os.environ:
            raw = os.environ[var]
            typ = type(getattr(cfg, f.name))
            if typ is bool:
                value = raw.lower() in ("1", "true", "yes")
            elif typ in (int, float):
                value = typ(raw)
            else:
                value = raw
            object.__setattr__(cfg, f.name, value)
    return cfg


@dataclass
class ComputeConfig:
    platform: str = "gpu"             # gpu | cpu
    n_replicas: int = 256
    block_size: int = 128
    use_pallas: str = "auto"
    mesh_axes: str = "replica"        # comma-separated


@dataclass
class ServiceConfig:
    max_problem_spins: int = 200_000
    request_timeout_s: float = 300.0
    validation_level: str = "standard"
    audit_log_path: str = "/var/log/sgt/audit.jsonl"


@dataclass
class ObservabilityConfig:
    log_level: str = "INFO"
    log_json: bool = True
    metrics_interval_s: float = 15.0
    health_port: int = 8080
    profile_dir: str = ""


@dataclass
class CheckpointingConfig:
    directory: str = "/var/lib/sgt/checkpoints"
    every_n: int = 100
    keep: int = 5


@dataclass
class ProductionConfig:
    environment: Environment = Environment.DEVELOPMENT
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    checkpointing: CheckpointingConfig = field(
        default_factory=CheckpointingConfig)

    @staticmethod
    def from_environment(env: Optional[str] = None) -> "ProductionConfig":
        env_name = (env or os.environ.get("SGT_ENVIRONMENT",
                                          "development")).lower()
        cfg = ProductionConfig(environment=Environment(env_name))
        if cfg.environment == Environment.PRODUCTION:
            cfg.observability.log_level = "WARNING"
            cfg.service.validation_level = "strict"
        elif cfg.environment == Environment.STAGING:
            cfg.service.validation_level = "standard"
        else:
            cfg.observability.log_json = False
        _env_override("compute", cfg.compute)
        _env_override("service", cfg.service)
        _env_override("observability", cfg.observability)
        _env_override("checkpointing", cfg.checkpointing)
        return cfg

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["environment"] = self.environment.value
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
