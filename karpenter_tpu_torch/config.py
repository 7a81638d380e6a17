"""Global configuration (pkg/config): the batch window's durations.

The port's copy of karpenter_tpu/config.py, cut to what the provisioning
round reads. The live ConfigMap watch, duration parsing and the log level
come with the port's Runtime (ROADMAP A9).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_BATCH_MAX_DURATION = 10.0
DEFAULT_BATCH_IDLE_DURATION = 1.0


@dataclass
class Config:
    batch_max_duration: float = DEFAULT_BATCH_MAX_DURATION
    batch_idle_duration: float = DEFAULT_BATCH_IDLE_DURATION
