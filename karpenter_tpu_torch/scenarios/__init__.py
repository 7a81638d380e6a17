"""Scenario campaign harness: composable load generation + SLO scoring.

See primitives.py (the load/chaos primitives and Scenario composition),
standin.py (the kubelet/scheduler/ReplicaSet stand-in), campaign.py (the
runner emitting scored SCENARIO_*.json on both transports),
chaos_orchestrator.py (the seeded cross-domain chaos schedule, the soak
tier, and the ddmin schedule shrinker), and schema.py (the artifact
validator shared with the tier-1 smoke test).

The port's copy of karpenter_tpu/scenarios/__init__.py.
"""

from .campaign import (
    TRANSPORTS,
    CampaignRunner,
    chaos_soak_scenario,
    default_campaign,
    mini_soak_scenario,
    smoke_campaign,
)
from .chaos_orchestrator import (
    ChaosEvent,
    ChaosSchedule,
    Soak,
    ddmin,
    diurnal_trace,
    replay_failing_schedule,
    shrink_doc,
    shrink_doc_errors,
    shrink_failing_schedule,
    write_shrink,
)
from .primitives import (
    Burst,
    DiurnalRamp,
    DriftRollout,
    LeaseSteal,
    PoolCapacity,
    Primitive,
    ProcessCrash,
    ScaleTo,
    Scenario,
    ScenarioContext,
    SpotReclaimWave,
    TransportChaos,
    WatchGap,
)
from .replay import ReplayTrace
from .schema import scenario_doc_errors
from .standin import WorkloadStandIn, workload_pod

__all__ = [
    "TRANSPORTS",
    "CampaignRunner",
    "chaos_soak_scenario",
    "default_campaign",
    "mini_soak_scenario",
    "smoke_campaign",
    "ChaosEvent",
    "ChaosSchedule",
    "Soak",
    "ddmin",
    "diurnal_trace",
    "replay_failing_schedule",
    "shrink_doc",
    "shrink_doc_errors",
    "shrink_failing_schedule",
    "write_shrink",
    "Burst",
    "DiurnalRamp",
    "DriftRollout",
    "LeaseSteal",
    "PoolCapacity",
    "Primitive",
    "ProcessCrash",
    "ReplayTrace",
    "ScaleTo",
    "Scenario",
    "ScenarioContext",
    "SpotReclaimWave",
    "TransportChaos",
    "WatchGap",
    "scenario_doc_errors",
    "WorkloadStandIn",
    "workload_pod",
]
