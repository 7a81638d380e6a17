from .budgets import BudgetTracker, allowed_disruptions, budget_limit
from .controller import (
    OUTCOME_DISRUPTED,
    OUTCOME_INVALIDATED,
    OUTCOME_LAUNCH_FAILED,
    OUTCOME_REPLACEMENT_TIMED_OUT,
    OUTCOME_REPLACEMENT_VANISHED,
    DisruptionController,
)
from .eligibility import PDBLimits, pod_ineligible_reason
from .methods import (
    METHOD_CONSOLIDATION,
    METHOD_DRIFT,
    METHOD_EMPTINESS,
    METHOD_EXPIRATION,
    DisruptionCommand,
    DriftMethod,
    EmptinessMethod,
    ExpirationMethod,
)

__all__ = [
    "BudgetTracker",
    "DisruptionCommand",
    "DisruptionController",
    "DriftMethod",
    "EmptinessMethod",
    "ExpirationMethod",
    "METHOD_CONSOLIDATION",
    "METHOD_DRIFT",
    "METHOD_EMPTINESS",
    "METHOD_EXPIRATION",
    "OUTCOME_DISRUPTED",
    "OUTCOME_INVALIDATED",
    "OUTCOME_LAUNCH_FAILED",
    "OUTCOME_REPLACEMENT_TIMED_OUT",
    "OUTCOME_REPLACEMENT_VANISHED",
    "PDBLimits",
    "allowed_disruptions",
    "budget_limit",
    "pod_ineligible_reason",
]
