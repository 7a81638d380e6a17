"""Disruption budgets: per-provisioner voluntary-disruption rate limits.

`spec.disruption.budgets` (api/provisioner.py Budget) caps how many of a
provisioner's nodes may be voluntarily disrupted AT ONCE — across every
method, atomically — the way the reference's NodePool disruption budgets do.
The effective limit at an instant is the MINIMUM across budgets whose window
is active (no schedule == always active); no budgets means unlimited.

`BudgetTracker` is the atomic ledger: a node is charged when its command
starts executing (before any cordon) and released only once the node object
is gone, so "nodes simultaneously disrupted" can never exceed the limit even
while drains are in flight. Involuntary disruption (the interruption
controller) never consults this ledger — capacity loss is not rate-limited.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Set

from ...analysis import WITNESS, guarded_by
from ...api.provisioner import Provisioner, parse_budget_nodes
from ...utils import cron


def budget_limit(budget, total_nodes: int) -> int:
    """Max simultaneous voluntary disruptions one budget allows over a
    provisioner currently holding `total_nodes` nodes. Percentages floor
    (10% of 19 nodes -> 1), matching the reference's intstr math."""
    kind, number = parse_budget_nodes(budget.nodes)
    if kind == "percent":
        return int(math.floor(total_nodes * number / 100.0))
    return number


def allowed_disruptions(provisioner: Provisioner, total_nodes: int, now: float) -> Optional[int]:
    """The provisioner's effective in-flight limit at `now`: the minimum
    across active budgets, or None (unlimited) when no budget applies."""
    disruption = provisioner.spec.disruption
    if disruption is None or not disruption.budgets:
        return None
    limit: Optional[int] = None
    for budget in disruption.budgets:
        if budget.schedule is not None:
            if not cron.window_active(budget.schedule, budget.duration or 0.0, now):
                continue
        try:
            value = budget_limit(budget, total_nodes)
        except ValueError:
            continue  # malformed budgets are rejected at admission; be safe
        limit = value if limit is None else min(limit, value)
    return limit


@guarded_by("_lock", "_charged")
class BudgetTracker:
    """The atomic in-flight ledger, one charge per disrupted node. All
    methods charge through the single disruption orchestrator pass, so the
    check-then-charge is serialized; the lock covers readers on other
    threads (metrics scrapes, tests)."""

    def __init__(self):
        self._lock = WITNESS.lock("disruption.budgets")
        self._charged: Dict[str, Set[str]] = {}  # provisioner -> node names

    def in_flight(self, provisioner_name: str) -> int:
        with self._lock:
            return len(self._charged.get(provisioner_name, ()))

    def provisioners(self) -> list:
        """Provisioner names currently holding charges (locked snapshot)."""
        with self._lock:
            return list(self._charged)

    def charged_nodes(self, provisioner_name: str) -> Set[str]:
        with self._lock:
            return set(self._charged.get(provisioner_name, ()))

    def is_charged(self, provisioner_name: str, node_name: str) -> bool:
        with self._lock:
            return node_name in self._charged.get(provisioner_name, ())

    def try_charge(self, provisioner_name: str, node_name: str, limit: Optional[int]) -> bool:
        """Charge one node against the provisioner's limit; False when the
        budget is exhausted. `limit` None means unlimited. Idempotent for an
        already-charged node."""
        with self._lock:
            charged = self._charged.setdefault(provisioner_name, set())
            if node_name in charged:
                return True
            if limit is not None and len(charged) >= limit:
                return False
            charged.add(node_name)
            return True

    def release(self, provisioner_name: str, node_name: str) -> None:
        with self._lock:
            charged = self._charged.get(provisioner_name)
            if charged is not None:
                charged.discard(node_name)
                if not charged:
                    del self._charged[provisioner_name]

    def total_in_flight(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._charged.values())
