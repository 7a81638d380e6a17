"""The Node edits the port's controllers write through the kube backend's
`retry_on_conflict`, and the log line of a write that no retry landed.

Each edit is a `mutate` for retry_on_conflict: it edits the object it is
given and returns False when that object already holds the result, so it is
idempotent on the fresh object a retry re-reads.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..api.objects import NO_SCHEDULE, Node, Taint
from ..logsetup import get_logger

log = get_logger("controllers")

Edit = Callable[[Node], bool]


def set_annotation(key: str, value: Optional[str]) -> Edit:
    """Set the annotation `key` to `value`, or remove it when `value` is None."""

    def mutate(node: Node) -> bool:
        if node.metadata.annotations.get(key) == value:
            return False
        if value is None:
            del node.metadata.annotations[key]
        else:
            node.metadata.annotations[key] = value
        return True

    return mutate


def cordon(taint_key: Optional[str] = None, retaint: bool = False) -> Edit:
    """Mark the node unschedulable and add the `taint_key` NoSchedule taint
    if it lacks it. A node that is already unschedulable needs no write,
    unless `retaint` and it lacks the taint."""

    def mutate(node: Node) -> bool:
        tainted = taint_key is None or any(t.key == taint_key for t in node.spec.taints)
        if node.spec.unschedulable and (tainted or not retaint):
            return False
        node.spec.unschedulable = True
        if not tainted:
            node.spec.taints.append(Taint(key=taint_key, effect=NO_SCHEDULE))
        return True

    return mutate


def uncordon(node: Node) -> bool:
    """Mark the node schedulable again; a node being deleted stays cordoned."""
    if not node.spec.unschedulable or node.metadata.deletion_timestamp is not None:
        return False
    node.spec.unschedulable = False
    return True


def requeue(owner: str, obj, err: Exception) -> None:
    """Log a write of `obj` that lost to a conflict no retry absorbed
    (ConflictExhausted, or an injected 409 at a verb without a retry). The
    caller leaves the object to its next pass and goes on with the others,
    as controller-runtime requeues a reconcile that returned a conflict."""
    log.warning("%s: %s %s left to the next pass after a write conflict: %s", owner, obj.kind, obj.metadata.name, err)
