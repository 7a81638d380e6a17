"""Interruption message taxonomy: parse queue payloads into typed messages.

The analog of the reference's pkg/cloudprovider/aws/controllers/interruption
message unmarshalling (spot interruption warning / rebalance recommendation /
scheduled change / state change), with the same stance: a payload that does
not parse is a PARSE ERROR the controller counts and leaves on the queue to
dead-letter — a poison message must never crash the poll loop or be silently
dropped before the redrive policy has recorded it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# action the controller takes per kind (the Action taxonomy of the
# reference's interruption controller)
ACTION_CORDON_AND_DRAIN = "cordon_and_drain"
ACTION_CORDON = "cordon"
ACTION_GARBAGE_COLLECT = "garbage_collect"
ACTION_NO_OP = "no_op"


class MessageParseError(ValueError):
    """The payload is not a well-formed interruption message."""


@dataclass(frozen=True)
class InterruptionMessage:
    kind: str
    instance_id: str
    # absolute sim-time the capacity disappears (spot_interruption only)
    deadline: Optional[float] = None
    # earliest maintenance start (scheduled_maintenance only)
    not_before: Optional[float] = None

    def action(self) -> str:
        """What the controller does about this message:
        - spot_interruption / scheduled_maintenance: proactively re-solve,
          cordon + taint, and hand the node to the termination controller
          (the capacity WILL go away; beat the deadline);
        - rebalance_recommendation: cordon only — elevated risk, no
          guaranteed reclaim, so stop new placements without evicting;
        - instance_stopped / instance_terminated: the capacity is ALREADY
          gone — garbage-collect the node immediately.
        """
        if self.kind in ("spot_interruption", "scheduled_maintenance"):
            return ACTION_CORDON_AND_DRAIN
        if self.kind == "rebalance_recommendation":
            return ACTION_CORDON
        if self.kind in ("instance_stopped", "instance_terminated"):
            return ACTION_GARBAGE_COLLECT
        return ACTION_NO_OP


KINDS = (
    "spot_interruption",
    "rebalance_recommendation",
    "scheduled_maintenance",
    "instance_stopped",
    "instance_terminated",
)


def parse(body: object) -> InterruptionMessage:
    """Parse a queue payload; raises MessageParseError on anything that is
    not a dict carrying a known kind and a non-empty instance id."""
    if not isinstance(body, dict):
        raise MessageParseError(f"message body must be an object, got {type(body).__name__}")
    kind = body.get("kind")
    if kind not in KINDS:
        raise MessageParseError(f"unknown message kind {kind!r}")
    instance_id = body.get("instance_id")
    if not isinstance(instance_id, str) or not instance_id:
        raise MessageParseError(f"message {kind!r} carries no instance_id")
    deadline = body.get("deadline")
    not_before = body.get("not_before")
    try:
        deadline = float(deadline) if deadline is not None else None
        not_before = float(not_before) if not_before is not None else None
    except (TypeError, ValueError):
        raise MessageParseError(f"non-numeric timestamp in {kind!r} message")
    if kind == "spot_interruption" and deadline is None:
        raise MessageParseError("spot_interruption message carries no deadline")
    return InterruptionMessage(kind=kind, instance_id=instance_id, deadline=deadline, not_before=not_before)
