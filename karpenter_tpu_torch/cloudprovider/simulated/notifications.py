"""NotificationQueue: the SQS-analog interruption feed the backend owns.

The reference's single biggest post-v0.15 robustness feature is the
interruption controller consuming an SQS queue fed by EventBridge rules
(spot interruption warnings, rebalance recommendations, scheduled change
events, instance state changes). This module is that queue for the simulated
cloud, with the same delivery contract a consumer must survive:

  - at-least-once delivery: a received message is INVISIBLE for the
    visibility timeout, then redelivered (receive_count + 1) unless deleted;
  - receipt handles: delete requires the handle of the LATEST receive — a
    stale handle (the message was already redelivered) deletes nothing,
    exactly SQS's ReceiptHandle contract;
  - dead-letter: a message received more than `max_receive_count` times
    moves to the dead-letter list instead of being redelivered (the
    redrive-policy analog), so a poison payload cannot wedge the consumer;
  - long-poll receive: `wait_seconds` blocks on a condition variable until
    a message is visible (arrival wakes the waiter; visibility expiry is
    polled by the deadline math below).

Message taxonomy (messages are plain JSON dicts; the controller-side parser
lives in controllers/interruption/messages.py):

  {"kind": "spot_interruption",        "instance_id": ..., "deadline": <abs sim time>}
  {"kind": "rebalance_recommendation", "instance_id": ...}
  {"kind": "scheduled_maintenance",    "instance_id": ..., "not_before": <abs sim time>}
  {"kind": "instance_stopped",         "instance_id": ...}
  {"kind": "instance_terminated",      "instance_id": ...}

Timestamps are in the owning clock's timeline (the backend's Clock), so
FakeClock suites drive deadline races deterministically.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...analysis import WITNESS, guarded_by

DEFAULT_VISIBILITY_TIMEOUT = 30.0
DEFAULT_MAX_RECEIVE_COUNT = 3
# retention bound (the SQS message-retention-period analog, expressed as a
# depth cap since the sim has no background expiry thread): with no consumer
# configured the backend's lifecycle events would otherwise accumulate one
# entry per instance termination for the life of the process
DEFAULT_MAX_DEPTH = 10_000
# the EC2 spot interruption warning lead time: 2 minutes
SPOT_INTERRUPTION_WARNING = 120.0


@dataclass
class QueueMessage:
    message_id: str
    body: dict
    enqueued_at: float
    receive_count: int = 0
    # invisible until this instant (0 = visible now)
    visible_at: float = 0.0
    receipt_handle: Optional[str] = None  # handle of the latest receive


@dataclass
class ReceivedMessage:
    """What a consumer sees: the body plus the delivery bookkeeping it needs
    to delete (receipt_handle) and to detect redelivery (receive_count)."""

    message_id: str
    receipt_handle: str
    receive_count: int
    body: dict = field(default_factory=dict)


@guarded_by(
    "_lock",
    "_messages",
    "_dead_letters",
    "sent_total",
    "deleted_total",
    "redelivered_total",
    "expired_total",
    aliases=("_arrival",),
)
class NotificationQueue:
    def __init__(
        self,
        clock=None,
        visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT,
        max_receive_count: int = DEFAULT_MAX_RECEIVE_COUNT,
        max_depth: int = DEFAULT_MAX_DEPTH,
    ):
        from ...utils.clock import Clock

        self.clock = clock or Clock()
        self.visibility_timeout = visibility_timeout
        self.max_receive_count = max_receive_count
        self.max_depth = max_depth
        self._lock = WITNESS.lock("cloud.notifications")
        self._arrival = threading.Condition(self._lock)
        self._messages: Dict[str, QueueMessage] = {}  # insertion-ordered
        self._dead_letters: List[QueueMessage] = []
        self._id_counter = itertools.count(1)
        self._receipt_counter = itertools.count(1)
        # observability: totals over the queue's lifetime
        self.sent_total = 0
        self.deleted_total = 0
        self.redelivered_total = 0
        self.expired_total = 0  # dropped by the retention depth cap

    # -- producer side -------------------------------------------------------

    def send(self, body: dict) -> str:
        with self._lock:
            # retention: beyond the depth cap the OLDEST message is dropped
            # (insertion order == age) so a consumer-less queue stays bounded
            while len(self._messages) >= self.max_depth:
                oldest = next(iter(self._messages))
                del self._messages[oldest]
                self.expired_total += 1
            message_id = f"m-{next(self._id_counter):08d}"
            self._messages[message_id] = QueueMessage(
                message_id=message_id, body=dict(body), enqueued_at=self.clock.now()
            )
            self.sent_total += 1
            self._arrival.notify_all()
            return message_id

    # -- consumer side -------------------------------------------------------

    def receive_messages(
        self,
        max_messages: int = 10,
        wait_seconds: float = 0.0,
        visibility_timeout: Optional[float] = None,
    ) -> List[ReceivedMessage]:
        """Up to `max_messages` visible messages, each stamped with a fresh
        receipt handle and hidden for the visibility timeout. Messages whose
        redelivery would exceed max_receive_count dead-letter instead.
        `wait_seconds` long-polls in REAL time (arrivals wake the waiter);
        visibility expiry itself is judged on the owning clock, so fake-
        clocked suites control redelivery by stepping the clock."""
        timeout = self.visibility_timeout if visibility_timeout is None else visibility_timeout
        import time as _time

        deadline = _time.monotonic() + max(0.0, wait_seconds)
        while True:
            with self._lock:
                out = self._receive_locked(max_messages, timeout)
                if out or wait_seconds <= 0:
                    return out
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return []
                self._arrival.wait(timeout=min(remaining, 0.2))

    def _receive_locked(self, max_messages: int, timeout: float) -> List[ReceivedMessage]:
        now = self.clock.now()
        out: List[ReceivedMessage] = []
        for message in list(self._messages.values()):
            if len(out) >= max_messages:
                break
            if message.visible_at > now:
                continue
            if message.receive_count >= self.max_receive_count:
                # poison: never redeliver past the redrive threshold
                del self._messages[message.message_id]
                self._dead_letters.append(message)
                continue
            if message.receive_count > 0:
                self.redelivered_total += 1
            message.receive_count += 1
            message.visible_at = now + timeout
            message.receipt_handle = f"r-{next(self._receipt_counter):08d}"
            out.append(
                ReceivedMessage(
                    message_id=message.message_id,
                    receipt_handle=message.receipt_handle,
                    receive_count=message.receive_count,
                    body=dict(message.body),
                )
            )
        return out

    def delete_message(self, receipt_handle: str) -> bool:
        """Delete by receipt handle. Only the handle of the latest receive
        deletes; a stale handle (the message was redelivered since) is a
        no-op returning False — the consumer's delete raced a redelivery and
        the redelivered copy must still be processed."""
        with self._lock:
            for message_id, message in self._messages.items():
                if message.receipt_handle == receipt_handle:
                    del self._messages[message_id]
                    self.deleted_total += 1
                    return True
            return False

    # -- observability -------------------------------------------------------

    def depth(self) -> int:
        """Messages currently queued (visible or in flight)."""
        with self._lock:
            return len(self._messages)

    def in_flight(self) -> int:
        now = self.clock.now()
        with self._lock:
            return sum(1 for m in self._messages.values() if m.visible_at > now)

    def dead_letter_depth(self) -> int:
        with self._lock:
            return len(self._dead_letters)

    def dead_letters(self) -> List[QueueMessage]:
        with self._lock:
            return list(self._dead_letters)

    def attributes(self) -> dict:
        """The GetQueueAttributes analog, one dict for the HTTP route."""
        with self._lock:
            now = self.clock.now()
            return {
                "depth": len(self._messages),
                "in_flight": sum(1 for m in self._messages.values() if m.visible_at > now),
                "dead_letter_depth": len(self._dead_letters),
                "sent_total": self.sent_total,
                "deleted_total": self.deleted_total,
                "redelivered_total": self.redelivered_total,
                "expired_total": self.expired_total,
            }
