"""Replay: drive a scenario from a recorded journal's arrival trace.

The journal (journal.py) is the on-disk trace format; `ReplayTrace` closes
the loop: a captured journal (or any schema-valid JSONL — cluster-trace
datasets convert to the same shape) becomes a scenario primitive that
re-presents the recorded pod arrivals to a live Runtime with the original
inter-arrival structure preserved and optionally clock-compressed, so hours
of recorded wall-time replay in minutes through the same `utils/clock.py`
seam everything else is timed by.

    trace = ReplayTrace.from_journal("JOURNAL_pod_burst_inprocess.jsonl", compress=60.0)
    Scenario(name="replayed_burst", desired=0, duration=trace.total_seconds() + 2.0,
             primitives=[trace])

Only pod `created` events matter to the arrival schedule; everything else
in the journal (solve/launch/bind timing) is the RESULT the replayed run
will score for itself. Inputs are validated through journal_schema.py — a
truncated or hand-edited file fails loudly with a line-numbered error, not
silently as a skewed trace.

The port's copy of karpenter_tpu/scenarios/replay.py.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Tuple

from ..journal import KIND_POD
from ..journal_schema import JournalSchemaError, event_errors, load_journal
from ..logsetup import get_logger
from .primitives import Primitive, ScenarioContext

log = get_logger("replay")


@dataclass
class ReplayTrace(Primitive):
    """Re-present a recorded arrival trace: one desired-count increment per
    recorded pod `created` event, spaced by the recorded inter-arrival gaps
    divided by `compress` (2.0 = twice as fast). The schedule is fixed at
    construction, so two replays of one journal present identical load."""

    # (delay-seconds-after-previous-arrival, recorded pod name), already
    # clock-compressed; first entry's delay is measured from the primitive's
    # own start (the `offset` field schedules that, like every primitive)
    arrivals: List[Tuple[float, str]] = field(default_factory=list)
    compress: float = 1.0
    source: str = ""  # provenance: where the trace came from
    source_digest: str = ""  # sha256[:16] of the arrival schedule

    @classmethod
    def from_events(cls, events, compress: float = 1.0, offset: float = 0.0, source: str = "") -> "ReplayTrace":
        """Build from decoded journal events (already schema-validated when
        they came through load_journal; raw lists are re-checked here)."""
        if compress <= 0:
            raise ValueError(f"compress must be positive, got {compress}")
        errs: List[str] = []
        for i, event in enumerate(events):
            errs.extend(event_errors(event, where=f"events[{i}]"))
        if errs:
            raise JournalSchemaError(source or "<events>", errs)
        created = [e for e in events if e["kind"] == KIND_POD and e["event"] == "created"]
        created.sort(key=lambda e: (e["t"], e["seq"]))
        arrivals: List[Tuple[float, str]] = []
        prev_t = None
        for event in created:
            delay = 0.0 if prev_t is None else (event["t"] - prev_t) / compress
            arrivals.append((round(delay, 6), event["entity"]))
            prev_t = event["t"]
        digest = hashlib.sha256(json.dumps(arrivals).encode()).hexdigest()[:16]
        return cls(offset=offset, arrivals=arrivals, compress=compress, source=source, source_digest=digest)

    @classmethod
    def from_journal(cls, path: str, compress: float = 1.0, offset: float = 0.0) -> "ReplayTrace":
        """Build from a journal JSONL file (the campaign spool, or any
        schema-valid trace); validation failures raise line-numbered."""
        return cls.from_events(load_journal(path), compress=compress, offset=offset, source=path)

    def schedule(self) -> List[Tuple[float, str]]:
        """The arrival schedule: (delay-after-previous, recorded name) in
        recorded order — inter-arrival structure preserved, compressed."""
        return list(self.arrivals)

    def total_seconds(self) -> float:
        """Compressed span from the first arrival to the last."""
        return sum(delay for delay, _ in self.arrivals)

    def run(self, ctx: ScenarioContext) -> None:
        log.info(
            "replay: %d recorded arrivals over %.2fs (compress %.1fx, source %s)",
            len(self.arrivals), self.total_seconds(), self.compress, self.source or "inline",
        )
        for delay, _name in self.arrivals:
            if delay > 0 and ctx.sleep(delay):
                return
            ctx.add_desired(1)

    def config(self) -> dict:
        """Provenance payload: the schedule is summarized by digest — a
        thousand-arrival trace must not inline itself into the config hash
        block, but two artifacts compare equal iff they replayed the same
        schedule at the same compression."""
        return {
            "kind": type(self).__name__,
            "offset": self.offset,
            "arrivals": len(self.arrivals),
            "total_seconds": round(self.total_seconds(), 6),
            "compress": self.compress,
            "source": self.source,
            "source_digest": self.source_digest,
        }
