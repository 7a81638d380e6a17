"""Journal JSONL schema: the structural gate replay inputs must pass.

Mirrors scenarios/schema.py for the journal's on-disk trace format: one
validator shared by the replay path (scenarios/replay.py refuses a journal
that fails it) and the tests — so a hand-edited, truncated, or corrupted
JSONL fails with a line-numbered error instead of silently skewing the
replayed arrival structure.

Each line is one JSON object with the JournalEvent shape (journal.py):

    {"seq": 0, "t": 12.5, "kind": "pod", "entity": "load-1", "event": "created"}

Required: seq (int, strictly increasing), t (finite number, non-decreasing —
every timestamp flows through one clock seam, so a step backwards means a
corrupted or spliced file), kind (pod|node|solver|kube|chaos), entity
(non-empty string), event (in the kind's transition vocabulary). `attrs` is
an optional object.
"""

from __future__ import annotations

import json
import math
from typing import Iterable, List, Tuple

from .journal import (
    CHAOS_EVENTS,
    KIND_CHAOS,
    KIND_KUBE,
    KIND_NODE,
    KIND_POD,
    KIND_SOLVER,
    KUBE_EVENTS,
    NODE_EVENTS,
    POD_EVENTS,
    SOLVER_EVENTS,
)

_VOCAB = {
    KIND_POD: POD_EVENTS,
    KIND_NODE: NODE_EVENTS,
    KIND_SOLVER: SOLVER_EVENTS,
    KIND_KUBE: KUBE_EVENTS,
    KIND_CHAOS: CHAOS_EVENTS,
}


class JournalSchemaError(ValueError):
    """A journal file failed validation; str() lists line-numbered errors."""

    def __init__(self, path: str, errors: List[str]):
        self.path = path
        self.errors = errors
        preview = "\n".join(errors[:10])
        more = f"\n... and {len(errors) - 10} more" if len(errors) > 10 else ""
        super().__init__(f"{path}: {len(errors)} journal schema error(s):\n{preview}{more}")


def event_errors(obj, where: str = "event") -> List[str]:
    """Structural problems with one decoded journal event; empty = valid."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"{where}: must be a JSON object, got {type(obj).__name__}"]
    seq = obj.get("seq")
    if not isinstance(seq, int) or isinstance(seq, bool):
        errs.append(f"{where}: seq must be an integer")
    t = obj.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or not math.isfinite(t):
        errs.append(f"{where}: t must be a finite number")
    kind = obj.get("kind")
    if kind not in _VOCAB:
        errs.append(f"{where}: kind must be one of {sorted(_VOCAB)}, got {kind!r}")
    entity = obj.get("entity")
    if not isinstance(entity, str) or not entity:
        errs.append(f"{where}: entity must be a non-empty string")
    event = obj.get("event")
    if kind in _VOCAB and event not in _VOCAB[kind]:
        errs.append(f"{where}: unknown {kind} transition {event!r}; one of {list(_VOCAB[kind])}")
    attrs = obj.get("attrs")
    if attrs is not None and not isinstance(attrs, dict):
        errs.append(f"{where}: attrs must be an object when present")
    return errs


def journal_lines_errors(lines: Iterable[str], where: str = "journal") -> Tuple[List[dict], List[str]]:
    """Validate an iterable of JSONL lines. Returns (decoded events, errors);
    errors carry 1-based line numbers. Sequence/time monotonicity is checked
    across lines — the property the compressed campaign clock guarantees and
    replay's inter-arrival reconstruction depends on."""
    events: List[dict] = []
    errs: List[str] = []
    last_seq = None
    last_t = None
    for lineno, line in enumerate(lines, start=1):
        stripped = line.strip()
        if not stripped:
            errs.append(f"{where} line {lineno}: blank line (a truncated write?)")
            continue
        try:
            obj = json.loads(stripped)
        except json.JSONDecodeError as err:
            errs.append(f"{where} line {lineno}: invalid JSON ({err.msg} at column {err.colno})")
            continue
        line_errs = event_errors(obj, where=f"{where} line {lineno}")
        errs.extend(line_errs)
        if line_errs:
            continue
        if last_seq is not None and obj["seq"] <= last_seq:
            errs.append(f"{where} line {lineno}: seq {obj['seq']} does not increase (prev {last_seq})")
        if last_t is not None and obj["t"] < last_t:
            errs.append(
                f"{where} line {lineno}: t {obj['t']} goes backwards (prev {last_t}): "
                "journal timestamps are clock-seam monotonic"
            )
        last_seq, last_t = obj["seq"], obj["t"]
        events.append(obj)
    return events, errs


def load_journal(path: str) -> List[dict]:
    """Read and validate a journal JSONL file; raises JournalSchemaError
    (line-numbered) on the first malformation instead of returning a trace
    that would silently skew a replay."""
    with open(path, encoding="utf-8") as f:
        events, errs = journal_lines_errors(f, where=path)
    if errs:
        raise JournalSchemaError(path, errs)
    return events
