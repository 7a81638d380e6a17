"""Minimal 5-field cron expressions for disruption-budget windows.

The budget `schedule` field uses the standard crontab shape
(`minute hour day-of-month month day-of-week`, UTC) with the field syntax
subset the reference's disruption budgets accept: `*`, single values,
ranges (`a-b`), steps (`*/n`, `a-b/n`), and comma lists. A budget window is
"active" when any cron fire time within the trailing `duration` matches.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import List, Optional, Set, Tuple

# (min, max) per field, in crontab order
_FIELD_RANGES: Tuple[Tuple[int, int], ...] = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))
_FIELD_NAMES = ("minute", "hour", "day-of-month", "month", "day-of-week")

# how far back an active-window probe will scan; a longer duration is legal
# but only the trailing week of fire times is considered
MAX_WINDOW_SCAN_MINUTES = 7 * 24 * 60


def _parse_field(spec: str, lo: int, hi: int) -> Optional[Set[int]]:
    """One cron field -> the set of matching values, or None when malformed."""
    out: Set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            if not step_s.isdigit() or int(step_s) < 1:
                return None
            step = int(step_s)
        if part == "*":
            lo_p, hi_p = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            if not (a.isdigit() and b.isdigit()):
                return None
            lo_p, hi_p = int(a), int(b)
        elif part.isdigit():
            lo_p = hi_p = int(part)
        else:
            return None
        if lo_p < lo or hi_p > hi or lo_p > hi_p:
            return None
        out.update(range(lo_p, hi_p + 1, step))
    return out


def cron_errors(expr: str) -> List[str]:
    """Human-readable syntax violations for a cron expression (empty == valid)."""
    fields = expr.split()
    if len(fields) != 5:
        return [f"schedule {expr!r} must have 5 fields (minute hour day-of-month month day-of-week), got {len(fields)}"]
    errs: List[str] = []
    for spec, (lo, hi), name in zip(fields, _FIELD_RANGES, _FIELD_NAMES):
        if _parse_field(spec, lo, hi) is None:
            errs.append(f"schedule {expr!r}: invalid {name} field {spec!r} (allowed: *, n, a-b, */s, lists; range {lo}-{hi})")
    return errs


def matches(expr: str, when: datetime) -> bool:
    """True when `when` (minute precision) is a fire time of `expr`.

    Standard (vixie) cron semantics: when BOTH day-of-month and day-of-week
    are restricted (neither is `*`), the date matches if EITHER does —
    `0 0 15 * 1` fires on the 15th OR on Mondays, not only on Mondays that
    fall on the 15th."""
    fields = expr.split()
    # crontab day-of-week: 0=Sunday..6=Saturday; datetime.weekday(): 0=Monday
    dow = (when.weekday() + 1) % 7
    values = (when.minute, when.hour, when.day, when.month, dow)
    parsed = [_parse_field(spec, lo, hi) for spec, (lo, hi) in zip(fields, _FIELD_RANGES)]
    if any(p is None for p in parsed):
        return False
    minute_ok, hour_ok, month_ok = values[0] in parsed[0], values[1] in parsed[1], values[3] in parsed[3]
    dom_restricted, dow_restricted = fields[2] != "*", fields[4] != "*"
    dom_ok, dow_ok = values[2] in parsed[2], values[4] in parsed[4]
    if dom_restricted and dow_restricted:
        day_ok = dom_ok or dow_ok
    else:
        day_ok = dom_ok and dow_ok
    return minute_ok and hour_ok and month_ok and day_ok


def window_active(expr: str, duration_seconds: float, now_epoch: float) -> bool:
    """True when `now` falls inside [fire, fire + duration] for some fire
    time of `expr`. Scans trailing minutes (bounded at one week)."""
    minutes = min(int(duration_seconds // 60) + 1, MAX_WINDOW_SCAN_MINUTES)
    now = datetime.fromtimestamp(now_epoch, tz=timezone.utc).replace(second=0, microsecond=0)
    for back in range(minutes):
        probe = now - timedelta(minutes=back)
        if matches(expr, probe):
            # fire at `probe`; active until probe + duration
            fired = probe.timestamp()
            if now_epoch < fired + duration_seconds:
                return True
    return False
