"""Requirement: an efficient node-selector requirement as a value set.

The key trick carried over from the reference (pkg/scheduling/requirement.go:35-41)
is the *complement* representation: `NotIn{a,b}` and `Exists` are stored as the
complement of a finite set, so every operator becomes closed under
intersection without enumerating an open world of values. Gt/Lt keep integer
bounds alongside. This same representation is what the dense IR encodes as
(mask, complement-flag) pairs over the interned label vocabulary
(ir/encode.py), so host algebra and device masks stay in exact correspondence.

Deviation from the reference: `any_value()` is deterministic (the reference
picks randomly, requirement.go:106-122); determinism is load-bearing for
differential testing of the TPU solver against the host oracle.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Optional, Set

from ..api.labels import normalize_label
from ..api.objects import OP_DOES_NOT_EXIST, OP_EXISTS, OP_GT, OP_IN, OP_LT, OP_NOT_IN

# Stand-in for "infinity" when reporting the size of complement sets.
INF = 1 << 62


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    if greater_than is None and less_than is None:
        return True
    try:
        as_int = int(value)
    except ValueError:
        return False  # non-integer values are invalid once bounds exist
    if greater_than is not None and as_int <= greater_than:
        return False
    if less_than is not None and as_int >= less_than:
        return False
    return True


class Requirement:
    __slots__ = ("key", "complement", "values", "greater_than", "less_than")

    def __init__(self, key: str, operator: str, *values: str):
        self.key = normalize_label(key)
        self.values: Set[str] = set()
        self.complement = operator not in (OP_IN, OP_DOES_NOT_EXIST)
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        if operator in (OP_IN, OP_NOT_IN):
            self.values.update(str(v) for v in values)
        elif operator == OP_GT:
            self.greater_than = int(values[0])
        elif operator == OP_LT:
            self.less_than = int(values[0])
        elif operator not in (OP_EXISTS, OP_DOES_NOT_EXIST):
            raise ValueError(f"invalid operator {operator!r}")

    @classmethod
    def _raw(cls, key: str, complement: bool, values: Set[str], greater_than=None, less_than=None) -> "Requirement":
        r = cls(key, OP_EXISTS)
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        return r

    # -- set algebra --------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """Closed-form intersection over all operator combinations.

        Mirrors requirement.go:71-104: union/difference/intersection of the
        finite parts depending on complement flags, bound tightening, and
        collapse to DoesNotExist on empty integer ranges.
        """
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, OP_DOES_NOT_EXIST)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than)

    def has(self, value: str) -> bool:
        if self.complement:
            return value not in self.values and _within(value, self.greater_than, self.less_than)
        return value in self.values and _within(value, self.greater_than, self.less_than)

    def insert(self, *values: str) -> None:
        self.values.update(values)

    def operator(self) -> str:
        if self.complement:
            return OP_NOT_IN if self.values else OP_EXISTS
        return OP_IN if self.values else OP_DOES_NOT_EXIST

    def __len__(self) -> int:
        if self.complement:
            return INF - len(self.values)
        return len(self.values)

    def allowed_values(self) -> FrozenSet[str]:
        """The finite allowed set; only meaningful when not complement."""
        return frozenset(self.values)

    def any_value(self) -> str:
        """A deterministic representative allowed value ('' if none expressible)."""
        op = self.operator()
        if op == OP_IN:
            return min(self.values)
        if op in (OP_NOT_IN, OP_EXISTS):
            low = 0 if self.greater_than is None else self.greater_than + 1
            high = (1 << 31) if self.less_than is None else self.less_than
            for candidate in range(low, high):
                if str(candidate) not in self.values:
                    return str(candidate)
        return ""

    def __repr__(self) -> str:
        op = self.operator()
        if op in (OP_EXISTS, OP_DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            shown = sorted(self.values)
            if len(shown) > 5:
                shown = shown[:5] + [f"and {len(self.values) - 5} others"]
            s = f"{self.key} {op} {shown}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        return s


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)
