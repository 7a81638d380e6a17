"""Kubernetes-style resource quantity parsing.

The reference manipulates `resource.Quantity` values everywhere (requests,
capacities, limits). We normalize quantities to floats in canonical units at
the edge of the system — CPU in cores, memory/storage in bytes — because the
dense TPU solver operates on float32/bfloat16 matrices anyway and exact
arithmetic only needs to survive until encoding.
"""

from __future__ import annotations

import math
import re

# Binary and decimal suffixes per the Kubernetes quantity grammar.
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)(Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?$")


def parse_quantity(value) -> float:
    """Parse a quantity ('100m', '4Gi', '2', 1.5) into a float in base units."""
    if isinstance(value, (int, float)):
        return float(value)
    value = value.strip()
    match = _QUANTITY_RE.match(value)
    if match is None:
        raise ValueError(f"cannot parse quantity {value!r}")
    number, suffix = match.groups()
    scale = 1.0
    if suffix:
        scale = _BINARY.get(suffix) or _DECIMAL[suffix]
    return float(number) * scale


def format_quantity(value: float) -> str:
    """Render a float quantity compactly (inverse of parse for common cases)."""
    if value == 0:
        return "0"
    if value == math.floor(value):
        intval = int(value)
        for suffix, scale in (("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
            if intval % scale == 0 and intval >= scale:
                return f"{intval // scale}{suffix}"
        return str(intval)
    # sub-unit values render in millis when exact (the common CPU case)
    millis = value * 1000
    if abs(millis - round(millis)) < 1e-9:
        return f"{int(round(millis))}m"
    return repr(value)
