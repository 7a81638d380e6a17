"""Shared cloud-error taxonomy: typed capacity failures every provider raises.

The reference's providers translate their cloud's error surfaces into one
typed family the controllers can dispatch on (aws instance.go:133-208 per-item
CreateFleet error extraction feeding the unavailable-offerings cache). The
same discipline here: both the in-memory fake provider and the simulated
backend (in-process AND HTTP transports) raise THESE types, so the
provisioner's fallback re-solve, the negative offering cache, and the
metrics never depend on which cloud flavor is wired in.

A "pool" throughout is the (instance_type, zone, capacity_type) triple — the
granularity at which real clouds run out of capacity and at which the
UnavailableOfferings cache quarantines.
"""

from __future__ import annotations

from typing import Iterable, Tuple

Pool = Tuple[str, str, str]  # (instance_type, zone, capacity_type)


def pool_label(pool: Pool) -> str:
    """The metric label form of a pool: 'type/zone/capacity-type'."""
    return "/".join(pool)


class InsufficientCapacityError(RuntimeError):
    """The cloud could not fulfill a launch from ANY of the requested pools
    (the EC2 InsufficientInstanceCapacity analog). `pools` names every
    (instance_type, zone, capacity_type) that was exhausted — the feed for
    the negative offering cache."""

    def __init__(self, pools: Iterable[Pool]):
        self.pools = [tuple(p) for p in pools]
        super().__init__(f"insufficient capacity for {self.pools}")


class TransientCloudError(RuntimeError):
    """A transport-shaped failure the caller may retry (with the same client
    token) — the operation's outcome is UNKNOWN to the caller."""


class ResponseLostError(TransientCloudError):
    """The request was fully processed but the response never arrived — the
    in-process analog of the mid-CreateFleet connection loss the HTTP
    service injects with drop_response_next()."""
