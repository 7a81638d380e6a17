"""Offering-health state: the TTL'd negative cache of exhausted pools.

The single most load-bearing robustness behavior of the reference under a
capacity crunch (aws instancetypes.go:211-226): when CreateFleet reports an
insufficient-capacity pool, remember the (instance_type, zone, capacity_type)
triple for a TTL and schedule AROUND it instead of retrying into the wall.
This module is the provider-neutral cache; it is fed by

  - launch ICEs (typed `InsufficientCapacityError`, including the per-item
    shortfall entries of a partially fulfilled fleet — a launch that
    SUCCEEDED on the next-cheapest pool still reports the pools it skipped);
  - spot-reclaim interruption notices (controllers/interruption): a pool the
    cloud just reclaimed from is the worst candidate for the replacement
    launch.

Consumers see it two ways: the instance-type catalog flags offerings
`available=False` (so the host scheduler's `type_has_offering`, the
consolidation/SLO ideal repack, and the dense encoder's availability cube
all route around the pool), and `version()` keys the catalog cache so a
mark OR a TTL expiry rebuilds the universe on the next fetch without any
explicit invalidation plumbing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

from .errors import Pool

UNAVAILABLE_OFFERING_TTL = 180.0


class UnavailableOfferings:
    """TTL'd set of (instance_type, zone, capacity_type) pools to avoid."""

    def __init__(self, clock, ttl: float = UNAVAILABLE_OFFERING_TTL):
        self.clock = clock
        self.ttl = ttl
        self._lock = threading.Lock()
        self._pools: Dict[Pool, float] = {}  # pool -> expiry on the clock
        self._version = 0  # bumps on every mark AND every observed expiry

    def mark_unavailable(self, type_name: str, zone: str, capacity_type: str, ttl: Optional[float] = None) -> None:
        """Quarantine a pool for `ttl` (default: the cache TTL) from now.
        Re-marking an already-quarantined pool refreshes its expiry WITHOUT
        bumping the version — visible availability did not change, so a
        persistent crunch must not force a catalog rebuild per launch."""
        key = (type_name, zone, capacity_type)
        now = self.clock.now()
        expiry = now + (self.ttl if ttl is None else ttl)
        with self._lock:
            # an expired-but-unpruned entry reads as available: re-marking
            # it is a visible flip, so it bumps like a fresh quarantine
            fresh = self._pools.get(key, now - 1.0) < now
            self._pools[key] = expiry
            if fresh:
                self._version += 1

    def mark_pools(self, pools, ttl: Optional[float] = None) -> None:
        for type_name, zone, capacity_type in pools:
            self.mark_unavailable(type_name, zone, capacity_type, ttl=ttl)

    def is_unavailable(self, type_name: str, zone: str, capacity_type: str) -> bool:
        key = (type_name, zone, capacity_type)
        now = self.clock.now()
        with self._lock:
            expiry = self._pools.get(key)
            if expiry is None:
                return False
            if expiry < now:
                del self._pools[key]
                self._version += 1
                return False
            return True

    def _prune_locked(self, now: float) -> None:
        expired = [k for k, expiry in self._pools.items() if expiry < now]
        for k in expired:
            del self._pools[k]
        if expired:
            self._version += 1

    def version(self) -> int:
        """Monotonic change counter, bumping on marks and (lazily observed)
        TTL expiries — the catalog's cache-key ingredient, so availability
        changes rebuild the universe without explicit invalidation."""
        now = self.clock.now()
        with self._lock:
            self._prune_locked(now)
            return self._version

    def snapshot(self) -> Set[Pool]:
        """Currently-quarantined pools (expired entries pruned)."""
        now = self.clock.now()
        with self._lock:
            self._prune_locked(now)
            return set(self._pools)

    def clear(self) -> None:
        with self._lock:
            if self._pools:
                self._version += 1
            self._pools.clear()



def count_insufficient_capacity(pools) -> None:
    """Record ICE observations for `pools`. The reference counts them per
    pool in a registry counter; the port has no registry yet (ROADMAP A8),
    so this is a no-op kept for its callers."""
