"""Subnet + security-group discovery with caching.

The SubnetProvider/SecurityGroupProvider analog (pkg/cloudprovider/aws/
subnets.go:47, securitygroups.go): tag-selector discovery against the
backend with a TTL cache, plus the per-zone best-subnet choice the instance
provider uses at launch (most available IPs first, aws/instance.go:239-279).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .backend import CloudBackend, SecurityGroup, Subnet

CACHE_TTL = 60.0  # the reference's 60s describe caches (aws/cloudprovider.go:53-61)


class _TTLCache:
    def __init__(self, clock, ttl: float = CACHE_TTL):
        self.clock = clock
        self.ttl = ttl
        self._lock = threading.Lock()
        self._entries: Dict[tuple, Tuple[float, object]] = {}

    def get(self, key: tuple):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[0] < self.clock.now():
                return None
            return entry[1]

    def put(self, key: tuple, value) -> None:
        with self._lock:
            self._entries[key] = (self.clock.now() + self.ttl, value)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def _selector_key(selector: Optional[Dict[str, str]]) -> tuple:
    return tuple(sorted((selector or {}).items()))


class SubnetProvider:
    def __init__(self, backend: CloudBackend, clock):
        self.backend = backend
        self._cache = _TTLCache(clock)

    def list(self, selector: Optional[Dict[str, str]] = None) -> List[Subnet]:
        key = _selector_key(selector)
        cached = self._cache.get(key)
        if cached is None:
            cached = self.backend.describe_subnets(selector or None)
            self._cache.put(key, cached)
        return list(cached)

    def best_for_zone(self, zone: str, selector: Optional[Dict[str, str]] = None) -> Optional[Subnet]:
        """The launch-time subnet for a zone: most available IPs first
        (aws/instance.go:239-279)."""
        candidates = [s for s in self.list(selector) if s.zone == zone]
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.available_ip_count)

    def invalidate(self) -> None:
        self._cache.clear()


class SecurityGroupProvider:
    def __init__(self, backend: CloudBackend, clock):
        self.backend = backend
        self._cache = _TTLCache(clock)

    def resolve(self, selector: Optional[Dict[str, str]] = None, explicit_ids: Optional[List[str]] = None) -> List[str]:
        """Explicit group ids win; a selector discovers by tags and FAILS
        LOUD when nothing matches (a typo'd selector must not silently
        launch with the default group); neither -> the default group."""
        if explicit_ids:
            return list(explicit_ids)
        if not selector:
            return ["sg-default"]
        key = _selector_key(selector)
        cached = self._cache.get(key)
        if cached is None:
            cached = [g.group_id for g in self.backend.describe_security_groups(selector)]
            self._cache.put(key, cached)
        if not cached:
            raise RuntimeError(f"no security groups matched selector {selector!r}")
        return list(cached)

    def invalidate(self) -> None:
        self._cache.clear()
