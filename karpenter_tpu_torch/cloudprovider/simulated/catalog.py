"""Catalog + pricing providers with caching.

The InstanceTypeProvider/PricingProvider pair from the reference
(pkg/cloudprovider/aws/instancetypes.go, pricing.go): TTL-cached describe
calls, the zone universe from subnet discovery, a periodically-refreshed
price book (on-demand + spot) with a static fallback, and the
unavailable-offerings negative cache that remembers insufficient-capacity
pools so the scheduler stops proposing them for a while.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ...api import labels as lbl
from ...api.objects import OP_IN
from ...scheduling.requirement import Requirement
from ...scheduling.requirements import Requirements
from ...utils import resources as res
from ..offerings import UNAVAILABLE_OFFERING_TTL, UnavailableOfferings
from ..types import InstanceType, Offering
from .backend import CloudBackend, InstanceTypeInfo

CATALOG_CACHE_TTL = 60.0

# the cache class moved to cloudprovider/offerings.py (it is provider-neutral
# state fed by launch ICEs and interruption notices); legacy spelling kept
UnavailableOfferingsCache = UnavailableOfferings


class PricingProvider:
    """Price book with explicit refresh (the async updater's synchronous
    core) and static synthesized fallbacks when the backend has no quote."""

    def __init__(self, backend: CloudBackend):
        self.backend = backend
        self._lock = threading.Lock()
        self._od: Dict[str, float] = {}
        self._spot: Dict[Tuple[str, str], float] = {}
        self.refreshes = 0
        self.refresh()

    def refresh(self) -> bool:
        """Re-pull both price books; returns True when either changed (the
        caller invalidates the catalog so new prices reach offerings). One
        bulk call per refresh (describe_prices) — over the HTTP transport,
        per-(type, zone) quote calls would be a call storm."""
        od, spot = self.backend.describe_prices()
        with self._lock:
            changed = od != self._od or spot != self._spot
            self._od = dict(od)
            self._spot = dict(spot)
            self.refreshes += 1
        return changed

    def on_demand_price(self, type_name: str, info: Optional[InstanceTypeInfo] = None) -> float:
        with self._lock:
            price = self._od.get(type_name)
        if price is not None:
            return price
        # static fallback (zz_generated.pricing.go analog)
        if info is not None:
            return 0.05 * info.cpu + 0.012 * info.memory_bytes / 2**30 + 0.9 * info.gpus
        return 1.0

    def spot_price(self, type_name: str, zone: str) -> Optional[float]:
        with self._lock:
            return self._spot.get((type_name, zone))


class SimulatedInstanceType(InstanceType):
    """Adapts a backend InstanceTypeInfo into the scheduler's InstanceType
    (the instancetype.go adapter): requirements from the catalog entry,
    offerings from zone x capacity-type availability, resources minus a
    modeled system overhead."""

    def __init__(self, info: InstanceTypeInfo, offerings: Sequence[Offering], price: float):
        self.info = info
        self._offerings = list(offerings)
        self._price = price
        self._requirements: Optional[Requirements] = None

    def name(self) -> str:
        return self.info.name

    def price(self) -> float:
        return self._price

    def resources(self) -> Dict[str, float]:
        out = {res.CPU: self.info.cpu, res.MEMORY: self.info.memory_bytes, res.PODS: self.info.pods}
        if self.info.gpus:
            out[self.info.gpu_resource] = self.info.gpus
        return out

    def overhead(self) -> Dict[str, float]:
        # kube-reserved + system-reserved model: 80m cpu + 255Mi + 11Mi/pod
        return {
            res.CPU: 0.08,
            res.MEMORY: 255 * 2**20 + self.info.pods * 11 * 2**20,
        }

    def offerings(self) -> Sequence[Offering]:
        return self._offerings

    def requirements(self) -> Requirements:
        # requirements derive from AVAILABLE offerings only: a zone whose
        # every pool is quarantined must not satisfy a zone-pinned pod (the
        # launch would ICE straight back into the wall); the full offering
        # list — flags included — stays visible via offerings() for pricing,
        # masks, and metrics
        if self._requirements is None:
            live = [o for o in self._offerings if o.available] or list(self._offerings)
            self._requirements = Requirements(
                Requirement(lbl.LABEL_INSTANCE_TYPE, OP_IN, self.info.name),
                Requirement(lbl.LABEL_ARCH, OP_IN, self.info.architecture),
                Requirement(lbl.LABEL_OS, OP_IN, lbl.OS_LINUX),
                Requirement(lbl.LABEL_TOPOLOGY_ZONE, OP_IN, *{o.zone for o in live}),
                Requirement(lbl.LABEL_CAPACITY_TYPE, OP_IN, *{o.capacity_type for o in live}),
                Requirement("karpenter-tpu/instance-family", OP_IN, self.info.family),
            )
        return self._requirements


class InstanceTypeCatalog:
    """TTL-cached instance-type universe (instancetypes.go:80-226)."""

    def __init__(self, backend: CloudBackend, pricing: PricingProvider, unavailable: UnavailableOfferingsCache, clock):
        self.backend = backend
        self.pricing = pricing
        self.unavailable = unavailable
        self.clock = clock
        self._lock = threading.Lock()
        # cached per (filter flag, subnet selector) so differently-configured
        # provisioners don't see each other's filtered universe
        self._cache: Dict[tuple, Tuple[float, List[SimulatedInstanceType]]] = {}

    def zones(self, tag_selector: Optional[Dict[str, str]] = None) -> List[str]:
        return sorted({s.zone for s in self.backend.describe_subnets(tag_selector)})

    def get(self, include_previous_generation: bool = False, subnet_selector: Optional[Dict[str, str]] = None) -> List[SimulatedInstanceType]:
        # the key carries the unavailable-offerings VERSION: a pool mark or
        # a TTL expiry rebuilds the universe on the next fetch — no explicit
        # invalidation plumbing between the negative cache and this one
        key = (
            include_previous_generation,
            tuple(sorted((subnet_selector or {}).items())),
            self.unavailable.version(),
        )
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None and self.clock.now() < cached[0]:
                return list(cached[1])
        zones = self.zones(subnet_selector)
        out: List[SimulatedInstanceType] = []
        for info in self.backend.describe_instance_types():
            if not info.current_generation and not include_previous_generation:
                continue  # the opinionated default filter (cloudprovider.go:157-180)
            offerings = []
            for zone in zones:
                for capacity_type in (lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND):
                    price = (
                        self.pricing.spot_price(info.name, zone)
                        if capacity_type == lbl.CAPACITY_TYPE_SPOT
                        else self.pricing.on_demand_price(info.name, info)
                    )
                    if price is None:
                        continue
                    # a quarantined pool stays in the universe FLAGGED, so
                    # topology domains and pricing remain stable while the
                    # scheduler/solver route around it
                    offerings.append(
                        Offering(
                            capacity_type=capacity_type,
                            zone=zone,
                            price=price,
                            available=not self.unavailable.is_unavailable(info.name, zone, capacity_type),
                        )
                    )
            live_prices = [o.price for o in offerings if o.available and o.price is not None]
            if not live_prices:
                continue  # every pool of this type is quarantined: drop it
            out.append(SimulatedInstanceType(info, offerings, min(live_prices)))
        with self._lock:
            while len(self._cache) > 8:  # version churn must not accumulate
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = (self.clock.now() + CATALOG_CACHE_TTL, out)
        return list(out)

    def invalidate(self) -> None:
        with self._lock:
            self._cache = {}
