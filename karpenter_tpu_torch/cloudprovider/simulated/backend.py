"""CloudBackend: a programmable in-memory IaaS.

The analog of the reference's fake EC2/SSM/Pricing APIs
(pkg/cloudprovider/aws/fake/ec2api.go) — but promoted to a first-class
simulation backend the 'real-style' provider implementation runs against:
instance-type catalog, per-zone subnets, spot/on-demand price books,
create-fleet with insufficient-capacity pools and injectable errors, launch
templates, and full call capture for tests.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ...analysis import WITNESS, guarded_by
from ..errors import InsufficientCapacityError, ResponseLostError, TransientCloudError


@dataclass(frozen=True)
class InstanceTypeInfo:
    name: str
    cpu: float
    memory_bytes: float
    pods: float
    architecture: str = "amd64"
    gpus: float = 0.0
    gpu_resource: str = "nvidia.com/gpu"
    current_generation: bool = True
    family: str = "general"


@dataclass
class Subnet:
    subnet_id: str
    zone: str
    available_ip_count: int = 1000
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroup:
    group_id: str
    name: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplate:
    template_id: str
    name: str
    image_id: str
    security_group_ids: Tuple[str, ...]
    user_data: str


@dataclass
class FleetInstanceSpec:
    instance_type: str
    zone: str
    capacity_type: str
    launch_template_id: str = ""
    subnet_id: str = ""  # the zone's most-available-IPs subnet


@dataclass
class FleetRequest:
    specs: List[FleetInstanceSpec]
    capacity_type: str
    # client idempotency token (the EC2 ClientToken analog): the backend
    # remembers {token -> result} and REPLAYS the original launch for any
    # retry carrying the same token, so a caller whose response was lost
    # (mid-call timeout, process crash after the launch ran) can retry
    # without double-launching. Empty = no dedup (every call launches).
    client_token: str = ""
    # target capacity: how many instances this fleet call should launch (the
    # EC2 TargetCapacitySpecification analog). A call may come back PARTIAL —
    # fewer instances than `count`, with one typed error entry per
    # unfulfilled item (FleetResult.errors).
    count: int = 1


@dataclass
class FleetInstance:
    instance_id: str
    instance_type: str
    zone: str
    capacity_type: str
    subnet_id: str = ""
    # launch instant on the owning clock: the GC sweep's registration grace
    # period is judged against this (an instance with no node object older
    # than the grace is an orphan)
    launched_at: float = 0.0


class LaunchTemplateNotFoundError(RuntimeError):
    """A fleet spec referenced a launch template the cloud no longer has —
    the cache went out of sync with external deletion (the EC2
    InvalidLaunchTemplateId analog, launchtemplate_test.go:138)."""

    def __init__(self, template_ids):
        super().__init__(f"launch templates not found: {sorted(template_ids)}")
        self.template_ids = set(template_ids)


# the capacity taxonomy is shared with the fake provider (cloudprovider/
# errors.py); re-exported here because the whole simulated stack imports it
# from the backend module
__all_errors__ = (InsufficientCapacityError, TransientCloudError, ResponseLostError)


@dataclass
class FleetResult:
    """Per-item CreateFleet outcome: the fulfilled instances plus one typed
    error entry per unfulfilled item (the EC2 CreateFleet Instances[] +
    Errors[] response shape, instance.go:133-208). A call that fulfilled
    NOTHING raises `InsufficientCapacityError` instead of returning — total
    failure stays a typed exception on both transports.

    `unavailable_pools` lists every exhausted pool the launch loop skipped
    EVEN WHEN the call succeeded on a pricier pool — the proactive feed for
    the negative offering cache (a launch that silently fell past the
    cheapest pool is the earliest possible ICE signal)."""

    instances: List[FleetInstance] = field(default_factory=list)
    errors: List[InsufficientCapacityError] = field(default_factory=list)
    unavailable_pools: List[Tuple[str, str, str]] = field(default_factory=list)

    @property
    def instance(self) -> FleetInstance:
        """The single-launch accessor (count=1 callers)."""
        return self.instances[0]


def default_catalog() -> List[InstanceTypeInfo]:
    out = []
    for i, (cpu, mem) in enumerate([(2, 4), (2, 8), (4, 8), (4, 16), (8, 16), (8, 32), (16, 32), (16, 64), (32, 64), (32, 128), (48, 96), (64, 128), (96, 192)]):
        for family, arch in (("general", "amd64"), ("compute", "amd64"), ("graviton", "arm64")):
            out.append(
                InstanceTypeInfo(
                    name=f"{family}-{cpu}x{mem}",
                    cpu=float(cpu),
                    memory_bytes=mem * 2**30,
                    pods=min(250.0, cpu * 15.0),
                    architecture=arch,
                    family=family,
                )
            )
    # accelerator shapes
    for gpus in (1, 4, 8):
        out.append(InstanceTypeInfo(name=f"accel-{gpus}g", cpu=float(8 * gpus), memory_bytes=gpus * 64 * 2**30, pods=110.0, gpus=float(gpus), family="accel"))
    # a previous-generation family the provider filters by default
    out.append(InstanceTypeInfo(name="legacy-2x4", cpu=2.0, memory_bytes=4 * 2**30, pods=20.0, current_generation=False, family="legacy"))
    seen = set()
    unique = []
    for info in out:
        if info.name not in seen:
            seen.add(info.name)
            unique.append(info)
    return unique


@guarded_by(
    "_lock",
    "instances",
    "fleet_tokens",
    "token_launches",
    "_double_launches_evicted",
    "pending_reclaims",
    "launch_templates",
    "od_prices",
    "spot_prices",
    "create_fleet_calls",
    "terminate_calls",
    "describe_calls",
    "insufficient_capacity_pools",
    "capacity_pools",
    "next_error",
    "_drop_response",
    "api_latency",
)
class CloudBackend:
    def __init__(self, catalog: Optional[List[InstanceTypeInfo]] = None, zones: Sequence[str] = ("zone-a", "zone-b", "zone-c"), clock=None):
        from ...utils.clock import Clock
        from .notifications import NotificationQueue

        self.clock = clock or Clock()
        self._lock = WITNESS.lock("cloud.backend")
        # the SQS-analog interruption feed (notifications.py): every
        # lifecycle event below lands here; consumers poll it in-process or
        # over the HTTP transport (api.py /v1/queue routes)
        self.notifications = NotificationQueue(clock=self.clock)
        # spot reclaims in flight: instance_id -> reclaim deadline; the
        # instance dies (instance_terminated notification) once the sim
        # clock passes the deadline and reclaim_due_instances() runs
        self.pending_reclaims: Dict[str, float] = {}
        self.catalog = catalog if catalog is not None else default_catalog()
        self.subnets = [
            Subnet(subnet_id=f"subnet-{z}", zone=z, available_ip_count=1000 + 100 * i, tags={"discovery": "cluster"})
            for i, z in enumerate(zones)
        ]
        self.security_groups = [
            SecurityGroup(group_id="sg-default", name="default", tags={"discovery": "cluster"}),
            SecurityGroup(group_id="sg-nodes", name="nodes", tags={"discovery": "cluster", "role": "node"}),
        ]
        self.launch_templates: Dict[str, LaunchTemplate] = {}
        self._template_counter = itertools.count(1)
        self._instance_counter = itertools.count(1)
        self.instances: Dict[str, FleetInstance] = {}
        # price books: on-demand per type; spot per (type, zone)
        self.od_prices: Dict[str, float] = {
            info.name: 0.05 * info.cpu + 0.012 * info.memory_bytes / 2**30 + 0.9 * info.gpus for info in self.catalog
        }
        # spot discount varies by pool but must be deterministic across
        # processes (hash() is salted); crc32 is stable
        import zlib

        self.spot_prices: Dict[Tuple[str, str], float] = {
            (info.name, subnet.zone): self.od_prices[info.name]
            * (0.3 + 0.05 * (zlib.crc32(f"{info.name}/{subnet.zone}".encode()) % 5))
            for info in self.catalog
            for subnet in self.subnets
        }
        # idempotency: settled launches by client token, bounded (insertion
        # order == age; an ordered-dict cap like the interruption
        # controller's TTL maps). Only calls that launched >= 1 instance are
        # recorded — a totally failed create may be retried with the same
        # token, EC2-style.
        self.fleet_tokens: Dict[str, FleetResult] = {}
        self._fleet_token_cap = 4096
        # the double-launch witness (control-plane fault domain): how many
        # times each client token EXECUTED a launch (replays excluded) — a
        # count above 1 means idempotency failed or two leaders raced one
        # logical launch past the token ledger; chaos scenarios score
        # sum(n-1) and pin it at zero. Bounded on its OWN, longer horizon
        # (4x the replay cap): a token evicted from fleet_tokens whose
        # delayed retry then re-executes must still be seen twice here —
        # evicting the two ledgers together would blind the witness to the
        # exact replay-cap miss it exists to catch. Overflow folds n-1 into
        # the running total before an entry leaves, so eviction can never
        # launder a detected double launch.
        self.token_launches: Dict[str, int] = {}
        self._double_launches_evicted = 0
        # fault injection
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()  # (type, zone, capacity_type)
        # FINITE capacity per pool: remaining launchable units for pools
        # listed here (absent = infinite, the default). A launch from a
        # finite pool decrements it; terminating an instance credits its
        # pool back (real clouds regain capacity when instances free up).
        # A pool at 0 behaves exactly like an injected ICE pool.
        self.capacity_pools: Dict[Tuple[str, str, str], int] = {}
        self.next_error: Optional[Exception] = None
        # next n create_fleet calls EXECUTE, then lose their response
        # (ResponseLostError) — the in-process drop_response_next analog
        self._drop_response = 0
        # sustained API latency (seconds) applied to every control-plane
        # verb (describes, price books, fleet, terminate) — the in-process
        # analog of a degraded cloud; scenario primitives raise it mid-storm
        # and drop it back to zero
        self.api_latency: float = 0.0
        # call capture
        self.create_fleet_calls: List[FleetRequest] = []
        self.terminate_calls: List[str] = []
        self.describe_calls: int = 0

    # -- describe APIs -------------------------------------------------------

    def _simulate_latency(self) -> None:
        with self._lock:
            delay = self.api_latency
        # sleep OUTSIDE the lock: injected slowness must not serialize every caller
        if delay > 0:
            self.clock.sleep(delay)

    def inject_api_latency(self, seconds: float) -> None:
        """Degrade (or restore, with 0) the control plane's response time."""
        with self._lock:
            self.api_latency = max(0.0, seconds)

    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        self._simulate_latency()
        with self._lock:
            self.describe_calls += 1
            return list(self.catalog)

    def describe_subnets(self, tag_selector: Optional[Dict[str, str]] = None) -> List[Subnet]:
        self._simulate_latency()
        subnets = list(self.subnets)
        if tag_selector:
            subnets = [s for s in subnets if all(s.tags.get(k) == v for k, v in tag_selector.items())]
        return subnets

    def describe_security_groups(self, tag_selector: Optional[Dict[str, str]] = None) -> List["SecurityGroup"]:
        self._simulate_latency()
        groups = list(self.security_groups)
        if tag_selector:
            groups = [g for g in groups if all(g.tags.get(k) == v for k, v in tag_selector.items())]
        return groups

    def get_on_demand_price(self, type_name: str) -> Optional[float]:
        with self._lock:
            return self._od_price_locked(type_name)

    def get_spot_price(self, type_name: str, zone: str) -> Optional[float]:
        with self._lock:
            return self._spot_price_locked(type_name, zone)

    def _od_price_locked(self, type_name: str) -> Optional[float]:
        return self.od_prices.get(type_name)

    def _spot_price_locked(self, type_name: str, zone: str) -> Optional[float]:
        return self.spot_prices.get((type_name, zone))

    def describe_prices(self) -> Tuple[Dict[str, float], Dict[Tuple[str, str], float]]:
        """Bulk price books (on-demand, spot) — one call per pricing refresh
        instead of one per (type, zone), which is what keeps the HTTP
        transport (api.py) from turning every refresh into a call storm."""
        self._simulate_latency()
        with self._lock:
            return dict(self.od_prices), dict(self.spot_prices)

    # -- launch templates -------------------------------------------------------

    def ensure_launch_template(self, name: str, image_id: str, security_group_ids: Sequence[str], user_data: str) -> LaunchTemplate:
        with self._lock:
            existing = self.launch_templates.get(name)
            if existing is not None:
                return existing
            template = LaunchTemplate(
                template_id=f"lt-{next(self._template_counter):06d}",
                name=name,
                image_id=image_id,
                security_group_ids=tuple(security_group_ids),
                user_data=user_data,
            )
            self.launch_templates[name] = template
            return template

    def delete_launch_template(self, name: str) -> None:
        with self._lock:
            self.launch_templates.pop(name, None)

    # -- fleet ---------------------------------------------------------------------

    def drop_response_next(self, n: int) -> None:
        """The next n create_fleet calls run to completion — the instance
        launches — but raise ResponseLostError instead of returning, so the
        caller cannot tell a launch happened. A retry with the same client
        token replays the settled launch; a token-less retry double-launches
        (which is exactly what the idempotency tests prove)."""
        with self._lock:
            self._drop_response = max(0, n)

    def set_pool_capacity(self, instance_type: str, zone: str, capacity_type: str, capacity: Optional[int]) -> None:
        """Give a pool FINITE remaining capacity (`capacity` launches left;
        0 = exhausted right now), or restore it to infinite with None. The
        seam the capacity-crunch scenarios drive: exhausting the cheapest
        pool mid-burst makes create_fleet return partial results / typed
        ICEs instead of capacity."""
        pool = (instance_type, zone, capacity_type)
        with self._lock:
            if capacity is None:
                self.capacity_pools.pop(pool, None)
            else:
                self.capacity_pools[pool] = max(0, int(capacity))

    def pool_capacity(self, instance_type: str, zone: str, capacity_type: str) -> Optional[int]:
        """Remaining units of a finite pool; None = infinite."""
        with self._lock:
            return self.capacity_pools.get((instance_type, zone, capacity_type))

    def _pool_exhausted_locked(self, pool: Tuple[str, str, str]) -> bool:
        return pool in self.insufficient_capacity_pools or self.capacity_pools.get(pool, 1) <= 0

    def create_fleet(self, request: FleetRequest) -> FleetResult:
        """Launch up to `request.count` instances, cheapest available spec
        first (the lowest-price / capacity-optimized strategies collapse to
        this in a simulator with explicit price books), draining finite
        pools as they go. Returns PER-ITEM results: the fulfilled instances
        plus one typed `InsufficientCapacityError` entry per unfulfilled
        item, and the exhausted pools skipped en route even on success. A
        call that fulfills nothing raises `InsufficientCapacityError`.

        Idempotent under client tokens: a token seen before replays the
        original result without launching (EC2 ClientToken semantics); the
        lock serializes a retry racing the original call."""
        self._simulate_latency()
        with self._lock:
            if request.client_token:
                settled = self.fleet_tokens.get(request.client_token)
                if settled is not None:
                    return settled
            if self.next_error is not None:
                err, self.next_error = self.next_error, None
                raise err
            self.create_fleet_calls.append(request)
            # EC2 rejects specs whose launch template is gone; if nothing
            # launchable remains, surface the stale ids so the caller can
            # re-sync its cache
            known_templates = {t.template_id for t in self.launch_templates.values()}
            stale = {s.launch_template_id for s in request.specs if s.launch_template_id not in known_templates}
            specs = [s for s in request.specs if s.launch_template_id in known_templates]
            if not specs and stale:
                raise LaunchTemplateNotFoundError(stale)
            count = max(1, int(request.count))
            priced: List[Tuple[float, FleetInstanceSpec]] = []
            for spec in specs:
                if spec.capacity_type == "spot":
                    price = self._spot_price_locked(spec.instance_type, spec.zone)
                else:
                    price = self._od_price_locked(spec.instance_type)
                if price is not None:
                    priced.append((price, spec))
            priced.sort(key=lambda pair: pair[0])
            instances: List[FleetInstance] = []
            unavailable: List[Tuple[str, str, str]] = []
            seen_unavailable: Set[Tuple[str, str, str]] = set()
            for _ in range(count):
                chosen: Optional[FleetInstanceSpec] = None
                for _price, spec in priced:
                    pool = (spec.instance_type, spec.zone, spec.capacity_type)
                    if self._pool_exhausted_locked(pool):
                        if pool not in seen_unavailable:
                            seen_unavailable.add(pool)
                            unavailable.append(pool)
                        continue
                    chosen = spec
                    break
                if chosen is None:
                    break
                pool = (chosen.instance_type, chosen.zone, chosen.capacity_type)
                if pool in self.capacity_pools:
                    self.capacity_pools[pool] -= 1
                instances.append(
                    FleetInstance(
                        instance_id=f"i-{next(self._instance_counter):08d}",
                        instance_type=chosen.instance_type,
                        subnet_id=chosen.subnet_id,
                        zone=chosen.zone,
                        capacity_type=chosen.capacity_type,
                        launched_at=self.clock.now(),
                    )
                )
            if not instances:
                raise InsufficientCapacityError(
                    unavailable or [(s.instance_type, s.zone, s.capacity_type) for s in request.specs]
                )
            for instance in instances:
                self.instances[instance.instance_id] = instance
            failed_pools = unavailable or [(s.instance_type, s.zone, s.capacity_type) for s in request.specs]
            result = FleetResult(
                instances=instances,
                errors=[InsufficientCapacityError(failed_pools) for _ in range(count - len(instances))],
                unavailable_pools=list(unavailable),
            )
            if request.client_token:
                # the result (instances AND shortfall errors) is the settled
                # record for this token: a retry replays it verbatim, so a
                # lost response never double-launches and a failed item is
                # never resurrected by replay — the caller re-requests the
                # shortfall under a NEW token once capacity returns
                while len(self.fleet_tokens) >= self._fleet_token_cap:
                    del self.fleet_tokens[next(iter(self.fleet_tokens))]
                self.fleet_tokens[request.client_token] = result
                # the double-launch witness: this call EXECUTED (it is not
                # a replay — replays returned above); a second execution
                # under the same token is the failure the ledger exists to
                # catch, so it outlives the replay cap (own bound, overflow
                # folded into the running total at eviction)
                self.token_launches[request.client_token] = self.token_launches.get(request.client_token, 0) + 1
                while len(self.token_launches) > self._fleet_token_cap * 4:
                    evicted = next(iter(self.token_launches))
                    executions = self.token_launches.pop(evicted)
                    if executions > 1:
                        self._double_launches_evicted += executions - 1
            if self._drop_response > 0:
                # the launch HAPPENED (and its token is settled above); only
                # the response is lost — a tokened retry replays it
                self._drop_response -= 1
                raise ResponseLostError(
                    f"create_fleet response lost ({len(instances)} instance(s) launched)"
                )
            return result

    def terminate_instance(self, instance_id: str) -> None:
        self._simulate_latency()
        with self._lock:
            self.terminate_calls.append(instance_id)
            instance = self.instances.pop(instance_id, None)
            existed = instance is not None
            self.pending_reclaims.pop(instance_id, None)
            if existed:
                # a finite pool regains the capacity its instance occupied
                # (real clouds free the slot on terminate)
                pool = (instance.instance_type, instance.zone, instance.capacity_type)
                if pool in self.capacity_pools:
                    self.capacity_pools[pool] += 1
        if existed:
            self.notifications.send({"kind": "instance_terminated", "instance_id": instance_id})

    def instance_exists(self, instance_id: str) -> bool:
        with self._lock:
            return instance_id in self.instances

    def double_launches(self) -> int:
        """The client-token ledger's verdict: launches that EXECUTED more
        than once under one token (evicted offenders included). Idempotency
        (and leader-flap safety — two leaders racing one logical launch)
        means this must be zero; the chaos scenarios score it as
        `double_launches`."""
        with self._lock:
            return self._double_launches_evicted + sum(n - 1 for n in self.token_launches.values() if n > 1)

    def list_instances(self) -> List[FleetInstance]:
        """Every live instance — the DescribeInstances sweep the GC
        controller reconciles against node objects."""
        self._simulate_latency()
        with self._lock:
            return list(self.instances.values())

    # -- lifecycle notifications (the EventBridge-rule analogs) --------------
    # Fault-injection seams: tests and chaos drivers call these to make the
    # cloud misbehave; each feeds the notification queue the way EventBridge
    # feeds the reference's SQS queue.

    def interrupt_spot_instance(self, instance_id: str, warning_seconds: float = None) -> Optional[float]:
        """Issue a spot interruption warning: the instance will be reclaimed
        `warning_seconds` (default: the EC2 2-minute lead) from now. Returns
        the absolute deadline, or None for an unknown instance — though a
        notice for an unknown id can still be forced onto the queue with
        notifications.send() (the consumer must tolerate it)."""
        from .notifications import SPOT_INTERRUPTION_WARNING

        if warning_seconds is None:
            warning_seconds = SPOT_INTERRUPTION_WARNING
        with self._lock:
            if instance_id not in self.instances:
                return None
            deadline = self.clock.now() + warning_seconds
            self.pending_reclaims[instance_id] = deadline
        self.notifications.send({"kind": "spot_interruption", "instance_id": instance_id, "deadline": deadline})
        return deadline

    def recommend_rebalance(self, instance_id: str) -> None:
        """EC2 rebalance recommendation: elevated reclaim risk, no deadline."""
        self.notifications.send({"kind": "rebalance_recommendation", "instance_id": instance_id})

    def schedule_maintenance(self, instance_id: str, not_before_seconds: float = 600.0) -> float:
        """Scheduled maintenance (the scheduled-change health event analog)."""
        not_before = self.clock.now() + not_before_seconds
        self.notifications.send({"kind": "scheduled_maintenance", "instance_id": instance_id, "not_before": not_before})
        return not_before

    def stop_instance(self, instance_id: str) -> None:
        """Stop an instance out from under its node (state-change event)."""
        with self._lock:
            instance = self.instances.pop(instance_id, None)
            existed = instance is not None
            self.pending_reclaims.pop(instance_id, None)
            if existed:
                pool = (instance.instance_type, instance.zone, instance.capacity_type)
                if pool in self.capacity_pools:
                    self.capacity_pools[pool] += 1
        if existed:
            self.notifications.send({"kind": "instance_stopped", "instance_id": instance_id})

    def reclaim_due_instances(self) -> List[str]:
        """Reclaim every spot instance whose interruption deadline has
        passed (the cloud making good on its warnings). Returns the ids
        reclaimed; each emits instance_terminated via terminate_instance."""
        with self._lock:
            now = self.clock.now()
            due = [i for i, deadline in self.pending_reclaims.items() if deadline <= now]
        for instance_id in due:
            self.terminate_instance(instance_id)
        return due

    def reset(self) -> None:
        with self._lock:
            self.insufficient_capacity_pools = set()
            self.capacity_pools = {}
            self.next_error = None
            self._drop_response = 0
            self.api_latency = 0.0
            self.create_fleet_calls = []
            self.terminate_calls = []
