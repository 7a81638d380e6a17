"""Lease-based leader election over the coordination.k8s.io API.

The reference elects through controller-runtime's resourcelock.LeaseLock
(controllers.go:104-106: LeaderElection with id "karpenter-leader-election").
Same protocol here: candidates race to create/update a Lease; the holder
renews before leaseDuration expires; a candidate acquires when the lease is
unheld or its renewTime is older than leaseDuration (the previous holder
died). Optimistic concurrency (resourceVersion 409s from the apiserver)
serializes the race — exactly the client-go leaderelection loop.

Flap hardening (the control-plane fault domain): the run loop reports BOTH
transitions — `on_started_leading` and `on_stopped_leading` — so a holder
whose lease is stolen or whose renew fails steps its loops down before the
successor's recovery acts; every lost transition is counted, and a legal
competing writer can steal the lease outright (`steal_lease`) to prove it.

The port's copy of karpenter_tpu/kube/leaderelection.py. Left out: the
control-plane fault plan's hooks (ROADMAP A7) and the flap counter's
registry family and journal events (A8): each elector counts its lost
transitions in a plain `flaps` tally.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..api.objects import Lease, LeaseSpec, ObjectMeta
from ..logsetup import get_logger
from .cluster import Conflict, NotFound

log = get_logger("leaderelection")

LEASE_NAME = "karpenter-leader-election"
LEASE_NAMESPACE = "kube-system"

class LeaseElector:
    """client-go leaderelection.LeaderElector analog (defaults from
    controller-runtime: 15s lease, 10s renew deadline, 2s retry)."""

    def __init__(
        self,
        kube,
        identity: str,
        lease_duration: float = 15.0,
        renew_period: float = 2.0,
        name: str = LEASE_NAME,
        namespace: str = LEASE_NAMESPACE,
        clock=None,
    ):
        from ..utils.clock import Clock

        self.kube = kube
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.name = name
        self.namespace = namespace
        self.clock = clock or getattr(kube, "clock", None) or Clock()
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # leadership transitions LOST (failed renew, stolen lease, transport
        # outage): each pauses the singleton loops and forces the next
        # acquisition to run recovery before acting
        self.flaps = 0
        # the CAS verb: a stale write must surface as Conflict (losing the
        # round), never be transparently retried over the winner
        self._cas_update = getattr(kube, "update_no_retry", kube.update)

    # -- one protocol step ----------------------------------------------------

    def try_acquire_or_renew(self) -> bool:
        """One election round: returns True while this candidate holds the
        lease. Conflicts (another candidate wrote first) just mean we lost
        the round — retry next period."""
        import copy

        now = self.clock.now()
        lease = self.kube.get("Lease", self.name, self.namespace)
        # deepcopy before mutating: an in-memory backend returns live shared
        # references, and the CAS below is only meaningful when our write
        # carries the resourceVersion we actually observed
        lease = copy.deepcopy(lease) if lease is not None else None
        if lease is None:
            fresh = Lease(
                metadata=ObjectMeta(name=self.name, namespace=self.namespace),
                spec=LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=int(self.lease_duration),
                    acquire_time=now,
                    renew_time=now,
                    lease_transitions=0,
                ),
            )
            try:
                self.kube.create(fresh)
                return True
            except Conflict:
                return False
        if lease.spec.holder_identity == self.identity:
            lease.spec.renew_time = now
            try:
                self._cas_update(lease)
                return True
            except (Conflict, NotFound):
                return False
        # another holder: take over only if its lease expired
        renew = lease.spec.renew_time or 0.0
        if now - renew < float(lease.spec.lease_duration_seconds or self.lease_duration):
            return False
        lease.spec.holder_identity = self.identity
        lease.spec.acquire_time = now
        lease.spec.renew_time = now
        lease.spec.lease_transitions = (lease.spec.lease_transitions or 0) + 1
        try:
            self._cas_update(lease)
            log.info("leader election: %s acquired expired lease (transition %d)", self.identity, lease.spec.lease_transitions)
            return True
        except (Conflict, NotFound):
            return False

    # -- background loop ------------------------------------------------------

    def start(
        self,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> "LeaseElector":
        def fire(callback, transition: str) -> None:
            if callback is None:
                return
            try:
                callback()
            except Exception:  # noqa: BLE001 - a callback must not kill the loop
                log.exception("leader election: %s %s callback failed", self.identity, transition)

        def run():
            while not self._stop.is_set():
                try:
                    held = self.try_acquire_or_renew()
                except Exception as exc:  # noqa: BLE001 - transport outage
                    # an unreachable apiserver means we cannot prove we still
                    # hold the lease: step down rather than free-run as a
                    # false leader, and keep retrying
                    log.warning("leader election: %s round failed (%s); assuming not held", self.identity, exc)
                    held = False
                if held and not self._leading.is_set():
                    log.info("leader election: %s became leader", self.identity)
                    self._leading.set()
                    fire(on_started_leading, "started-leading")
                elif not held and self._leading.is_set():
                    # failed to renew (or the lease was stolen): step down —
                    # the stopped callback runs BEFORE the next round, so the
                    # old leader's loops pause before any successor's
                    # recovery can act on the cluster
                    log.warning("leader election: %s lost the lease", self.identity)
                    self.flaps += 1
                    self._leading.clear()
                    fire(on_stopped_leading, "stopped-leading")
                self._stop.wait(self.renew_period)

        self._thread = threading.Thread(target=run, daemon=True, name=f"lease-elector-{self.identity}")
        self._thread.start()
        return self

    def is_leader(self) -> bool:
        return self._leading.is_set()

    @property
    def thread(self) -> Optional[threading.Thread]:
        """The election loop's thread (None before start)."""
        return self._thread

    def wait_for_leadership(self, timeout: float = 30.0) -> bool:
        return self._leading.wait(timeout)

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if release and self._leading.is_set():
            lease = self.kube.get("Lease", self.name, self.namespace)
            if lease is not None and lease.spec.holder_identity == self.identity:
                # voluntary release: zero the renew time so successors
                # acquire immediately instead of waiting out the duration
                lease.spec.renew_time = 0.0
                try:
                    self._cas_update(lease)
                except (Conflict, NotFound):
                    pass
        self._leading.clear()


def steal_lease(kube, identity: str = "chaos-thief", name: str = LEASE_NAME, namespace: str = LEASE_NAMESPACE, clock=None) -> bool:
    """Adversarially overwrite the lease holder mid-renew. The steal itself obeys optimistic concurrency (a CAS
    loop), because a thief that bypassed the protocol would prove nothing:
    the point is that a LEGAL competing writer can take the lease, and the
    displaced holder must step down on its next renew round. The thief never
    renews, so the lease expires after `lease_duration` and a real candidate
    re-acquires. Returns True when the steal landed."""
    import copy

    from ..utils.clock import Clock

    clock = clock or getattr(kube, "clock", None) or Clock()
    cas = getattr(kube, "update_no_retry", kube.update)
    for _ in range(16):
        lease = kube.get("Lease", name, namespace)
        if lease is None:
            return False
        lease = copy.deepcopy(lease)
        now = clock.now()
        lease.spec.holder_identity = identity
        lease.spec.acquire_time = now
        lease.spec.renew_time = now
        lease.spec.lease_transitions = (lease.spec.lease_transitions or 0) + 1
        try:
            cas(lease)
        except Conflict:
            continue  # the holder renewed under us: retry the steal
        except NotFound:
            return False
        log.warning("lease %s stolen by %s (transition %d)", name, identity, lease.spec.lease_transitions)
        return True
    return False
