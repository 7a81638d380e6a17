"""HostPortUsage: per-node host-port uniqueness tracking.

Mirrors pkg/scheduling/hostportusage.go:31-149 — (ip, port, protocol) entries
with wildcard-IP awareness: 0.0.0.0 conflicts with every IP on the same
(port, protocol) and vice versa.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api.objects import Pod

WILDCARD_IP = "0.0.0.0"


@dataclass(frozen=True)
class HostPortEntry:
    ip: str
    port: int
    protocol: str

    def matches(self, other: "HostPortEntry") -> bool:
        if self.port != other.port or self.protocol != other.protocol:
            return False
        if self.ip == WILDCARD_IP or other.ip == WILDCARD_IP:
            return True
        return self.ip == other.ip


def _entries_for_pod(pod: Pod) -> List[HostPortEntry]:
    entries = []
    for container in list(pod.spec.containers) + list(pod.spec.init_containers):
        for port in container.ports:
            if port.host_port:
                ip = port.host_ip or WILDCARD_IP
                entries.append(HostPortEntry(ip=ip, port=port.host_port, protocol=port.protocol or "TCP"))
    return entries


class HostPortUsage:
    def __init__(self):
        self._reserved: Dict[str, List[HostPortEntry]] = {}  # pod uid -> entries

    def validate(self, pod: Pod) -> Optional[str]:
        """Returns an error string if the pod's host ports conflict."""
        for entry in _entries_for_pod(pod):
            for owner_uid, entries in self._reserved.items():
                if owner_uid == pod.uid:
                    continue
                for existing in entries:
                    if entry.matches(existing):
                        return f"host port {entry.ip}:{entry.port}/{entry.protocol} is already in use"
        return None

    def add(self, pod: Pod) -> None:
        entries = _entries_for_pod(pod)
        if entries:
            self._reserved[pod.uid] = entries

    def delete_pod(self, uid: str) -> None:
        self._reserved.pop(uid, None)

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out._reserved = {uid: list(entries) for uid, entries in self._reserved.items()}
        return out

    def to_wire(self) -> Dict[str, List[tuple]]:
        """Detached plain-data form for the solver-service wire (service/)."""
        return {uid: [(e.ip, e.port, e.protocol) for e in entries] for uid, entries in self._reserved.items()}

    @classmethod
    def from_wire(cls, data: Dict[str, List[tuple]]) -> "HostPortUsage":
        out = cls()
        out._reserved = {uid: [HostPortEntry(*entry) for entry in entries] for uid, entries in data.items()}
        return out
