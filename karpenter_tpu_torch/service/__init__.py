"""Solver service: gRPC sidecar behind the packer boundary (SURVEY §7.3).

Lazy exports: the control plane imports only the client (grpc channel); the
server pulls in the whole solver stack and must not load into client-only
processes.
"""

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .client import RemoteSchedulingError, SolverClient
    from .server import SolverServer, serve

__all__ = ["SolverClient", "SolverServer", "RemoteSchedulingError", "serve"]

_CLIENT = {"SolverClient", "RemoteSchedulingError"}
_SERVER = {"SolverServer", "serve"}


def __getattr__(name):
    if name in _CLIENT:
        from . import client

        return getattr(client, name)
    if name in _SERVER:
        from . import server

        return getattr(server, name)
    raise AttributeError(name)
