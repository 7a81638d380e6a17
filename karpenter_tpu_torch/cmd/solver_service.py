"""Solver-service entry point: run the gRPC sidecar that owns the GPU.

    python -m karpenter_tpu_torch.cmd.solver_service --address 127.0.0.1:7473

The control plane connects with --solver-service-address (utils/options.py).

The port's copy of karpenter_tpu/cmd/solver_service.py, for one card. The
multi-host fabric (--coordinator, or $KARPENTER_TPU_COORDINATOR) is not
ported yet: either raises NotImplementedError (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import os
import threading

from ..logsetup import configure, get_logger
from ..service.server import serve

log = get_logger("solver-service")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="karpenter-tpu-solver")
    parser.add_argument("--address", default="127.0.0.1:7473")
    parser.add_argument("--log-level", default="info")
    parser.add_argument("--coordinator", default=None, help="multi-host fabric coordinator (host:port); also KARPENTER_TPU_COORDINATOR")
    args = parser.parse_args(argv)
    if args.coordinator or os.environ.get("KARPENTER_TPU_COORDINATOR"):
        raise NotImplementedError("--coordinator: the multi-host fabric (parallel/multihost) is not ported yet (ROADMAP A12)")
    configure(args.log_level)
    # SIGTERM (the kubelet's termination signal) stops the server exactly
    # like Ctrl-C
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    server = None
    try:
        server, port, _ = serve(args.address)
        stop.wait()
    finally:
        if server is not None:
            server.stop(grace=2.0)


if __name__ == "__main__":
    main()
