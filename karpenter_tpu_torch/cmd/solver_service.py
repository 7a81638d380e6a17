"""Solver-service entry point: run the gRPC sidecar that owns the GPU.

    python -m karpenter_tpu_torch.cmd.solver_service --address 127.0.0.1:7473

The control plane connects with --solver-service-address (utils/options.py).

Multi-process: start the SAME command in every process with a shared
--coordinator (or KARPENTER_TPU_COORDINATOR) and each process's
KARPENTER_TPU_NUM_PROCESSES and KARPENTER_TPU_PROCESS_ID. Process 0 serves
gRPC and coordinates; every other process enters the peer loop
(parallel/peers.py) and computes its blocks of each sharded solve over the
global mesh, with torch.distributed collectives (nccl across cards).
--backend gloo carries them over the host instead, which processes that
share one card need (NCCL refuses two ranks on one GPU), and
--devices-per-process gives each process that many logical mesh blocks on
its card (default: one block per visible card).

The port's copy of karpenter_tpu/cmd/solver_service.py.
"""

from __future__ import annotations

import argparse
import threading

from ..logsetup import configure, get_logger
from ..service.server import serve

log = get_logger("solver-service")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="karpenter-tpu-solver")
    parser.add_argument("--address", default="127.0.0.1:7473")
    parser.add_argument("--log-level", default="info")
    parser.add_argument("--coordinator", default=None, help="multi-process fabric coordinator (host:port); also KARPENTER_TPU_COORDINATOR")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: nccl)")
    parser.add_argument(
        "--devices-per-process",
        type=int,
        default=None,
        help="logical mesh blocks this process holds on its card (default: one per visible card)",
    )
    args = parser.parse_args(argv)
    configure(args.log_level)
    # join the fabric before any solve: the solver mesh then spans every
    # process's cards
    from ..parallel.multihost import initialize

    if not initialize(coordinator_address=args.coordinator, backend=args.backend):
        run(args.address)
        return
    import torch.distributed as dist

    from ..parallel.peers import PeerFabric

    try:
        fabric = PeerFabric(blocks=args.devices_per_process)
        if fabric.is_coordinator():
            run(args.address, fabric)
        else:
            # peers never serve RPC: they follow the coordinator's solves
            # through the broadcast barrier until released
            log.info("process %d entering the peer loop", fabric.process_index)
            fabric.serve()
    finally:
        dist.destroy_process_group()


def run(address: str, fabric=None) -> None:
    """Serve gRPC until SIGTERM or SIGINT; with a fabric, solve over its
    mesh and release its peers on the way out."""
    # SIGTERM (the kubelet's termination signal) must release the peer
    # barrier exactly like Ctrl-C, and so must any startup failure — a
    # coordinator that dies silently leaves every peer wedged
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    server = None
    try:
        dense_solver = None
        if fabric is not None:
            from ..solver import DenseSolver

            dense_solver = DenseSolver(min_batch=1, peer_fabric=fabric)
        server, port, _ = serve(address, dense_solver=dense_solver)
        # a timed wait: a signal the kernel hands to one of grpc's or gloo's
        # threads wakes no untimed wait of the main thread, and the handler
        # runs only once the main thread runs Python again
        while not stop.wait(0.5):
            pass
    finally:
        if server is not None:
            server.stop(grace=2.0).wait()
        if fabric is not None:
            fabric.shutdown(best_effort=True)


if __name__ == "__main__":
    main()
