"""An idle peer fabric survives its process group's timeout.

Two OS processes join one torch.distributed group over 127.0.0.1 (gloo,
two logical CPU blocks each) with a collective timeout of TIMEOUT_S. The
peer waits in the fabric's header broadcast (parallel/peers.py) while the
coordinator stays idle for IDLE_S, well past that timeout, as a deployed
`--coordinator` sidecar does between batches; then the coordinator serves
one dense solve over the fleet and releases the peer. Both processes must
exit 0, the solve place every pod, and the peer have seen the
coordinator's keep-alive headers.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 3.0
IDLE_S = 8.0
PODS = 24
DEADLINE_S = 180.0  # the whole fleet, start-up included

CHILD = r"""
import json, sys, time
import torch.distributed as dist
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.parallel.multihost import initialize
from karpenter_tpu_torch.parallel.peers import PeerFabric, _demo_pods
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver

coordinator, pid, timeout, idle, count = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4]), int(sys.argv[5])
initialize(coordinator, 2, pid, backend="gloo", device="cpu", timeout=timeout)
try:
    fabric = PeerFabric(device="cpu", blocks=2)
    if fabric.is_coordinator():
        time.sleep(idle)
        pods = _demo_pods(count)
        dense = DenseSolver(min_batch=1, device="cpu", peer_fabric=fabric)
        try:
            results = build_scheduler([Provisioner()], FakeCloudProvider(instance_types(16)), pods, dense_solver=dense).solve(pods)
        finally:
            fabric.shutdown(best_effort=True)
        out = {
            "scheduled": sum(len(n.pods) for n in results.new_nodes),
            "sharded_batches": dense.stats.sharded_batches,
            "keepalives": fabric.keepalives,
        }
    else:
        out = {"served": fabric.serve(), "keepalives": fabric.keepalives}
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_an_idle_fleet_serves_a_solve_after_the_group_timeout():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CHILD, coordinator, str(pid), str(TIMEOUT_S), str(IDLE_S), str(PODS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=DEADLINE_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    coord, peer = (json.loads(out.strip().splitlines()[-1]) for out, _err in outs)
    assert coord["scheduled"] == PODS and coord["sharded_batches"] >= 1
    assert peer["served"] >= 1
    # a header at least every quarter of the timeout while idle
    assert coord["keepalives"] >= IDLE_S // TIMEOUT_S and peer["keepalives"] == coord["keepalives"]
