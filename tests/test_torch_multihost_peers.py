"""Multi-process peer execution (parallel/peers.py) on the port, held against the JAX package.

tests/test_multihost_peers.py's two cases on the port: two OS processes join
one torch.distributed group over 127.0.0.1 (gloo, 4 logical CPU blocks
each: an 8-block global mesh), process 0 runs production scheduler solves
through DenseSolver(peer_fabric=...), and process 1 computes its blocks of
every sharded dispatch in lockstep. The coordinator's placements are held
against an in-process port solve of the same pods, which takes no mesh.
A third case, with no reference counterpart, plants a kernel fault on one
process after the payload broadcast and checks that both processes end.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.parallel.peers import _demo_pods, demo_layout, run_demo_fleet
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_process_layout(pod_count: int) -> list:
    pods = _demo_pods(pod_count)
    solver = DenseSolver(min_batch=1, device="cpu", use_mesh=False)
    results = build_scheduler([Provisioner()], FakeCloudProvider(instance_types(64)), pods, dense_solver=solver).solve(pods)
    assert solver.stats.pods_committed > 0
    return demo_layout(results)


def test_two_process_spmd_production_solve():
    outs = run_demo_fleet(n_processes=2, devices_per_process=4, pod_count=96, timeout=240, device="cpu", backend="gloo")
    coord, peer = outs[0], outs[1]

    # the fabric really was global: both processes saw all 8 blocks, and the
    # mesh factorization covers them with the types axis inside a process
    assert coord["devices"] == 8 and peer["devices"] == 8
    mesh = coord["mesh"]
    assert mesh["pods"] * mesh["types"] == 8
    assert mesh["types"] <= 4
    assert coord["backend"] == peer["backend"] == "gloo"

    # the production solve went through: every pod scheduled, and the dense
    # path (the sharded dispatch the peer mirrored) carried real work
    assert coord["scheduled"] == coord["requested"] == 96
    assert coord["unschedulable"] == 0
    assert coord["dense_committed"] > 0 and coord["sharded_batches"] >= 1
    assert coord["layouts"] == [_in_process_layout(96)]

    # the peer entered at least one solve and was released cleanly
    assert peer["served"] >= 1


def test_sequential_solves_reuse_the_fabric():
    """Three production solves through ONE long-lived fabric: the peers stay
    in the serve loop across solves, and the catalog epoch broadcast happens
    once, not per solve."""
    outs = run_demo_fleet(n_processes=2, devices_per_process=4, pod_count=48, timeout=240, solves=3, device="cpu", backend="gloo")
    coord, peer = outs[0], outs[1]

    assert coord["solves"] == 3
    assert coord["scheduled"] == coord["requested"] == 48 * 3
    assert coord["unschedulable"] == 0
    assert coord["dense_batches"] == 3
    # the catalog rode the wire exactly once; later solves reused the epoch
    assert coord["catalog_broadcasts"] == 1
    assert coord["layouts"] == [_in_process_layout(48)] * 3
    # the peer mirrored every solve's dispatches and was released ONCE at
    # the end — it never dropped out of lockstep between solves
    assert peer["served"] >= 3


# -- a fault under the fabric ------------------------------------------------------

# one process of a two-process gloo fabric (4 CPU blocks each): K1's keyed
# call raises a kernel fault on this process's first block of the first
# solve when its rank is `faulty`. Process 0 dispatches two solves and
# records what each gave; process 1 serves. Prints a JSON line.
_FAULTED_FABRIC = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
from karpenter_tpu_torch.parallel import multihost, peers, sharded
from karpenter_tpu_torch.solver.faults import SolverKernelError

rank, coordinator, faulty = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
multihost.initialize(coordinator, 2, rank, backend="gloo", device="cpu")
keyed, calls = sharded.bucket_cost_keyed, []

def flaky(*operands):
    calls.append(1)
    if rank == faulty and len(calls) == 1:
        raise SolverKernelError("injected launch failure on this process's first block")
    return keyed(*operands)

sharded.bucket_cost_keyed = flaky
fabric = peers.PeerFabric(device="cpu", blocks=4)
out = {"rank": rank}
try:
    if rank:
        out["served"] = fabric.serve()
    else:
        stats, caps, prices, allowed = testing.bucket_cost_problem(np.random.default_rng(5), 29, 37, 4)
        want = bucket_type_cost_packed(*(torch.from_numpy(a) for a in (stats, caps, prices, allowed))).numpy()
        caps_p, prices_p = sharded.pad_catalog(fabric.mesh, caps, prices)
        stats_p, allowed_p = sharded.pad_batch(fabric.mesh, stats, allowed, caps_p.shape[0])
        out["solves"] = []
        for _ in range(2):
            try:
                got = fabric.dispatch(stats_p, caps_p, prices_p, allowed_p).wait()[:, :29]
                out["solves"].append(["ok", bool(np.array_equal(got, want))])
            except Exception as exc:
                out["solves"].append([type(exc).__name__, str(exc)])
        fabric.shutdown(best_effort=True)
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.parametrize("faulty", [0, 1], ids=["coordinator", "peer"])
def test_a_fault_under_the_fabric_ends_no_process_in_a_collective(faulty):
    """A block that fails after the payload broadcast: the failing process
    still enters the gather with its status set, so both processes end
    within the timeout. The coordinator's fault leaves the fleet in
    lockstep: it raises that fault, the next solve is bit-equal to one
    unsharded K1, and SHUTDOWN releases the peer. A peer's fault ends that
    peer (serve() raises it) and the coordinator raises SolverDeviceLostError
    for that solve and the next, sending nothing more."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _FAULTED_FABRIC, str(rank), coordinator, str(faulty)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    coord = json.loads(outs[0][0].strip().splitlines()[-1])
    if faulty == 0:
        assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
        assert coord["solves"][0][0] == "SolverKernelError"
        assert coord["solves"][1] == ["ok", True]
        assert json.loads(outs[1][0].strip().splitlines()[-1])["served"] == 1
    else:
        assert procs[0].returncode == 0, outs[0][1][-2000:]
        assert procs[1].returncode != 0 and "SolverKernelError" in outs[1][1]
        assert [kind for kind, _ in coord["solves"]] == ["SolverDeviceLostError", "SolverDeviceLostError"]
        assert "process(es) [1]" in coord["solves"][0][1]
