"""Exact minimum-cost packing reference for cost-regret measurement.

The BASELINE target says the production solver's node cost must stay within
3% of an exhaustive ILP. The reference repo never measures this (its
instance_selection_test.go:38 suite only asserts cheapest-single-choice
behavior); this module is the measuring stick: a mixed-integer program over
node slots that computes the true minimum node cost for small instances
(<=~50 pods x ~20 types), solved with HiGHS via scipy.optimize.milp.

This is a test/bench harness, not a production path: the MILP is exponential
in the worst case and is deliberately capped by `time_limit`. Production
solves go through DenseSolver/Scheduler; tests/test_cost_regret.py compares
the two and asserts the <=3% gate.

Formulation (slot model):
  z[n,t] = 1 iff node slot n is realized as instance type t
  x[p,n] = 1 iff pod p lands on slot n
  min  sum_{n,t} price[t] z[n,t]
  s.t. each pod placed exactly once; per-slot capacity over every resource
       (slot capacity = chosen type's allocatable, so an unused slot has
       zero capacity and can host nothing because every pod requests
       pods>=1); at most one type per slot; pods only on slots whose type
       is requirement-compatible; slots used in order (symmetry breaking).

The port's copy of karpenter_tpu/solver/optimal.py: numpy and scipy on the
host, as in the JAX package; it is a yardstick, not a device path. scipy
is a requirement here: the JAX package's import fallback (status
"unavailable") is gone, so a missing scipy raises instead of skipping the
measurement. problem_matrices reads the port's own scheduling/requirements.py
and utils/resources.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class OptimalResult:
    cost: float
    status: str  # "optimal" | "timeout" | "infeasible" | "failed(...)"
    nodes: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def optimal_node_cost(
    requests: np.ndarray,
    caps: np.ndarray,
    prices: np.ndarray,
    compat: Optional[np.ndarray] = None,
    max_slots: Optional[int] = None,
    time_limit: float = 60.0,
) -> OptimalResult:
    """Minimum total node price to place every pod.

    requests: [P, R] pod resource requests (include the synthetic `pods`
              resource at 1.0 per pod so per-type pod density binds).
    caps:     [T, R] allocatable per type (resources minus overhead minus
              any daemonset overhead — the same effective capacity the
              scheduler packs against).
    prices:   [T]
    compat:   [P, T] bool requirement-compatibility mask (default all-true).
    """
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp

    requests = np.asarray(requests, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.float64)
    prices = np.asarray(prices, dtype=np.float64)
    P, R = requests.shape
    T = caps.shape[0]
    if compat is None:
        compat = np.ones((P, T), dtype=bool)
    # a pod with no compatible type makes the whole instance infeasible
    if not compat.any(axis=1).all():
        return OptimalResult(cost=float("nan"), status="infeasible")
    N = min(P, max_slots) if max_slots else P

    # variable layout: x[p,n] then z[n,t]
    nx = P * N
    nz = N * T
    nvar = nx + nz

    def xi(p: int, n: int) -> int:
        return p * N + n

    def zi(n: int, t: int) -> int:
        return nx + n * T + t

    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    lo: List[float] = []
    hi: List[float] = []
    row = 0

    def emit(entries, lb, ub):
        nonlocal row
        for c, v in entries:
            rows.append(row)
            cols.append(c)
            vals.append(v)
        lo.append(lb)
        hi.append(ub)
        row += 1

    # 1. each pod on exactly one slot
    for p in range(P):
        emit([(xi(p, n), 1.0) for n in range(N)], 1.0, 1.0)
    # 2. slot capacity per resource: sum_p req[p,r] x[p,n] <= sum_t cap[t,r] z[n,t]
    for n in range(N):
        for r in range(R):
            entries = [(xi(p, n), requests[p, r]) for p in range(P) if requests[p, r] > 0]
            entries += [(zi(n, t), -caps[t, r]) for t in range(T) if caps[t, r] > 0]
            emit(entries, -np.inf, 0.0)
    # 3. at most one type per slot
    for n in range(N):
        emit([(zi(n, t), 1.0) for t in range(T)], -np.inf, 1.0)
    # 4. compatibility: x[p,n] <= sum_t compat[p,t] z[n,t] (skip if all compat)
    if not compat.all():
        for p in range(P):
            incompat_t = np.nonzero(~compat[p])[0]
            if len(incompat_t) == 0:
                continue
            for n in range(N):
                entries = [(xi(p, n), 1.0)]
                entries += [(zi(n, t), -1.0) for t in np.nonzero(compat[p])[0]]
                emit(entries, -np.inf, 0.0)
    # 5. symmetry: used slots first — sum_t z[n,t] >= sum_t z[n+1,t]
    for n in range(N - 1):
        entries = [(zi(n, t), 1.0) for t in range(T)]
        entries += [(zi(n + 1, t), -1.0) for t in range(T)]
        emit(entries, 0.0, np.inf)

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, nvar))
    c = np.zeros(nvar)
    for n in range(N):
        for t in range(T):
            c[zi(n, t)] = prices[t]

    res = milp(
        c=c,
        constraints=LinearConstraint(A, np.asarray(lo), np.asarray(hi)),
        integrality=np.ones(nvar),
        bounds=Bounds(0, 1),
        options={"time_limit": time_limit, "mip_rel_gap": 1e-6},
    )
    if res.status == 0:
        z = res.x[nx:].reshape(N, T)
        return OptimalResult(cost=float(res.fun), status="optimal", nodes=int(round(z.sum())))
    if res.status == 1:  # iteration/time limit
        return OptimalResult(cost=float(res.fun) if res.x is not None else float("nan"), status="timeout")
    if res.status == 2:
        return OptimalResult(cost=float("nan"), status="infeasible")
    # 3 = unbounded (impossible here), 4 = numerical/other solver failure —
    # distinct from infeasibility so harness failures don't masquerade as
    # modeling bugs
    return OptimalResult(cost=float("nan"), status=f"failed({res.status}: {res.message})")


def problem_matrices(pods: Sequence, types: Sequence, template=None):
    """Build (requests, caps, prices, compat) for `optimal_node_cost` from
    the same objects the scheduler consumes, using the same host algebra
    (requirement compatibility, type-overhead subtraction, synthetic pod
    count) so the MILP measures exactly the problem the scheduler solved.
    Assumes no daemonset overhead (the regret instances carry none); if a
    caller schedules with daemonsets it must subtract that overhead from
    the returned caps itself."""
    from ..scheduling.requirements import Requirements
    from ..utils import resources as res

    resource_names = sorted({k for p in pods for k in res.pod_requests(p)} | {"pods"})
    idx = {name: i for i, name in enumerate(resource_names)}
    P, T, R = len(pods), len(types), len(resource_names)

    requests = np.zeros((P, R))
    for i, pod in enumerate(pods):
        for name, v in res.pod_requests(pod).items():
            requests[i, idx[name]] = v
        requests[i, idx["pods"]] = max(requests[i, idx["pods"]], 1.0)

    caps = np.zeros((T, R))
    prices = np.zeros(T)
    for j, it in enumerate(types):
        allocatable = res.subtract(it.resources(), it.overhead())
        for name, v in allocatable.items():
            if name in idx:
                caps[j, idx[name]] = max(v, 0.0)
        prices[j] = it.price()
    # the scheduler packs with res.fits tolerance slack; give the MILP the
    # same headroom so its optimum stays a true lower bound for the
    # tolerant packer (a near-boundary fit must not differ between the two)
    caps = caps + res.tolerance(caps)

    compat = np.ones((P, T), dtype=bool)
    base = list(template.requirements.values()) if template is not None else []
    for i, pod in enumerate(pods):
        pod_reqs = Requirements.from_pod(pod)
        for j, it in enumerate(types):
            node_reqs = Requirements(*base)
            node_reqs.add(*it.requirements().values())
            compat[i, j] = node_reqs.compatible(pod_reqs) is None
    return requests, caps, prices, compat
