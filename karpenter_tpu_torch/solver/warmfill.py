"""Vectorized warm fill: the existing-capacity phase as array programs.

Through round 5 the repack/consolidation flagship spent ~95% of its wall
clock in `DenseSolver._fill_existing` — a sequential host loop that walks
every pod through per-view Python protocol objects, with zero device work
(VERDICT r5, missing #1). This module replaces that loop for the CERTIFIED
COMMON CASE with a three-phase pipeline:

  1. encode  — ir/encode.py:encode_warm_views builds the [views x resources]
     residual-capacity arrays with the exact f64 expressions of the
     certified fast paths; this module adds per-bucket [views] acceptance
     masks (taints deduped by content signature, zone/ct pins, domain
     allow-lists) and integer topology-count states for every group the
     certificates consult.
  2. device  — ops/warmfill.py launches ONE [sizes x views] admission
     kernel (the hand-written CUDA kernel on the card, its plain torch
     version on the CPU): upper-bound closed-form counts used to prune
     views that can never take a size class. The
     device surface is advisory; every placement is re-derived below with
     exact f64 host arithmetic, so f32 boundary rounding costs a probe,
     never a wrong placement.
  3. scan + bulk commit — a host scan over the SAME FFD item stream the
     host loop processes, but against arrays instead of protocol objects:
     plain cohorts commit by closed-form counts, dedicated (anti-affinity /
     hostname-spread) pods by zero-count claims, deferred spread cohorts by
     the pinned-domain skew integers, and deferred zonal affinity by
     populated-domain membership with the host's bootstrap-then-colocate
     rule. The scan's verdict arithmetic is the BucketCert algebra
     (scheduler/existingnode.py) evaluated in bulk, so its placements are
     byte-identical to the host loop's — pinned against the JAX package's
     fill by tests/test_torch_warm_solve.py. Commits then mutate view and
     topology state with the same merge/record call sequence the certified
     paths issue, in the same order.

Fail-open: `plan()` returns None whenever any fill item falls outside the
certified common case — IR-inexpressible extras, host-routed buckets,
single-bin components, cohorts with node requirements, non-trivial spread
node filters, groups a foreign selector counts — and `_fill_existing` runs
the exact host loop unchanged. One algorithm is chosen per solve, never a
mix, so the one global FFD order that decides warm-capacity claims is
always preserved.

The device surface is a pure function of the plan, so it is computed
whenever the plan stays within _DEVICE_MAX_SIZES / _DEVICE_MAX_CELLS; past
those bounds the scan prunes on host alone. A device or kernel failure
propagates out of the solve.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import labels as lbl
from ..flight import FLIGHT
from ..ir.encode import DenseProblem, GroupKind, WarmViewEncoding, encode_warm_views
from ..ops.warmfill import warm_fill_counts_device
from ..utils import resources as res
from .faults import FAULTS, classify

# bucket kinds the scan distinguishes (mirrors the host loop's dispatch)
_PLAIN = 0
_DEDICATED = 1
_SPREAD = 2
_AFFINITY = 3

# device surface bounds: past these the [S, V] counts matrix is computed
# lazily per size class on host instead of shipped to the device
_DEVICE_MAX_SIZES = 4096
_DEVICE_MAX_CELLS = 8_000_000


class _GroupState:
    """Integer domain counts for one TopologyGroup, in the axis the scan
    needs: hostname-keyed groups count per VIEW (each view is its own
    domain; non-view hostnames can't affect the hostname rules — the global
    min is 0 and membership checks are per-view); zone/ct groups count over
    the group's full registered domain list (the skew min ranges over
    domains with no usable views too)."""

    __slots__ = ("group", "key", "counts_v", "domains", "counts_d", "dom_of_view")

    def __init__(self, group, enc: WarmViewEncoding):
        self.group = group
        self.key = group.key
        if group.key == lbl.LABEL_HOSTNAME:
            self.counts_v = np.array([group.domains.get(h, 0) for h in enc.hostname], dtype=np.int64)
            self.domains = None
            self.counts_d = None
            self.dom_of_view = None
        else:
            self.counts_v = None
            self.domains = list(group.domains.keys())
            index = {d: i for i, d in enumerate(self.domains)}
            self.counts_d = np.array([group.domains[d] for d in self.domains], dtype=np.int64)
            labels = enc.zone if group.key == lbl.LABEL_TOPOLOGY_ZONE else enc.ct
            self.dom_of_view = np.array([index.get(d, -1) if d is not None else -1 for d in labels], dtype=np.int64)

    def bump(self, v: int, n: int) -> None:
        if self.counts_v is not None:
            self.counts_v[v] += n
        else:
            d = self.dom_of_view[v]
            if d >= 0:
                self.counts_d[d] += n

    def record_domain(self, v: int, enc: WarmViewEncoding) -> Optional[str]:
        """The domain string a commit on view v records for this group —
        None when the view lacks the label (record_cohort's single-value
        rule skips those)."""
        if self.key == lbl.LABEL_HOSTNAME:
            return enc.hostname[v]
        labels = enc.zone if self.key == lbl.LABEL_TOPOLOGY_ZONE else enc.ct
        return labels[v]


class _BucketSpec:
    __slots__ = ("bucket", "kind", "accept", "accept_perpod", "checks", "records", "aff", "group_index")

    def __init__(self, bucket, kind, accept, accept_perpod, checks, records, aff, group_index):
        self.bucket = bucket
        self.kind = kind
        self.accept = accept  # [V] bool: closed-form paths (no volume gate)
        self.accept_perpod = accept_perpod  # [V] bool: per-pod paths
        self.checks = checks  # [(op, state, arg)]
        self.records = records  # [_GroupState] bumped per placement
        self.aff = aff  # _GroupState of the zonal affinity group, if any
        self.group_index = group_index


class WarmFillPlan:
    __slots__ = ("enc", "specs", "runs", "sizes", "size_rows", "views", "P")

    def __init__(self, enc, specs, runs, sizes, size_rows, views, P):
        self.enc = enc
        self.specs = specs  # {id(bucket): _BucketSpec}
        self.runs = runs  # [(bucket, sid, rows)] in FFD order
        self.sizes = sizes  # [S, R] f64 distinct run sizes
        self.size_rows = size_rows  # [S] one representative pod row per size
        self.views = views
        self.P = P


def plan(scheduler, problem: DenseProblem, buckets, extra_pods: Sequence = (), enc: Optional[WarmViewEncoding] = None) -> Optional[WarmFillPlan]:
    """Build the vectorized-fill plan, or None when any item falls outside
    the certified common case (the caller then runs the host loop).

    `enc` is an optional precomputed encoding of scheduler.existing_nodes —
    the incremental engine (solver/incremental.py) passes its resident
    mirror, byte-equal to a fresh encode_warm_views(views) by the engine's
    parity contract, so a delta pass skips the O(cluster) encode here. One
    whose length does not match the views is not used."""
    if extra_pods:
        return None  # IR-inexpressible extras interleave by full adds
    views = scheduler.existing_nodes
    if not views:
        return None
    from ..scheduler.existingnode import ExistingNodeView
    from ..scheduler.queue import ffd_sort_key

    live = [b for b in buckets if b.pod_rows]
    for bucket in live:
        if bucket.zone == "__infeasible__" or bucket.single_bin:
            return None

    if enc is None or len(enc.hostname) != len(views):
        enc = encode_warm_views(views)
    V = len(views)
    topology = scheduler.topology
    shared_inverse = topology.inverse_owner_index()
    zone_index = {z: i for i, z in enumerate(problem.zones)}
    ct_index = {c: i for i, c in enumerate(problem.capacity_types)}

    # volume gate for the per-pod paths: pod-independent for volume-free
    # pods (every dense pod — classify routes volume carriers to HOST), so
    # one evaluation per view stands in for the per-pod validate
    rep_any = problem.pods[live[0].pod_rows[0]] if live else None
    vol_ok = np.ones((V,), dtype=bool)
    for vi, view in enumerate(views):
        if rep_any is not None and view.volume_usage.validate(rep_any).exceeds(view.volume_limits):
            vol_ok[vi] = False

    # taint verdicts deduped by (toleration signature, view taint signature):
    # one tolerates() call per distinct pair, one row per toleration shape
    taint_rows: Dict[tuple, np.ndarray] = {}

    def taint_row(rep) -> np.ndarray:
        from ..ir.encode import _toleration_signature

        tol_sig = _toleration_signature(rep)
        row = taint_rows.get(tol_sig)
        if row is None:
            verdicts: Dict[tuple, bool] = {}
            row = np.zeros((V,), dtype=bool)
            for vi in range(V):
                sig = enc.taint_sig[vi]
                ok = verdicts.get(sig)
                if ok is None:
                    ok = verdicts[sig] = views[vi].taints.tolerates(rep) is None
                row[vi] = ok
            taint_rows[tol_sig] = row
        return row

    group_states: Dict[int, _GroupState] = {}

    def state_of(g) -> _GroupState:
        gs = group_states.get(id(g))
        if gs is None:
            gs = group_states[id(g)] = _GroupState(g, enc)
        return gs

    specs: Dict[int, _BucketSpec] = {}
    for bucket in live:
        group = problem.groups[bucket.group_index]
        if group.requirements is not None and list(group.requirements.values()):
            return None  # CohortCert territory: per-(bucket, view) full adds
        rep = group.pods[0]
        ctx = topology.cohort_context(rep, inverse_index=shared_inverse)
        cert = ExistingNodeView.certify_bucket(rep, ctx)
        if cert is None or not cert.portless:
            return None
        # every group that would COUNT this cohort must be one the model
        # tracks (its own certified groups), with a trivial node filter
        owned_ids = {id(g) for g in ctx.owned}
        for g in ctx.selected:
            if id(g) not in owned_ids or g.node_filter.terms:
                return None
        checks: List[tuple] = []
        aff: Optional[_GroupState] = None
        for g in cert.anti_groups:
            if g.key != lbl.LABEL_HOSTNAME:
                return None
            checks.append(("zero", state_of(g), 0))
        for g, _pod_domains, self_sel in cert.spread_checks:
            if not self_sel or g.node_filter.terms:
                return None
            if g.key == lbl.LABEL_HOSTNAME:
                checks.append(("hskew", state_of(g), int(g.max_skew)))
            elif g.key in (lbl.LABEL_TOPOLOGY_ZONE, lbl.LABEL_CAPACITY_TYPE):
                checks.append(("skew", state_of(g), int(g.max_skew)))
            else:
                return None
        for g in cert.affinity_groups:
            if g.key != lbl.LABEL_TOPOLOGY_ZONE or aff is not None:
                return None
            aff = state_of(g)
            checks.append(("aff", aff, 0))
        for g in cert.inverse_groups:
            if g.key != lbl.LABEL_HOSTNAME:
                return None
            checks.append(("zero", state_of(g), 0))

        if bucket.dedicated:
            kind = _DEDICATED
            if not any(op in ("zero", "hskew") for op, _s, _a in checks):
                return None  # a dedicated bucket must carry its per-host rule
        elif bucket.deferred_spread:
            kind = _AFFINITY if group.kind == GroupKind.AFFINITY else _SPREAD
            if kind == _AFFINITY and aff is None:
                return None
            if kind == _AFFINITY and sum(1 for op, _s, _a in checks if op != "aff") > 1:
                # certified: the aff rule plus AT MOST one extra integer
                # rule. The bootstrap round enforces the extra through the
                # same admit()/room_vector algebra the per-pod scans use
                # (execute()'s bootstrap branch); cohorts stacking several
                # extra rules still fail open to the host loop wholesale
                return None
        elif group.kind == GroupKind.PLAIN:
            kind = _PLAIN
        else:
            return None

        accept = enc.usable & taint_row(rep)
        if bucket.zone is not None:
            accept &= np.array([z == bucket.zone for z in enc.zone], dtype=bool)
        if bucket.capacity_type is not None:
            accept &= np.array([c == bucket.capacity_type for c in enc.ct], dtype=bool)
        if kind in (_SPREAD, _AFFINITY):
            # the deferred host branch admits only views whose domain the
            # group allows (problem.group_zone_allowed / group_ct_allowed)
            gi = bucket.group_index
            if kind == _AFFINITY or group.topology_key == lbl.LABEL_TOPOLOGY_ZONE:
                allowed = problem.group_zone_allowed[gi]
                dom = np.array(
                    [zone_index.get(z, -1) if z is not None else -1 for z in enc.zone], dtype=np.int64
                )
            else:
                allowed = problem.group_ct_allowed[gi]
                dom = np.array([ct_index.get(c, -1) if c is not None else -1 for c in enc.ct], dtype=np.int64)
            ok = (dom >= 0) & allowed[np.clip(dom, 0, None)]
            accept &= ok
        accept_perpod = accept & vol_ok
        specs[id(bucket)] = _BucketSpec(
            bucket, kind, accept, accept_perpod, checks, [state_of(g) for g in ctx.selected]
            + [state_of(g) for g in shared_inverse.get(rep.uid, ())], aff, bucket.group_index
        )

    # -- FFD item stream, segmented into same-bucket same-size runs ----------
    # categorization order mirrors _fill_existing exactly (plain, then
    # dedicated, then deferred) so the stable sort breaks FFD ties the same
    plain_b = [b for b in live if not (b.dedicated or b.single_bin or b.deferred_spread)]
    special_b = [b for b in live if b.dedicated or b.single_bin]
    deferred_b = [b for b in live if b.deferred_spread and not b.dedicated]
    ordered_b = plain_b + special_b + deferred_b

    # FFD order, vectorized: the key is (-cpu, -mem, creation, uid) per
    # queue.ffd_sort_key, and problem.requests IS resource_vector(
    # pod_requests(pod)) (encode_problem's per-pod cache), so the first two
    # components read straight off the dense arrays. uid is unique, so the
    # lexsort is a total order — identical to the host queue's sort. The
    # stream stays in (row, bucket-index) arrays end to end; a P-scale list
    # of Python tuples here was a measurable slice of the 16k plan cost.
    if ordered_b:
        rows_arr = np.concatenate([np.asarray(b.pod_rows, dtype=np.int64) for b in ordered_b])
        bidx0 = np.repeat(
            np.arange(len(ordered_b), dtype=np.int64), [len(b.pod_rows) for b in ordered_b]
        )
    else:
        rows_arr = np.zeros((0,), dtype=np.int64)
        bidx0 = rows_arr

    # distinct size classes over the whole batch in one vectorized pass;
    # run boundaries are where (bucket, size) changes along the sorted stream
    if rows_arr.size:
        pods_list = problem.pods
        req_items = problem.requests[rows_arr]
        try:
            ts = np.asarray([pods_list[r].metadata.creation_timestamp for r in rows_arr], dtype=np.float64)
            uid = np.asarray([pods_list[r].metadata.uid for r in rows_arr])
            order = np.lexsort((uid, ts, -req_items[:, 1], -req_items[:, 0]))
        except (TypeError, ValueError):  # exotic metadata types: exact key
            order = np.asarray(
                sorted(range(rows_arr.size), key=lambda i: ffd_sort_key(pods_list[rows_arr[i]])),
                dtype=np.int64,
            )
        rows_sorted = rows_arr[order]
        bidx = bidx0[order]
        flat = np.ascontiguousarray(problem.requests)
        # byte-view row dedupe: ~5x faster than axis=0 unique, and request
        # vectors are canonical non-negative floats (no -0.0/NaN aliasing)
        void = flat.view(np.dtype((np.void, flat.dtype.itemsize * flat.shape[1]))).reshape(-1)
        _uniq, inverse = np.unique(void, return_inverse=True)
        inverse = inverse.reshape(-1)
        sid_of_item = inverse[rows_sorted]
        change = np.ones(rows_sorted.size, dtype=bool)
        change[1:] = (sid_of_item[1:] != sid_of_item[:-1]) | (bidx[1:] != bidx[:-1])
        bounds = np.flatnonzero(change).tolist() + [rows_sorted.size]
        # compact sids to the ones actually used, first-use order
        sid_map: Dict[int, int] = {}
        sizes: List[np.ndarray] = []
        size_rows: List[int] = []
        runs: List[tuple] = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            raw = int(sid_of_item[b0])
            sid = sid_map.get(raw)
            if sid is None:
                sid = sid_map[raw] = len(sizes)
                sizes.append(problem.requests[rows_sorted[b0]])
                size_rows.append(int(rows_sorted[b0]))
            runs.append((ordered_b[int(bidx[b0])], sid, rows_sorted[b0:b1].tolist()))
        sizes_arr = np.stack(sizes)
    else:
        runs, sizes_arr, size_rows = [], np.zeros((0, problem.requests.shape[1])), []

    return WarmFillPlan(enc, specs, runs, sizes_arr, np.asarray(size_rows, dtype=np.int64), list(views), problem.P)


def admission_counts(sizes: np.ndarray, head: np.ndarray, solver, head_dev: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """The [S, V] int32 admission surface of host sizes [S, R] and head
    [V, R] (cast to f32) on the solver's device, and the host seconds of the
    round trip's three parts: staging, enqueue, wait.

    `head_dev` is the incremental engine's resident [Vp, R] f32 buffer,
    whose first V rows equal f32(head): given, the kernel reads those rows
    in place and only the sizes move. On a CUDA device it is the solver's
    resident AdmissionSurface: one staged upload (both inputs, or the sizes
    alone), the launch and the copy back enqueued in one call, then one
    wait; the counts are a view of its landing buffer, valid until the next
    call (execute reads them at once). On the CPU the kernel wrapper takes
    its plain version, on head_dev[:V] where given."""
    V = head.shape[0]
    if solver.admission_surface is not None:
        if head_dev is not None:
            return solver.admission_surface.counts_resident(sizes, head_dev, V)
        return solver.admission_surface.counts(sizes, head)
    t0 = time.perf_counter()
    sizes_t = torch.from_numpy(sizes.astype(np.float32))
    head_t = head_dev[:V] if head_dev is not None else torch.from_numpy(head.astype(np.float32))
    t1 = time.perf_counter()
    counts = warm_fill_counts_device(sizes_t, head_t).numpy()
    return counts, (t1 - t0, time.perf_counter() - t1, 0.0)


def _device_counts(plan_: WarmFillPlan, solver) -> Optional[np.ndarray]:
    """One [S, V] admission-surface launch on the solver's device; None when
    the surface exceeds the device bounds (the scan then computes exact rows
    lazily on host). A failure propagates: typed where classify() names it
    (the dense solve records it into the breaker), as it is where not."""
    S = plan_.sizes.shape[0]
    V = len(plan_.views)
    if S == 0 or S > _DEVICE_MAX_SIZES or S * V > _DEVICE_MAX_CELLS:
        return None
    try:
        # fault-domain injection seam (solver/faults.py): the admission
        # surface is a dispatch seam like the bucket choice
        FAULTS.check("warmfill")
        # the incremental engine's resident buffer (solver/incremental.py),
        # when it produced the encoding: the kernel reads its first V rows
        # in place
        counts, (stage, enqueue, wait) = admission_counts(plan_.sizes, plan_.enc.head0, solver, plan_.enc.head_dev)
    except Exception as exc:
        fault = classify(exc)
        if fault is None or fault is exc:
            raise
        raise fault from exc
    if FLIGHT.enabled and solver.device.type == "cuda" and solver._flight_dispatch is None:
        # K2 launched: the flight record names the card even where no
        # bucket choice (K1) follows in this solve
        solver._flight_dispatch = {"flavor": "cuda"}
    dt = stage + enqueue + wait
    solver.stats.device_seconds += dt
    solver.stats.fill_device_seconds += dt
    solver.stats.fill_stage_seconds += stage
    solver.stats.fill_enqueue_seconds += enqueue
    solver.stats.fill_wait_seconds += wait
    return counts


def execute(scheduler, problem: DenseProblem, buckets, plan_: WarmFillPlan, solver) -> Tuple[int, np.ndarray]:
    """Run the exact scan over the plan and commit in bulk. Returns
    (committed, taken[P]) with bucket.pod_rows filtered like the host loop."""
    enc = plan_.enc
    at = enc.avail_tol
    req_v = enc.requests0.copy()
    V = len(plan_.views)
    S = plan_.sizes.shape[0]

    counts_ub = _device_counts(plan_, solver)
    alive = np.zeros((S, V), dtype=bool)
    if counts_ub is not None:
        alive[:] = (counts_ub > 0) & enc.usable[None, :]
    else:
        alive[:] = enc.usable[None, :]
    fresh = np.zeros((S,), dtype=bool)

    def ensure_alive(sid: int) -> None:
        """Exact host refinement of the device surface at a size class's
        first touch: recompute the closed-form count against the CURRENT
        residuals (at - req_v), killing views other cohorts already filled —
        staleness the initial-headroom device surface cannot see. Monotone-
        safe pruning: req_v only grows during the fill, so a zero count now
        can never become positive, and every placement is still re-derived
        exactly by the scan. Inlined count>0 test (head >= size on the
        positive axes, head >= 0 everywhere — identical set to
        warm_fill_counts_np > 0 without its ratio/floor allocations)."""
        if not fresh[sid]:
            s = plan_.sizes[sid]
            head = at - req_v
            ok = (head >= 0).all(axis=1)
            pos = s > 0
            if pos.any():
                ok &= (head[:, pos] >= s[pos]).all(axis=1)
            alive[sid] &= ok
            fresh[sid] = True

    def closed_form(v: int, s: np.ndarray, positive: np.ndarray) -> int:
        head = at[v] - req_v[v]
        if (head < 0).any():
            return 0
        return int((head[positive] // s[positive]).min())

    def admit(spec: _BucketSpec, v: int) -> bool:
        return admit_checks(spec.checks, v)

    def admit_checks(checks, v: int) -> bool:
        for op, gs, arg in checks:
            if op == "zero":
                if gs.counts_v[v] != 0:
                    return False
            elif op == "hskew":
                if gs.counts_v[v] + 1 > arg:  # hostname global min is 0
                    return False
            elif op == "skew":
                d = gs.dom_of_view[v]
                if d < 0 or gs.counts_d[d] + 1 - gs.counts_d.min() > arg:
                    return False
            else:  # affinity: populated-domain membership
                d = gs.dom_of_view[v]
                if d < 0 or gs.counts_d[d] <= 0:
                    return False
        return True

    _BIG = 1 << 30

    def room_vector(spec: _BucketSpec) -> np.ndarray:
        """[V] int: how many pods of this cohort each view admits before an
        INTEGER check vetoes — the per-pod rules of admit() run forward in
        closed form. Only the cohort's own records evolve during a sub-run
        (runs are sequential), so the bound is exact: skew admits until the
        pinned domain reaches (min over other domains) + maxSkew; zero /
        populated checks are static for non-self-bumping cohorts."""
        n = np.full((V,), _BIG, dtype=np.int64)
        for op, gs, arg in spec.checks:
            if op == "zero":
                n = np.where(gs.counts_v == 0, n, 0)
            elif op == "hskew":
                n = np.minimum(n, np.maximum(arg - gs.counts_v, 0))
            elif op == "skew":
                c = gs.counts_d
                if c.size > 1:
                    m = c.min()
                    # min over the OTHER domains: the second-lowest count
                    # when d is the unique minimum, the minimum otherwise
                    m2 = np.partition(c, 1)[1]
                    unique_min = (c == m).sum() == 1
                    m_excl = np.where((c == m) & unique_min, m2, m)
                    room_d = np.maximum(m_excl + arg - c, 0)
                else:
                    room_d = np.full((c.size,), _BIG, dtype=np.int64)
                dom = gs.dom_of_view
                n = np.minimum(n, np.where(dom >= 0, room_d[np.clip(dom, 0, None)], 0))
            else:  # affinity: populated-domain membership, static per sub-run
                pop = gs.counts_d > 0
                dom = gs.dom_of_view
                n = np.where((dom >= 0) & pop[np.clip(dom, 0, None)], n, 0)
        return n

    events: List[tuple] = []  # ("bulk"|"pod", v, spec, rows)
    taken = np.zeros((plan_.P,), dtype=bool)
    committed = 0

    def place(spec: _BucketSpec, v: int, rows: List[int], s: np.ndarray, bulk: bool) -> None:
        nonlocal committed
        n = len(rows)
        if bulk:
            events.append(("bulk", v, spec, rows))
            req_v[v] = req_v[v] + s * n
        else:
            events.append(("pod", v, spec, rows))
            for _ in rows:
                req_v[v] = req_v[v] + s
        for gs in spec.records:
            gs.bump(v, n)
        taken[rows] = True
        committed += n

    def subrun(spec: _BucketSpec, v: int, rows: List[int], i: int, k_adm: int, s: np.ndarray, positive: np.ndarray, sid: int) -> int:
        """Place pods rows[i:] on view v under the per-pod protocol until a
        veto, in one batch: np.add.accumulate applies the same IEEE addition
        sequence as the per-pod merge loop, so the capacity verdicts (and
        the request vector left behind) are bit-identical to placing one
        pod at a time. Marks the view capacity-dead for this size class
        when the stop reason is a capacity veto. Returns pods placed."""
        nonlocal committed
        R = s.shape[0]
        placed = 0
        budget = min(k_adm, len(rows) - i)
        while budget > 0:
            if budget == 1:
                merged = req_v[v] + s
                if (merged <= at[v]).all():
                    chunk_rows = rows[i + placed : i + placed + 1]
                    events.append(("pod", v, spec, chunk_rows))
                    req_v[v] = merged
                    for gs in spec.records:
                        gs.bump(v, 1)
                    taken[chunk_rows] = True
                    committed += 1
                    placed += 1
                else:
                    alive[sid, v] = False  # capacity veto: persistent per size
                return placed
            # bound the prefix allocation by a cheap estimate; the loop
            # extends it in the (rare) case sequential rounding admits more
            est = closed_form(v, s, positive)
            chunk = min(budget, max(est + 2, 1))
            steps = np.empty((chunk + 1, R), np.float64)
            steps[0] = req_v[v]
            steps[1:] = s
            acc = np.add.accumulate(steps, axis=0)
            ok = np.all(acc[1:] <= at[v], axis=1)
            n = chunk if ok.all() else int(np.argmax(~ok))
            if n:
                chunk_rows = rows[i + placed : i + placed + n]
                events.append(("pod", v, spec, chunk_rows))
                req_v[v] = acc[n]
                for gs in spec.records:
                    gs.bump(v, n)
                taken[chunk_rows] = True
                committed += n
                placed += n
                budget -= n
            if n < chunk:
                alive[sid, v] = False  # capacity veto: persistent per size
                return placed
            if chunk == budget:
                return placed
        return placed

    # -- scan-pointer state, persisted across same-(bucket, size) segments --
    # The FFD stream interleaves buckets along the global size order, so one
    # (bucket, size) pair fragments into many short run segments. Every veto
    # the forward scans act on is PERSISTENT for a fixed size class (capacity
    # death: residuals only grow; zero-count claims: group counts only grow),
    # so the scan position survives segment boundaries — without this the
    # per-segment rescans over already-dead view prefixes dominate the fill
    # (the r5 16k flagship's residual host time).
    scan_state: Dict[tuple, dict] = {}

    # the acceptance-masked candidate lists are built ONCE per spec (they
    # are sid-independent), then narrowed to each size class by one
    # vectorized alive[] take at (spec, sid) first touch — a V-wide
    # flatnonzero per (spec, sid) pair here was a top-5 fill cost at
    # 16k/2400, and leaving dead views for the scalar pointers to skip
    # re-pays the prefix per size class
    shared_lists: Dict[tuple, object] = {}

    def order_state(spec: _BucketSpec, sid: int, perpod: bool) -> dict:
        key = (id(spec), sid)
        st = scan_state.get(key)
        if st is None:
            okey = (id(spec), perpod)
            base = shared_lists.get(okey)
            if base is None:
                accept = spec.accept_perpod if perpod else spec.accept
                base = shared_lists[okey] = np.flatnonzero(accept)
            st = scan_state[key] = {"order": base[alive[sid, base]], "p": 0}
        return st

    def dom_state(spec: _BucketSpec, gs: _GroupState, sid: int) -> dict:
        """Per-domain candidate view lists (view-index order): the restart
        discipline reduces to O(domains) head peeks instead of an O(views)
        room recompute per placement."""
        key = (id(spec), sid)
        st = scan_state.get(key)
        if st is None:
            lkey = (id(spec), "doms")
            base = shared_lists.get(lkey)
            if base is None:
                dom = gs.dom_of_view
                base = shared_lists[lkey] = [
                    np.flatnonzero(spec.accept_perpod & (dom == d)) for d in range(gs.counts_d.size)
                ]
            lists = [l[alive[sid, l]] for l in base]
            st = scan_state[key] = {"lists": lists, "ptrs": [0] * gs.counts_d.size}
        return st

    def head_of(lst: np.ndarray, p: int, sid: int) -> Tuple[int, int]:
        """First still-alive view of `lst` at or past p: (view, p'), view -1
        when exhausted. Skipped (dead) views never resurrect for a size."""
        n = lst.size
        while p < n:
            v = int(lst[p])
            if alive[sid, v]:
                return v, p
            p += 1
        return -1, p

    pos_cache: Dict[int, np.ndarray] = {}
    for bucket, sid, rows in plan_.runs:
        spec = plan_.specs[id(bucket)]
        s = plan_.sizes[sid]
        positive = pos_cache.get(sid)
        if positive is None:
            positive = pos_cache[sid] = s > 0
        ensure_alive(sid)
        if spec.kind == _PLAIN and not spec.checks:
            # certified capacity-only cohort: the closed-form branch of
            # add_certified_view_run, one forward scan, bulk sub-runs. The
            # pointer stays ON a view that still had room when the segment's
            # rows ran out: the next segment re-derives its residual count
            # exactly, so a pathological-rounding leftover is never skipped.
            st = order_state(spec, sid, perpod=False)
            order, p = st["order"], st["p"]
            i = 0
            while i < len(rows) and p < order.size:
                v = int(order[p])
                if not alive[sid, v]:
                    p += 1
                    continue
                n = closed_form(v, s, positive)
                if n <= 0:
                    alive[sid, v] = False
                    p += 1
                    continue
                take = min(n, len(rows) - i)
                place(spec, v, rows[i : i + take], s, bulk=True)
                i += take
            st["p"] = p
        elif spec.kind == _PLAIN:
            # plain cohort vetoed-per-host by an inverse anti-affinity
            # selection: the host runs add_certified_view per pod, forward
            # scan, never restarting (every veto is persistent here)
            st = order_state(spec, sid, perpod=True)
            order, p = st["order"], st["p"]
            i = 0
            while i < len(rows) and p < order.size:
                v = int(order[p])
                if not alive[sid, v]:
                    p += 1
                    continue
                if ((req_v[v] + s) > at[v]).any():
                    alive[sid, v] = False
                    p += 1
                    continue
                if not admit(spec, v):
                    p += 1
                    continue
                place(spec, v, [rows[i]], s, bulk=False)
                i += 1
            st["p"] = p
        elif spec.kind == _DEDICATED:
            st = order_state(spec, sid, perpod=True)
            order, p = st["order"], st["p"]
            for row in rows:
                placed = False
                while p < order.size:
                    v = int(order[p])
                    if not alive[sid, v]:
                        p += 1
                        continue
                    if ((req_v[v] + s) > at[v]).any():
                        alive[sid, v] = False
                        p += 1
                        continue
                    if not admit(spec, v):
                        p += 1
                        continue
                    place(spec, v, [row], s, bulk=False)
                    # advance only once the view stops admitting: a zero-
                    # count claim shuts the host immediately, but hostname
                    # spread with maxSkew >= 2 admits up to maxSkew pods per
                    # host and the host loop would land the next pod right
                    # back here (hskew counts are monotone, so every veto
                    # the pointer acts on stays persistent either way)
                    if not admit(spec, v):
                        p += 1
                    placed = True
                    break
                if not placed:
                    break
            st["p"] = p
        else:  # _SPREAD / _AFFINITY
            i = 0
            if spec.kind == _AFFINITY and not spec.aff.counts_d.any():
                # bootstrap: the full add pins the cohort to the first
                # accepting view's zone, then the certified run sweeps the
                # remainder of the run onto it in closed form. At most once
                # per cohort — populated counts never return to zero.
                # The certified single extra rule (plan() admits at most
                # one non-aff check) gates the boot view through the same
                # admit algebra and caps the sweep by room_vector — both
                # exact closed forms of the per-pod protocol, so a skipped
                # view stays skipped (zero/hskew counts and residuals are
                # monotone) and the remainder falls to the generic scan.
                gs = spec.aff
                extras = [c for c in spec.checks if c[0] != "aff"]
                boot = -1
                for v in np.flatnonzero(spec.accept_perpod & alive[sid]):
                    v = int(v)
                    if gs.dom_of_view[v] < 0:
                        continue  # zone outside the group: full add vetoes
                    if extras and not admit_checks(extras, v):
                        continue  # the extra integer rule vetoes this host
                    if ((req_v[v] + s) > at[v]).any():
                        alive[sid, v] = False
                        continue
                    boot = v
                    break
                if boot < 0:
                    continue  # nothing can host the cohort: rows stay
                place(spec, boot, [rows[i]], s, bulk=False)
                i += 1
                n = min(closed_form(boot, s, positive), len(rows) - i)
                if extras:
                    n = min(n, int(room_vector(spec)[boot]))
                if n > 0:
                    place(spec, boot, rows[i : i + n], s, bulk=True)
                    i += n
            single = spec.checks[0] if len(spec.checks) == 1 else None
            if single is not None and single[0] in ("skew", "aff") and single[1].dom_of_view is not None:
                # deferred spread / post-bootstrap affinity, single domain-
                # keyed rule: the restart-from-view-0 discipline (skew
                # admission is not monotone) via per-domain head pointers.
                # Identical placements to the room_vector scan — the first
                # admitted view is the min-index head among domains with
                # room — but the recurrence runs on PYTHON INTS with each
                # head view's exact capacity prefix computed ONCE per run
                # (np.add.accumulate: the same IEEE addition sequence as the
                # per-pod merge loop, so req_v lands bit-identical). Skew-1
                # spread admits ~1 pod per restart, and a numpy partition +
                # per-pod merge per restart was the dominant scan cost.
                op, gs, arg = single
                st = dom_state(spec, gs, sid)
                lists, ptrs = st["lists"], st["ptrs"]
                D = gs.counts_d.size
                # head-view and capacity caches persist ACROSS run segments
                # (the FFD stream fragments one (bucket, size) pair into
                # thousands of 1-2 pod segments at 16k — per-segment rebuilds
                # were the dominant scan cost). A cached capacity entry is
                # valid only while req_v[v] still equals the acc row we left
                # (another cohort touching the view invalidates it), checked
                # per reuse; cached heads re-verify alive[].
                heads = st.setdefault("heads", [None] * D)
                caps = st.setdefault("caps", {})  # v -> [acc, k, taken_n, cap_hit]

                def view_capacity(v: int, max_n: int) -> list:
                    """acc[n] = req_v[v] after n sequential adds of s; k the
                    max prefix with acc[n] <= at[v] elementwise; cap_hit
                    False when k is the rows bound, not a capacity stop."""
                    R = s.shape[0]
                    n_try = min(max_n, max(closed_form(v, s, positive) + 2, 1))
                    while True:
                        steps = np.empty((n_try + 1, R), np.float64)
                        steps[0] = req_v[v]
                        steps[1:] = s
                        acc = np.add.accumulate(steps, axis=0)
                        ok = np.all(acc[1:] <= at[v], axis=1)
                        if ok.all():
                            if n_try >= max_n:
                                return [acc, n_try, 0, False]
                            n_try = min(max_n, n_try * 2 + 2)  # rare rounding extension
                            continue
                        return [acc, int(np.argmax(~ok)), 0, True]

                while i < len(rows):
                    cvals = gs.counts_d
                    if op == "skew" and D > 1:
                        srt = sorted(int(x) for x in cvals)  # D is small
                        m1, m2 = srt[0], srt[1]
                        unique_min = srt.count(m1) == 1
                    best_v, best_d, best_room = -1, -1, 0
                    for d in range(D):
                        if op == "aff":
                            room = _BIG if int(cvals[d]) > 0 else 0
                        elif D > 1:
                            cd = int(cvals[d])
                            m_excl = m2 if (cd == m1 and unique_min) else m1
                            room = m_excl + arg - cd
                        else:
                            room = _BIG
                        if room <= 0:
                            continue
                        v = heads[d]
                        if v is None or (v >= 0 and not alive[sid, v]):
                            v, ptrs[d] = head_of(lists[d], ptrs[d], sid)
                            heads[d] = v
                        if v < 0:
                            continue
                        if best_v < 0 or v < best_v:
                            best_v, best_d, best_room = v, d, room
                    if best_v < 0:
                        break
                    entry = caps.get(best_v)
                    if entry is not None and not np.array_equal(entry[0][entry[2]], req_v[best_v]):
                        entry = None  # another cohort touched the view: stale
                    if entry is not None and entry[1] - entry[2] <= 0 and not entry[3]:
                        entry = None  # rows-bound entry exhausted: extend fresh
                    if entry is None:
                        entry = caps[best_v] = view_capacity(best_v, len(rows) - i)
                    acc, k, taken_n, cap_hit = entry
                    if k - taken_n <= 0:
                        alive[sid, best_v] = False  # capacity-dead: monotone-safe
                        heads[best_d] = None
                        continue
                    take = min(best_room, k - taken_n, len(rows) - i)
                    chunk_rows = rows[i : i + take]
                    events.append(("pod", best_v, spec, chunk_rows))
                    entry[2] = taken_n + take
                    req_v[best_v] = acc[entry[2]]
                    for gsr in spec.records:
                        gsr.bump(best_v, take)
                    taken[chunk_rows] = True
                    committed += take
                    i += take
                    if entry[2] == k and cap_hit:
                        alive[sid, best_v] = False
                        heads[best_d] = None
            elif single is not None and single[0] == "hskew":
                # hostname spread: per-view counts, monotone room — one
                # forward pointer reproduces the restart discipline exactly
                op, gs, arg = single
                st = order_state(spec, sid, perpod=True)
                order, p = st["order"], st["p"]
                while i < len(rows) and p < order.size:
                    v = int(order[p])
                    if not alive[sid, v] or gs.counts_v[v] >= arg:
                        p += 1
                        continue
                    i += subrun(spec, v, rows, i, int(arg - gs.counts_v[v]), s, positive, sid)
                st["p"] = p
            else:
                # combined constraints (e.g. zonal + hostname spread on one
                # cohort): the generic restart scan
                while i < len(rows):
                    room = room_vector(spec)
                    progressed = False
                    for v in np.flatnonzero(spec.accept_perpod & alive[sid] & (room > 0)):
                        v = int(v)
                        n = subrun(spec, v, rows, i, int(room[v]), s, positive, sid)
                        if n:
                            i += n
                            progressed = True
                            break
                    if not progressed:
                        break

    _apply(problem, plan_, events)
    for bucket in buckets:
        if bucket.pod_rows:
            bucket.pod_rows = [r for r in bucket.pod_rows if not taken[r]]
    return committed, taken


def _apply(problem: DenseProblem, plan_: WarmFillPlan, events: List[tuple]) -> None:
    """Make the scan's placements real with the same mutation sequence the
    certified paths issue: per sub-run one requests merge (closed form) or
    per-pod merges, pods appended in event order, and one record call per
    (group, domain, count)."""
    enc = plan_.enc
    views = plan_.views
    for kind, v, spec, rows in events:
        view = views[v]
        pods = [problem.pods[r] for r in rows]
        n = len(pods)
        if kind == "bulk":
            size = res.pod_requests(pods[0])
            view.pods.extend(pods)
            view.requests = res.merge(view.requests, {name: value * n for name, value in size.items()})
        else:
            # no host_port_usage/volume_usage adds: classify (ir/encode.py)
            # routes every volume- or host-port-carrying pod to the HOST
            # path, so for dense pods both adds are no-ops by construction.
            # The merge is inlined (dict copy + in-place adds) — same float
            # additions in the same order as res.merge, without its
            # rebuild-from-empty overhead at one call per pod.
            for pod in pods:
                view.pods.append(pod)
                nxt = dict(view.requests)
                for name, value in res.pod_requests(pod).items():
                    nxt[name] = nxt.get(name, 0.0) + value
                view.requests = nxt
        for gs in spec.records:
            domain = gs.record_domain(v, enc)
            if domain is not None:
                gs.group.record(domain, count=n)
