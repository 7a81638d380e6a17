"""The port's incremental solve engine held against the JAX package's.

Every case of tests/test_incremental_parity.py, ported: one seeded churn
drives both packages' clusters through their real feeds (kube store ->
watch -> Cluster -> delta journal), and both packages' IncrementalEngines
advance over the resulting views. Pass kinds, reasons, dirty rows and every
encoding field must match the reference engine's byte for byte, and the
port's resident headroom (`head_dev[:V]`) must equal f32(head0) with -1.0
pad rows. Whole solves through a persistent port DenseSolver carrying the
engine must place pods exactly as a fresh port solver and as the
reference's persistent incremental solver (its process-wide residency
auditor turned off: its sampled draw seeds random.Random with a tuple,
which Python 3.12 rejects). Then bench.py's incremental churn at a smoke
size with the port's auditor on every pass, the resident-head K2 dispatch,
and a rebase failure propagating out of the solve.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
from karpenter_tpu.controllers.state.cluster import Cluster as RefCluster
from karpenter_tpu.kube.cluster import KubeCluster as RefKubeCluster
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu.solver import DenseSolveStats as RefDenseSolveStats
from karpenter_tpu.solver.incremental import IncrementalEngine as RefEngine
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.controllers.state.cluster import Cluster
from karpenter_tpu_torch.ir.encode import encode_warm_views
from karpenter_tpu_torch.kube.cluster import KubeCluster
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver, DenseSolveStats
from karpenter_tpu_torch.solver import incremental as incremental_module
from karpenter_tpu_torch.solver import warmfill as port_warmfill
from karpenter_tpu_torch.solver.audit import ResidencyAuditor
from karpenter_tpu_torch.solver.incremental import PASS_BYPASS, PASS_DELTA, PASS_FULL, IncrementalEngine
from tests.helpers import make_pod as ref_make_pod
from tests.test_differential_campaign import _provisioners as ref_provisioners
from tests.test_differential_campaign import _rename as ref_rename
from tests.test_incremental_parity import _Churn as RefChurn
from tests.test_torch_warm_solve import _fingerprint

FIELDS = ("usable", "avail_tol", "requests0", "head0")
LISTS = ("zone", "ct", "hostname", "taint_sig")


@pytest.fixture(autouse=True)
def _reference_auditor_off():
    from karpenter_tpu.solver.audit import AUDITOR

    was = AUDITOR.enabled
    AUDITOR.disable()
    yield
    if was:
        AUDITOR.enable()


class _Pair:
    """The same seeded cluster in both packages, with an engine each."""

    def __init__(self, seed, tag, min_nodes, seed_nodes, types):
        self.ref_provider = RefProvider(ref_instance_types(types))
        self.provider = FakeCloudProvider(instance_types(types))
        self.ref_kube, self.kube = RefKubeCluster(), KubeCluster()
        self.ref_churn = RefChurn(self.ref_kube, seed, tag, min_nodes=min_nodes)
        self.churn = testing.Churn(self.kube, seed, tag, min_nodes=min_nodes)
        self.ref_churn.seed_nodes(seed_nodes)
        self.churn.seed_nodes(seed_nodes)
        self.ref_cluster = RefCluster(self.ref_kube, None)
        self.cluster = Cluster(self.kube, None)
        self.ref_engine = RefEngine(self.ref_cluster.delta_journal)
        self.engine = IncrementalEngine(self.cluster.delta_journal, device="cpu")

    def step(self):
        self.ref_churn.step()
        self.churn.step()

    def call(self, name, *args):
        getattr(self.ref_churn, name)(*args)
        getattr(self.churn, name)(*args)

    def views(self):
        ref = ref_build_scheduler(
            ref_provisioners(), self.ref_provider, [], cluster=self.ref_cluster,
            state_nodes=self.ref_cluster.nodes_snapshot(), dense_solver=None,
        ).existing_nodes
        port = build_scheduler(
            testing.campaign_provisioners(), self.provider, [], cluster=self.cluster,
            state_nodes=self.cluster.nodes_snapshot(), dense_solver=None,
        ).existing_nodes
        return ref, port

    def advance(self, ckey, ctx):
        """Both engines over their views; asserts the port's pass equals the
        reference's and its encoding a fresh encode. Returns the port's."""
        ref_views, views = self.views()
        want = self.ref_engine.advance(ref_views, ckey)
        got = self.engine.advance(views, ckey)
        assert (got.kind, got.reason, got.dirty_rows) == (want.kind, want.reason, want.dirty_rows), ctx
        if got.enc is not None:
            _assert_enc_equal(got.enc, want.enc, ctx)
            _assert_enc_equal(got.enc, encode_warm_views(views), ctx)
        else:
            assert want.enc is None, ctx
        return got


def _assert_enc_equal(enc, ref, ctx):
    """Field for field, byte for byte; the port's resident headroom equals
    the f32 cast of the f64 headroom, with -1.0 pad rows."""
    for name in FIELDS:
        a, b = getattr(enc, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f"{ctx}: {name}"
    for name in LISTS:
        assert list(getattr(enc, name)) == list(getattr(ref, name)), f"{ctx}: {name}"
    head_dev = enc.head_dev
    assert isinstance(head_dev, torch.Tensor) and head_dev.dtype == torch.float32, f"{ctx}: no resident head"
    dev = head_dev.numpy()
    V = enc.head0.shape[0]
    assert enc.head_vp == dev.shape[0] and dev.shape[0] % 128 == 0, f"{ctx}: row pad"
    assert np.array_equal(dev[:V], enc.head0.astype(np.float32)), f"{ctx}: device mirror"
    assert np.all(dev[V:] == np.float32(-1.0)), f"{ctx}: device pad rows"
    ref_dev = getattr(ref, "head_dev", None)
    if ref_dev is not None:
        assert np.array_equal(dev, np.asarray(ref_dev)), f"{ctx}: reference device mirror"


# -- engine-level parity across a randomized delta sequence -------------------


@pytest.mark.parametrize("seed", range(3))
def test_engine_delta_sequence_matches_the_reference(seed):
    pair = _Pair(4100 + seed, f"ip{seed}", min_nodes=10, seed_nodes=12, types=50)
    ckey = ("ck", 0)
    adv = pair.advance(ckey, "cold")
    assert adv.kind == PASS_FULL and adv.reason == "cold"
    for step in range(6):
        pair.step()
        adv = pair.advance(ckey, f"seed {seed} step{step}")
        if adv.kind == PASS_DELTA:
            assert adv.dirty_rows < len(pair.kube.list_nodes())
    assert pair.engine.passes[PASS_DELTA] >= 3, "small churn over a 12-node cluster must take the delta path"

    # a catalog-key bump can re-shape every row: attributed full re-encode
    ckey = ("ck", 1)
    adv = pair.advance(ckey, "catalog")
    assert adv.kind == PASS_FULL and adv.reason == "catalog"
    pair.step()
    assert pair.advance(ckey, "post-catalog").kind == PASS_DELTA

    # a forced invalidation (the auditor's heal calls this)
    pair.ref_engine.invalidate("forced")
    pair.engine.invalidate("forced")
    adv = pair.advance(ckey, "forced")
    assert adv.kind == PASS_FULL and adv.reason == "forced"

    # a journal gap (resync re-list) voids the delta window
    pair.ref_cluster.delta_journal.mark_gap()
    pair.cluster.delta_journal.mark_gap()
    adv = pair.advance(ckey, "gap")
    assert adv.kind == PASS_FULL and adv.reason == "gap"
    pair.step()
    assert pair.advance(ckey, "post-gap").kind == PASS_DELTA
    assert pair.engine.passes == pair.ref_engine.passes
    # two buffers throughout, the live one among them
    assert len(pair.engine.buffers) == 2
    assert any(pair.engine._resident.head_dev is b for b in pair.engine.buffers)


def test_steady_state_dirty_window_stays_bounded():
    pair = _Pair(4700, "bw", min_nodes=30, seed_nodes=30, types=30)
    assert pair.advance(("ck",), "cold").kind == PASS_FULL
    for step in range(14):
        # two pod binds per pass -> at most 2 journal names + the previous
        # pass's 2 healing names
        pair.call("bind")
        pair.call("bind")
        adv = pair.advance(("ck",), f"step {step}")
        assert adv.kind == PASS_DELTA, f"step {step}: {adv.kind} ({adv.reason})"
        assert adv.dirty_rows <= 4, f"step {step}: the dirty window grew to {adv.dirty_rows} rows"


def test_bulk_churn_takes_an_attributed_full_reencode():
    pair = _Pair(4400, "bulk", min_nodes=0, seed_nodes=12, types=30)
    assert pair.advance(("ck",), "cold").kind == PASS_FULL
    # churn past MAX_DIRTY_FRACTION: 7 of 12 die, 8 launch -> 8 dirty of 13
    for kube in (pair.ref_kube, pair.kube):
        for node in kube.list_nodes()[:7]:
            kube.delete(node, grace=False)
    for _ in range(8):
        pair.call("add_node")
    adv = pair.advance(("ck",), "bulk")
    assert adv.kind == PASS_FULL and adv.reason == "bulk"


def test_view_pad_regrowth_rebuilds():
    pair = _Pair(4500, "grow", min_nodes=0, seed_nodes=124, types=20)
    assert pair.advance(("ck",), "cold").kind == PASS_FULL
    for _ in range(8):  # 124 -> 132 views: pad 128 -> 256
        pair.call("add_node")
    adv = pair.advance(("ck",), "grow")
    assert adv.kind == PASS_FULL and adv.reason == "grow"
    assert tuple(adv.enc.head_dev.shape) == (256, adv.enc.head0.shape[1])
    assert all(tuple(b.shape) == (256, adv.enc.head0.shape[1]) for b in pair.engine.buffers)


def test_empty_views_bypass_and_drop_state():
    pair = _Pair(4600, "mt", min_nodes=0, seed_nodes=4, types=20)
    assert pair.advance(("ck",), "cold").kind == PASS_FULL
    assert pair.ref_engine.advance([], ("ck",)).kind == PASS_BYPASS
    adv = pair.engine.advance([], ("ck",))
    assert adv.kind == PASS_BYPASS and adv.enc is None
    adv = pair.advance(("ck",), "after bypass")
    assert adv.kind == PASS_FULL and adv.reason == "cold"


# -- whole solves: persistent incremental solver vs fresh and reference --------


def _solve(solver, build, provisioners, provider, cluster, pods):
    solver.stats = solver.stats.__class__()
    scheduler = build(provisioners, provider, pods, cluster=cluster, state_nodes=cluster.nodes_snapshot(), dense_solver=solver)
    return _fingerprint(scheduler.solve(pods), scheduler, solver.stats)


@pytest.mark.parametrize("seed", range(3))
def test_incremental_solves_match_fresh_and_reference(seed):
    """Per churn step the same snapshot and pod batch are solved three ways:
    the port's persistent incremental solver, a fresh port solver and the
    reference's persistent incremental solver. A forced invalidation lands
    mid-sequence; the engine must engage (delta passes taken) so the sweep
    never degrades to full-vs-full."""
    pair = _Pair(5200 + seed, f"is{seed}", min_nodes=8, seed_nodes=10, types=50)
    solver = DenseSolver(min_batch=1, device="cpu", incremental=pair.engine)
    ref_solver = RefDenseSolver(min_batch=1, use_mesh=False, incremental=pair.ref_engine)
    skipped = 0
    for step in range(8):
        pair.step()
        if step == 5:
            pair.engine.invalidate("forced")
            pair.ref_engine.invalidate("forced")
        prng = np.random.default_rng(9000 + 100 * seed + step)
        sizes = [float(prng.choice([0.25, 0.5, 1.0])) for _ in range(int(prng.integers(4, 12)))]
        ref_pods = ref_rename([ref_make_pod(labels={"app": "churned"}, requests={"cpu": c, "memory": "512Mi"}) for c in sizes], f"is{seed}s{step}")
        pods = testing.rename([testing.make_pod(labels={"app": "churned"}, requests={"cpu": c, "memory": "512Mi"}) for c in sizes], f"is{seed}s{step}")
        got = _solve(solver, build_scheduler, testing.campaign_provisioners(), pair.provider, pair.cluster, pods)
        skipped += solver.stats.encode_skipped_passes
        fresh = _solve(DenseSolver(min_batch=1, device="cpu"), build_scheduler, testing.campaign_provisioners(), pair.provider, pair.cluster, pods)
        want = _solve(ref_solver, ref_build_scheduler, ref_provisioners(), pair.ref_provider, pair.ref_cluster, ref_pods)
        assert got == fresh, f"seed {seed} step {step}: incremental solve diverges from fresh"
        assert got == want, f"seed {seed} step {step}: incremental solve diverges from the reference's"
        assert solver.stats.encode_skipped_passes == ref_solver.stats.encode_skipped_passes
    assert pair.engine.passes[PASS_DELTA] >= 3, f"seed {seed}: the delta path never engaged"
    assert pair.engine.passes[PASS_FULL] >= 2, "cold start + forced invalidation"
    assert pair.engine.passes == pair.ref_engine.passes
    assert skipped == pair.engine.passes[PASS_DELTA], "every delta pass must flow through the presolve stats"


def test_bench_churn_at_smoke_size_takes_delta_passes_with_the_auditor_on():
    """bench.py --smoke's incremental churn (80 standing nodes, 25-pod
    batches, 12 measured passes after 2 warm-up passes), audited every pass:
    12/12 delta passes, no full encode in the window, 0 divergences over
    12+ audits, and a coda placed exactly as a fresh solver places it."""
    nodes, batch, passes = 80, 25, 12
    provider = FakeCloudProvider(instance_types(100))
    provisioners = [testing.make_provisioner()]
    kube = KubeCluster()
    testing.standing_cluster(kube, nodes)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device="cpu")
    auditor = ResidencyAuditor(seed=7)
    solver = DenseSolver(min_batch=1, device="cpu", incremental=engine, auditor=auditor)

    def one_pass(run_solver, step):
        pods = testing.churn_batch(step, batch)
        run_solver.stats = DenseSolveStats()
        scheduler = build_scheduler(provisioners, provider, pods, cluster=cluster, state_nodes=cluster.nodes_snapshot(), dense_solver=run_solver)
        results = scheduler.solve(pods)
        assert sum(len(v.pods) for v in results.existing_nodes) + sum(len(n.pods) for n in results.new_nodes) == batch
        return results, run_solver.stats

    one_pass(solver, 0)
    testing.standing_churn(kube, 0, nodes)
    one_pass(solver, 1)
    base = dict(engine.passes)
    skipped, full_encode = 0, []
    for step in range(2, passes + 2):
        testing.standing_churn(kube, step, nodes)
        _, stats = one_pass(solver, step)
        skipped += stats.encode_skipped_passes
        full_encode.append(stats.full_encode_seconds)
        assert stats.fills_vectorized == 1 and stats.delta_apply_seconds > 0
    assert engine.passes[PASS_DELTA] - base[PASS_DELTA] == passes
    assert engine.passes[PASS_FULL] == base[PASS_FULL], "a full re-encode leaked into the window"
    assert skipped == passes and max(full_encode) == 0.0
    assert auditor.divergences == {} and auditor.audits >= passes and auditor.clean_streak == auditor.audits

    testing.standing_churn(kube, passes + 2, nodes)
    results_i, _ = one_pass(solver, passes + 2)
    results_f, _ = one_pass(DenseSolver(min_batch=1, device="cpu"), passes + 2)

    def sig(results):
        existing = sorted((v.node.name, tuple(p.name for p in v.pods)) for v in results.existing_nodes)
        return existing, sorted(tuple(sorted(p.name for p in n.pods)) for n in results.new_nodes)

    assert sig(results_i) == sig(results_f)


def test_k2_on_the_resident_head_gives_the_staged_counts(monkeypatch):
    kube = KubeCluster()
    testing.standing_cluster(kube, 40)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device="cpu")
    solver = DenseSolver(min_batch=1, device="cpu", incremental=engine)
    provider = FakeCloudProvider(instance_types(40))
    calls = []
    wrapper = port_warmfill.warm_fill_counts_device

    def recording(sizes, head):
        calls.append((sizes, head))
        return wrapper(sizes, head)

    monkeypatch.setattr(port_warmfill, "warm_fill_counts_device", recording)
    for step in range(3):
        testing.standing_churn(kube, step, 40)
        pods = testing.churn_batch(step, 30)
        build_scheduler([testing.make_provisioner()], provider, pods, cluster=cluster, state_nodes=cluster.nodes_snapshot(), dense_solver=solver).solve(pods)
    assert engine.passes[PASS_DELTA] == 2 and len(calls) == 3
    for sizes, head in calls:
        # the kernel wrapper reads the resident buffer's first V rows in place
        assert head.shape[0] == 40 and head.data_ptr() in {b.data_ptr() for b in engine.buffers}
        resident = wrapper(sizes, head)
        staged = wrapper(sizes, head.clone())
        assert torch.equal(resident, staged)
    enc = engine._resident.enc
    sizes = np.asarray([[0.5, 512 * 2**20, 1, 0, 0, 0, 0, 0], [2.0, 2**30, 1, 0, 0, 0, 0, 0]])
    resident, _ = port_warmfill.admission_counts(sizes, enc.head0, solver, enc.head_dev)
    staged, _ = port_warmfill.admission_counts(sizes, enc.head0, solver)
    assert np.array_equal(resident, staged) and resident.shape == (2, 40)


def test_a_rebase_failure_propagates_out_of_the_solve(monkeypatch):
    kube = KubeCluster()
    testing.standing_cluster(kube, 20)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device="cpu")
    solver = DenseSolver(min_batch=1, device="cpu", incremental=engine)
    provider = FakeCloudProvider(instance_types(20))

    def solve(step):
        pods = testing.churn_batch(step, 10)
        build_scheduler([testing.make_provisioner()], provider, pods, cluster=cluster, state_nodes=cluster.nodes_snapshot(), dense_solver=solver).solve(pods)

    solve(0)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(incremental_module, "rebase_view_state", broken)
    testing.standing_churn(kube, 1, 20)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        solve(1)


def test_the_engine_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    journal = Cluster(KubeCluster(), None).delta_journal
    DenseSolver(device="cpu", incremental=IncrementalEngine(journal, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalEngine(journal)
