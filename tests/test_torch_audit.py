"""The port's residency auditor (karpenter_tpu_torch/solver/audit.py) held
against the JAX package's on the CPU.

One seeded churn drives both packages' clusters through their real feeds,
each with a persistent incremental solver; the JAX package's process-wide
AUDITOR and the port's ResidencyAuditor both audit every pass as a full
shadow (the reference's sampled draw seeds random.Random with a tuple, which
Python 3.12 rejects). Each divergence kind is planted by the test on both
sides at the state seam the JAX package's fault injector uses
(tests/test_residency_audit.py): a flipped host-mirror row right after the
engine advances, a journal record the corrupt seam suppresses, a perturbed
element of the resident device buffer, a planted availability-cube cache
that disagrees with its host array. Both auditors must report the same
kinds, rows and fields in the same pass, heal by invalidating residency
with reason 'audit', and place every pass as each other; the pass after a
heal is a full re-encode placing pods as a fresh solver does. Clean churn
never diverges. The int-seeded sampled draw is the port's alone.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
from karpenter_tpu.controllers.state.cluster import Cluster as RefCluster
from karpenter_tpu.ir import delta as ref_delta
from karpenter_tpu.kube.cluster import KubeCluster as RefKubeCluster
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu.solver.audit import AUDITOR
from karpenter_tpu.solver.incremental import IncrementalEngine as RefEngine
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.controllers.state.cluster import Cluster
from karpenter_tpu_torch.ir import delta
from karpenter_tpu_torch.kube.cluster import KubeCluster
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver
from karpenter_tpu_torch.solver import audit
from karpenter_tpu_torch.solver.audit import (
    KIND_CUBE_STALE,
    KIND_DEVICE_CORRUPT,
    KIND_MISSED_DELTA,
    KIND_ROW_DRIFT,
    ResidencyAuditor,
)
from karpenter_tpu_torch.solver.incremental import PASS_DELTA, PASS_FULL, IncrementalEngine
from karpenter_tpu_torch.utils.seeds import split_seed
from tests.helpers import make_pod as ref_make_pod
from tests.test_differential_campaign import _provisioners as ref_provisioners
from tests.test_differential_campaign import _rename as ref_rename
from tests.test_incremental_parity import _Churn as RefChurn
from tests.test_torch_warm_solve import _fingerprint

DEFAULT_SHADOW_EVERY = audit.SHADOW_EVERY
REF_KNOBS = ("enabled", "interval", "sample_rows", "shadow_every", "shadow_budget_bytes", "seed")


@pytest.fixture(autouse=True)
def _every_audit_a_shadow(monkeypatch):
    """Both auditors audit every pass as a full shadow, seed 3 (the JAX
    package's own fault tests arm it so). The reference's knobs and audit
    state are restored afterwards: they are process-wide."""
    monkeypatch.setattr(audit, "SHADOW_EVERY", 1)
    saved = {k: getattr(AUDITOR, k) for k in REF_KNOBS}
    AUDITOR.reset()
    AUDITOR.enable(interval=1, shadow_every=1, seed=3)
    yield
    AUDITOR.reset()
    for k, v in saved.items():
        setattr(AUDITOR, k, v)


def _plain(obj):
    return json.loads(json.dumps(obj))


class _Pair:
    """tests/test_incremental_faults.py's rig in both packages: 10 warm
    nodes under one seeded churn, a persistent incremental solver each (the
    port's with its auditor). Each engine's passes are logged as (kind,
    reason); a corruption armed for a side fires once, right after that
    side's next advance."""

    def __init__(self, seed, tag, nodes=10, reference=True):
        self.tag = tag
        self.provider = FakeCloudProvider(instance_types(40))
        self.kube = KubeCluster()
        self.churn = testing.Churn(self.kube, seed, tag, min_nodes=8)
        self.churn.seed_nodes(nodes)
        self.cluster = Cluster(self.kube, None)
        self.engine = IncrementalEngine(self.cluster.delta_journal, device="cpu")
        self.auditor = ResidencyAuditor(seed=3)
        self.solver = DenseSolver(min_batch=1, device="cpu", incremental=self.engine, auditor=self.auditor)
        self._armed = {}
        self.passes = self._log(self.engine)
        self.reference = reference
        if reference:
            self.ref_provider = RefProvider(ref_instance_types(40))
            self.ref_kube = RefKubeCluster()
            self.ref_churn = RefChurn(self.ref_kube, seed, tag, min_nodes=8)
            self.ref_churn.seed_nodes(nodes)
            self.ref_cluster = RefCluster(self.ref_kube, None)
            self.ref_engine = RefEngine(self.ref_cluster.delta_journal)
            self.ref_solver = RefDenseSolver(min_batch=1, use_mesh=False, incremental=self.ref_engine)
            self.ref_passes = self._log(self.ref_engine)

    def _log(self, engine):
        log = []
        advance = engine.advance

        def logging_advance(*args):
            adv = advance(*args)
            log.append((adv.kind, adv.reason))
            corrupt = self._armed.pop(id(engine), None)
            if corrupt is not None:
                corrupt(engine)
            return adv

        engine.advance = logging_advance
        return log

    def arm(self, port, ref):
        """Corrupt each side's resident state right after its next advance."""
        self._armed[id(self.engine)] = port
        self._armed[id(self.ref_engine)] = ref

    def step(self):
        self.churn.step()
        if self.reference:
            self.ref_churn.step()

    def solve(self, step, count=8, cpu=None):
        """One batch through the port's persistent solver (and the
        reference's, whose placements must be the same); `cpu` fixes every
        pod's request, else 0.25 or 0.5 by seed. Returns the port's
        fingerprint."""
        prng = np.random.default_rng(7700 + step)
        sizes = [cpu if cpu is not None else float(prng.choice([0.25, 0.5])) for _ in range(count)]
        got = self._solve(self.solver, step, sizes)
        if self.reference:
            pods = ref_rename([ref_make_pod(labels={"app": "faulted"}, requests={"cpu": c, "memory": "256Mi"}) for c in sizes], f"{self.tag}{step}")
            self.ref_solver.stats = self.ref_solver.stats.__class__()
            scheduler = ref_build_scheduler(
                ref_provisioners(), self.ref_provider, pods, cluster=self.ref_cluster,
                state_nodes=self.ref_cluster.nodes_snapshot(), dense_solver=self.ref_solver,
            )
            want = _fingerprint(scheduler.solve(pods), scheduler, self.ref_solver.stats)
            assert got == want, f"{self.tag} step {step}: the port placed the pass differently from the reference"
            assert self.passes == self.ref_passes, f"{self.tag} step {step}: pass kinds or reasons differ"
        return got

    def _solve(self, solver, step, sizes):
        pods = testing.rename(
            [testing.make_pod(labels={"app": "faulted"}, requests={"cpu": c, "memory": "256Mi"}) for c in sizes],
            f"{self.tag}{step}",
        )
        solver.stats = solver.stats.__class__()
        scheduler = build_scheduler(
            testing.campaign_provisioners(), self.provider, pods, cluster=self.cluster,
            state_nodes=self.cluster.nodes_snapshot(), dense_solver=solver,
        )
        results = scheduler.solve(pods)
        placed = sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)
        assert placed == len(pods), f"{self.tag} step {step}: a divergence must never lose pods"
        return _fingerprint(results, scheduler, solver.stats)

    def warm_to_delta(self):
        """A cold pass, then a churned delta pass."""
        self.solve(0)
        self.step()
        self.solve(1)
        assert self.engine.passes[PASS_DELTA] == 1 and self.auditor.divergences == {}

    def assert_same_audits(self):
        """Both auditors counted and reported the same."""
        ref = AUDITOR.stats()
        assert (self.auditor.passes, self.auditor.audits, self.auditor.heals, self.auditor.clean_streak) == (
            ref["passes_seen"], ref["audits"], ref["heals"], ref["clean_streak"]
        )
        assert self.auditor.divergences == ref["divergences"]
        last = ref["last_divergence"]
        if last is None:
            assert self.auditor.last_divergence is None
        else:
            last.pop("t")
            assert _plain(self.auditor.last_divergence) == last

    def assert_healed_then_fresh(self, step):
        """After a heal: on both sides the next pass is a full re-encode
        attributed to the audit; it places pods exactly as a fresh solver
        does."""
        assert self.engine._resident is None and self.ref_engine._resident is None, "the heal must drop residency before the fill consumes it"
        self.step()
        got = self.solve(step)
        assert self.passes[-1] == (PASS_FULL, "audit") and self.engine.invalidations.get("audit") == 1
        want = self._fresh(step)
        assert got["views"] == want["views"] and got["new_nodes"] == want["new_nodes"] and got["topology"] == want["topology"]
        assert self.auditor.clean_streak >= 1, "the rebuilt state must audit clean"
        self.assert_same_audits()

    def _fresh(self, step):
        prng = np.random.default_rng(7700 + step)
        return self._solve(DenseSolver(min_batch=1, device="cpu"), step, [float(prng.choice([0.25, 0.5])) for _ in range(8)])


def test_clean_churn_audits_zero_divergences():
    pair = _Pair(9200, "aud")
    pair.warm_to_delta()
    for step in range(2, 5):
        pair.step()
        pair.solve(step)
    assert pair.auditor.divergences == {} and pair.auditor.heals == 0
    assert pair.auditor.audits >= 5, "every resident pass is audited"
    assert pair.auditor.clean_streak == pair.auditor.audits
    assert pair.solver.stats.audit_seconds > 0.0
    pair.assert_same_audits()


def test_a_flipped_mirror_row_is_row_drift_and_heals():
    pair = _Pair(9300, "drift")
    pair.warm_to_delta()

    def flip(engine):
        engine._resident.enc.avail_tol[0] += 1.0

    pair.arm(flip, flip)
    pair.step()
    pair.solve(2)
    assert pair.auditor.divergences == {KIND_ROW_DRIFT: 1} and pair.auditor.heals == 1
    last = pair.auditor.last_divergence
    assert last["kinds"] == [KIND_ROW_DRIFT] and len(last["rows"]) == 1
    assert last["findings"][0]["fields"] == ["avail_tol"]
    pair.assert_same_audits()
    pair.assert_healed_then_fresh(3)


def test_a_suppressed_journal_record_is_a_missed_delta():
    pair = _Pair(9400, "miss")
    pair.warm_to_delta()
    # a node the last pass did not dirty, so only the journal could name it
    victim = next(n for n in pair.engine._resident.names if n not in pair.engine._resident.prev_dirty)
    assert victim not in pair.ref_engine._resident.prev_dirty
    fired = {}

    def seam(package):
        def suppress_first_pod_record(node, kind):
            if package not in fired and kind in (delta.POD_BOUND, delta.POD_REMOVED):
                fired[package] = (node, kind)
                return True
            return False

        return suppress_first_pod_record

    # an out-of-band bind through each package's real feed whose record the
    # seam swallows: cluster truth moves, the journal stays silent
    for package, module, kube, make_pod in (("port", delta, pair.kube, testing.make_pod), ("ref", ref_delta, pair.ref_kube, ref_make_pod)):
        module.set_corrupt_seam(seam(package))
        try:
            kube.create(
                make_pod(
                    name="miss-suppressed-pod", labels={"app": "standing"}, requests={"cpu": 0.5, "memory": "512Mi"},
                    node_name=victim, phase="Running", unschedulable=False,
                )
            )
        finally:
            module.set_corrupt_seam(None)
    assert fired == {"port": (victim, delta.POD_BOUND), "ref": (victim, ref_delta.POD_BOUND)}
    pair.solve(2)
    assert pair.auditor.divergences == {KIND_MISSED_DELTA: 1} and pair.auditor.heals == 1
    last = pair.auditor.last_divergence
    assert last["kinds"] == [KIND_MISSED_DELTA] and last["rows"] == [victim]
    assert last["journal_window"] is not None and victim not in last["journal_window"]
    pair.assert_same_audits()
    pair.assert_healed_then_fresh(3)


def test_a_perturbed_device_element_is_device_corrupt():
    pair = _Pair(9500, "dev")
    pair.warm_to_delta()
    assert pair.ref_engine._resident.head_dev is not None, "the reference keeps its buffer on the JAX device"

    def perturb(engine):
        engine._resident.head_dev[0, 0] += 1.0

    def perturb_ref(engine):
        engine._resident.head_dev = engine._resident.head_dev.at[0, 0].add(1.0)

    pair.arm(perturb, perturb_ref)
    pair.step()
    pair.solve(2)
    assert pair.auditor.divergences == {KIND_DEVICE_CORRUPT: 1} and pair.auditor.heals == 1
    last = pair.auditor.last_divergence
    assert last["kinds"] == [KIND_DEVICE_CORRUPT]
    assert last["findings"][-1]["fields"] == ["head_dev"], "the host mirror stayed exact: only the device check sees it"
    pair.assert_same_audits()
    pair.assert_healed_then_fresh(3)


def test_a_stale_cube_is_cube_stale_and_the_cache_is_dropped():
    import jax.numpy as jnp

    pair = _Pair(9600, "cube")
    pair.warm_to_delta()
    avail = np.ones((2, 3, 2), dtype=bool)
    pair.solver._avail_cube_dev = (avail, torch.zeros((2, 6), dtype=torch.float32))
    pair.ref_solver._avail_cube_dev = (avail, jnp.zeros((2, 6), jnp.float32))
    pair.step()
    pair.solve(2)
    assert pair.auditor.divergences == {KIND_CUBE_STALE: 1} and pair.auditor.heals == 1
    assert pair.auditor.last_divergence["cube_stale"] is True
    assert pair.solver._avail_cube_dev is None or pair.solver._avail_cube_dev[0] is not avail, "a stale cube must not be reused"
    assert (pair.solver._avail_cube_dev is None) == (pair.ref_solver._avail_cube_dev is None)
    pair.assert_same_audits()
    pair.assert_healed_then_fresh(3)


def test_a_cube_cached_from_its_own_array_audits_clean():
    """Batches that overflow the warm nodes reach the availability mask:
    the solver caches the catalog's cube on its device at the first, reuses
    that very tensor at the next, and the auditor finds it clean; both
    place as the reference does and as a fresh solver does."""
    pair = _Pair(9650, "cubeok")
    pair.warm_to_delta()
    assert pair.solver._avail_cube_dev is None, "the warm nodes took every pod so far"
    pair.step()
    pair.solve(2, count=50, cpu=6.0)
    cached = pair.solver._avail_cube_dev
    assert cached is not None, "an overflowing batch must reach the availability mask"
    avail, cube = cached
    assert torch.equal(cube, torch.from_numpy(avail.reshape(avail.shape[0], -1).astype(np.float32)))
    pair.step()
    got = pair.solve(3, count=50, cpu=6.0)
    assert pair.solver._avail_cube_dev[1] is cube, "the cached cube is reused, not uploaded again"
    assert pair.auditor.divergences == {} and pair.auditor.audits == 4
    pair.assert_same_audits()
    fresh = pair._solve(DenseSolver(min_batch=1, device="cpu"), 3, [6.0] * 50)
    assert got["views"] == fresh["views"] and got["new_nodes"] == fresh["new_nodes"]


def test_the_sampled_draw_is_int_seeded_and_deterministic(monkeypatch):
    monkeypatch.setattr(audit, "SHADOW_EVERY", DEFAULT_SHADOW_EVERY)
    a, b = ResidencyAuditor(seed=7), ResidencyAuditor(seed=7)
    draws = [a.sample(300, i) for i in range(1, 8)]
    assert draws == [b.sample(300, i) for i in range(1, 8)], "one seed, one draw"
    for i, d in zip(range(1, 8), draws):
        assert len(d) == 8 and d == sorted(set(d))
        assert d == sorted(random.Random(split_seed(7, f"audit-{i}")).sample(range(300), 8))
    assert len({tuple(d) for d in draws}) > 1, "successive audits walk the cluster"
    assert draws != [ResidencyAuditor(seed=8).sample(300, i) for i in range(1, 8)]
    # every SHADOW_EVERY-th audit is a full shadow; a small cluster is
    # always audited whole; past the byte budget no audit is a shadow
    assert a.sample(300, 0) == a.sample(300, 8) == list(range(300))
    assert a.sample(5, 3) == list(range(5))
    monkeypatch.setattr(audit, "SHADOW_BUDGET_BYTES", 0)
    assert len(a.sample(300, 0)) == 8


def test_sampled_audits_run_clean_through_the_solve(monkeypatch):
    """The default cadence on a cluster larger than the sample: audit 0 is a
    full shadow, audits 1-7 seeded draws of 8 rows (the draw the JAX
    package's auditor cannot make on Python 3.12, so the port runs alone)."""
    monkeypatch.setattr(audit, "SHADOW_EVERY", DEFAULT_SHADOW_EVERY)
    pair = _Pair(9700, "smp", nodes=30, reference=False)
    pair.warm_to_delta()
    for step in range(2, 9):
        pair.step()
        pair.solve(step)
    assert pair.auditor.audits == 9 and pair.auditor.divergences == {}


@pytest.mark.parametrize("interval", [2, 3])
def test_the_cadence_audits_every_nth_pass(monkeypatch, interval):
    monkeypatch.setattr(audit, "INTERVAL", interval)
    AUDITOR.enable(interval=interval)
    pair = _Pair(9900 + interval, f"cad{interval}")
    pair.warm_to_delta()
    for step in range(2, 8):
        pair.step()
        pair.solve(step)
    assert pair.auditor.passes == 8 and pair.auditor.audits == 8 // interval
    pair.assert_same_audits()
