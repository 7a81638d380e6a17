"""The scenario campaign (scenarios/) on the port, held against the JAX package.

- the schema: tests/test_scenario_campaign.py's TestSchemaValidator as
  written on the port (a port copy through `port_copy`);
- the stand-in's workload pod, every scenario's provenance config and
  derived seeds, and a replayed journal's schedule, equal on both packages
  (the solver fault specs once the port's seam names are put in: "cuda" for
  "pallas", "sharded" as it is);
- smoke_campaign() on both packages and both cloud transports, through a
  live Runtime each: the scores that do not depend on time are equal, and
  the acceptance bars hold (all the zero scores zero);
- every solver fault spec the port's campaigns and the orchestrator's draws
  emit names a seam the port consults;
- device_fault_storm and hbm_pressure on the port with their own bars.

The port's Runtimes run on the CPU (`CampaignRunner(device="cpu")`); the JAX
package's singletons are restored after each test (`reference_singletons`).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from tests.test_torch_journal import coherence_witness  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy

REPO = Path(__file__).resolve().parent.parent

# what the port's copies of the scenario suites change in their source
SCENARIO_SUBSTITUTIONS = (("CampaignRunner(", 'CampaignRunner(device="cpu", '),)

_CAMPAIGN = port_copy("test_scenario_campaign", optional=SCENARIO_SUBSTITUTIONS)
TestSchemaValidator = _CAMPAIGN.TestSchemaValidator

# the port's names for the JAX package's solver seams: K1's launch is "cuda"
# where the JAX package's Pallas kernel is "pallas"; the solver mesh's seam
# is "sharded" in both
SEAM_NAMES = {"pallas": "cuda", "sharded": "sharded"}

# the scores held equal on both packages; the latency quantiles, the pending
# integral and the waterfall depend on time, and degraded_solves_total and
# solver_faults_total differ by design where the port holds a batch
COMPARED = (
    "lost_pods",
    "budget_violations",
    "leaked_instances",
    "double_launches",
    "informer_divergences",
    "invariant_violations",
    "leaked_threads",
    "leaked_watches",
    "kube_faults_injected",
    "kube_conflicts_total",
    "chaos_history_digest",
)
ZERO = COMPARED[:9]


@pytest.fixture(autouse=True)
def _slo_teardown():
    """Both packages' SLO accountants off and empty after every test."""
    yield
    import karpenter_tpu.slo as ref_slo
    from karpenter_tpu_torch import slo

    for module in (ref_slo, slo):
        module.SLO.disable()
        module.SLO.reset()


def _scenarios(side: str):
    if side == "ref":
        import karpenter_tpu.scenarios as scenarios
    else:
        import karpenter_tpu_torch.scenarios as scenarios
    return scenarios


def _port_specs(specs):
    """The JAX package's solver fault specs under the port's seam names."""
    out = []
    for spec in specs or ():
        entry = SEAM_NAMES.get(spec.get("entry"), spec.get("entry"))
        if entry is not None:
            out.append(dict(spec, entry=entry))
    return out


def _config(scenario, port_names: bool) -> dict:
    """A scenario's provenance config; the JAX package's with the port's seam names."""
    config = json.loads(json.dumps(scenario.config()))
    if port_names and config["fault_specs"]:
        config["fault_specs"] = _port_specs(config["fault_specs"])
    for primitive in config["primitives"]:
        primitive.pop("history_digest", None)  # a digest of the specs, compared below
    return config


def _all_scenarios(scenarios):
    return scenarios.default_campaign() + scenarios.smoke_campaign() + [scenarios.mini_soak_scenario()]


# -- primitives, the stand-in and replay -----------------------------------------


def test_every_scenario_is_configured_alike_on_both_packages():
    ref, port = (_all_scenarios(_scenarios(side)) for side in ("ref", "port"))
    assert [s.name for s in port] == [s.name for s in ref]
    for r, p in zip(ref, port):
        assert _config(p, port_names=False) == _config(r, port_names=True), r.name
        assert p.derived_seeds() == r.derived_seeds(), r.name
        assert (p.settled is None) == (r.settled is None), r.name
        assert [type(x).__name__ for x in p.primitives] == [type(x).__name__ for x in r.primitives], r.name
        for rp, pp in zip(r.primitives, p.primitives):
            if type(rp).__name__ == "ChaosSchedule":
                want = rp.history()
                want["solver_specs"] = _port_specs(want["solver_specs"])
                assert pp.history() == want, r.name


def test_the_standin_makes_the_same_workload_pod():
    from karpenter_tpu.kube.codec import to_wire as ref_to_wire
    from karpenter_tpu_torch.kube.codec import to_wire

    _scenarios("ref").workload_pod(0.5)  # the packages' name and uid counters apart
    ref_pod = _scenarios("ref").workload_pod(0.5, app="web")
    port_pod = _scenarios("port").workload_pod(0.5, app="web")
    ref_wire, port_wire = ref_to_wire(ref_pod), to_wire(port_pod)
    for wire in (ref_wire, port_wire):
        # the name and uid count the objects each package made before
        assert re.fullmatch(r"load-\d{6}", wire["metadata"].pop("name"))
        assert re.fullmatch(r"uid-\d{8}", wire["metadata"].pop("uid"))
    assert port_wire == ref_wire
    from karpenter_tpu.scenarios.standin import pod_cpu_request as ref_cpu
    from karpenter_tpu_torch.scenarios.standin import pod_cpu_request

    assert pod_cpu_request(port_pod) == ref_cpu(ref_pod) == 0.5


def _created_events(n: int) -> list:
    """A journal's pod `created` stream with uneven gaps, as the JAX
    package's journal writes it (the schema both packages validate)."""
    events, t = [], 100.0
    for i in range(n):
        t += 0.05 * (1 + (i * 7) % 5)
        events.append({"seq": i, "t": round(t, 6), "kind": "pod", "entity": f"default/p-{i:03d}", "event": "created", "attrs": {}})
    return events


def test_a_journal_replays_to_the_same_schedule_on_both_packages():
    events = _created_events(12)
    traces = [_scenarios(side).ReplayTrace.from_events(events, compress=3.0, source="unit") for side in ("ref", "port")]
    ref, port = traces
    assert port.schedule() == ref.schedule() and len(port.schedule()) == 12
    assert port.total_seconds() == ref.total_seconds()
    assert port.config() == ref.config()
    assert port.source_digest == ref.source_digest


def test_storm_scenario_and_score_keys_registered():
    """tests/test_residency_audit.py's case of this name, on the port."""
    from karpenter_tpu_torch import capsule
    from karpenter_tpu_torch.scenarios import schema
    from karpenter_tpu_torch.scenarios.campaign import default_campaign, residency_settled
    from karpenter_tpu_torch.solver.faults import KIND_CORRUPT_ROW, KIND_SUPPRESS_DELTA

    for key in ("residency_divergences", "residency_heals", "audit_passes"):
        assert key in schema.SCORE_KEYS
    assert capsule.TRIGGER_RESIDENCY in capsule.TRIGGERS
    storm = next(s for s in default_campaign() if s.name == "residency_divergence_storm")
    assert storm.residency_audit_interval == 1
    assert storm.settled is residency_settled
    assert sorted(spec["kind"] for spec in storm.fault_specs) == [KIND_CORRUPT_ROW, KIND_SUPPRESS_DELTA]
    soak = next(s for s in default_campaign() if s.name == "chaos_soak")
    assert soak.residency_audit_interval > 0


# -- the seam names --------------------------------------------------------------


def _consulted_seams() -> set:
    """Every entry name the port's code passes to the fault injector's
    check() or corrupt(), read from its source."""
    pattern = re.compile(r"""(?:FAULTS\.check|FAULTS\.corrupt|self\.corrupt)\(\s*["']([a-z-]+)["']""")
    seams = set()
    for path in (REPO / "karpenter_tpu_torch").rglob("*.py"):
        seams.update(pattern.findall(path.read_text()))
    return seams


def test_every_emitted_fault_spec_names_a_seam_the_port_consults():
    from karpenter_tpu_torch.scenarios import ChaosSchedule, chaos_soak_scenario, default_campaign, mini_soak_scenario

    seams = _consulted_seams()
    assert {"plain", "cuda", "chunk", "warmfill", "rebase", "resident-row", "journal-record"} <= seams, seams
    specs = []
    for scenario in default_campaign() + [chaos_soak_scenario(), mini_soak_scenario()]:
        specs += [(scenario.name, spec) for spec in scenario.fault_specs or ()]
    for seed in range(32):
        schedule = ChaosSchedule(seed=seed, solver_faults=3)
        specs += [(f"schedule-{seed}", spec) for spec in schedule.solver_specs()]
    assert len(specs) > 100
    unconsulted = [(name, spec) for name, spec in specs if spec["entry"] not in seams]
    assert unconsulted == []
    # K1's seam is in every device-chaos plan the port draws
    assert {spec["entry"] for _, spec in specs} >= {"plain", "cuda"}


# -- the smoke campaign on both packages ----------------------------------------


def _run_smoke(side: str, transport: str, tmp_path):
    scenarios = _scenarios(side)
    kube_chaos = __import__(f"{'karpenter_tpu' if side == 'ref' else 'karpenter_tpu_torch'}.kube.chaos", fromlist=["KUBE_CHAOS"])
    extra = {"device": "cpu"} if side == "port" else {}
    runner = scenarios.CampaignRunner(out_dir=str(tmp_path / side), transports=(transport,), convergence_timeout=40.0, **extra)
    (doc,) = runner.run(scenarios.smoke_campaign())
    assert scenarios.scenario_doc_errors(doc) == []
    (run,) = doc["runs"]
    assert kube_chaos.KUBE_CHAOS.plan is None  # the runner disarms what it armed
    return run


@pytest.mark.parametrize("transport", ["inprocess", "http"])
def test_smoke_campaign_scores_alike_on_both_packages(tmp_path, transport):
    ref, port = (_run_smoke(side, transport, tmp_path) for side in ("ref", "port"))
    for run in (ref, port):
        scores = run["scores"]
        assert run["converged"] is True, scores
        assert all(scores[key] == 0 for key in ZERO), {key: scores[key] for key in ZERO}
        assert scores["pods_bound"] == scores["pods_desired"] == 8
        assert scores["chaos_history_digest"] is None and scores["kube_conflicts_total"] == 0
        assert scores["breaker_state"] == "closed"
        assert sum(scores["nodes_churned"].values()) >= 1  # the reclaim landed
    assert port["converged"] == ref["converged"]
    assert {key: port["scores"][key] for key in COMPARED} == {key: ref["scores"][key] for key in COMPARED}
    assert port["scores"]["nodes_churned"] == ref["scores"]["nodes_churned"]
    assert port["scores"]["capsule_triggers"] == ref["scores"]["capsule_triggers"] == {}


# -- the device-chaos scenarios on the port -------------------------------------


def _port_run(name: str, tmp_path) -> dict:
    from karpenter_tpu_torch.scenarios import CampaignRunner, default_campaign, scenario_doc_errors

    (scenario,) = [s for s in default_campaign() if s.name == name]
    runner = CampaignRunner(out_dir=str(tmp_path), transports=("inprocess",), convergence_timeout=60.0, device="cpu")
    (doc,) = runner.run([scenario])
    assert scenario_doc_errors(doc) == []
    (run,) = doc["runs"]
    scores = run["scores"]
    assert run["converged"] is True, scores
    assert all(scores[key] == 0 for key in ZERO), {key: scores[key] for key in ZERO}
    assert scores["pods_bound"] == scores["pods_desired"] > 0
    assert scores["breaker_state"] == "closed"
    return scores


def test_device_fault_storm_holds_the_burst_and_recloses_the_breaker(tmp_path):
    """Three injected device-lost faults at "plain" open the breaker; the
    burst that arrives while it is open is held (not solved elsewhere) and
    solved by the half-open probe. Convergence required breaker_reclosed:
    a fault fired, the breaker opened, a breaker-open capsule exists, and
    the breaker was closed at convergence."""
    scores = _port_run("device_fault_storm", tmp_path)
    assert scores["solver_faults_injected"] == 3  # "cuda" is consulted on the card only
    assert scores["solver_faults_total"] == 3
    assert scores["degraded_solves_total"] == 0  # no rung takes the batch off the device
    assert list(scores["capsule_triggers"]) == ["breaker-open"]


def test_hbm_pressure_splits_under_the_budget_and_never_opens_the_breaker(tmp_path, monkeypatch):
    """Two injected HBM faults in a row hold the batch twice and stay under
    the breaker's threshold of three; the 1 KiB budget then splits the bucket
    choice (the chunked rung). A solver on the CPU has no device memory to
    read, so the flight recorder's memory peak is stood in for: zero for the
    first two recorded solves (a faulted solve is recorded too), so both
    planned faults land on unsplit dispatches in a row, then above the
    budget, as the card's peak is once the catalog is resident."""
    from karpenter_tpu_torch import flight

    monkeypatch.setattr(
        flight.FlightRecorder, "hbm_snapshot",
        staticmethod(lambda device=None: (4096, 4096) if len(flight.FLIGHT.records()) >= 2 else (0, 0)),
    )
    scores = _port_run("hbm_pressure", tmp_path)
    assert scores["solver_faults_injected"] == 2
    assert scores["solver_faults_total"] == 2
    assert scores["degraded_solves_total"] >= 1  # the chunked rung, from the budget split
    assert scores["capsule_triggers"] == {}  # the breaker never opened
