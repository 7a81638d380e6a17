"""Decision tracing, the /metrics listener and its debug routes on the port.

- tests/test_tracing.py, every case, as written on the port (a port copy
  of the module through `port_copy`): the tracer core, the provisioning
  round's trace, the decision log, the overhead guard, the bounded events
  and the `gen_docs --check` subprocess case, which on the port checks a
  file the port's gen_docs rendered (the repository's METRICS.md is the
  JAX package's render);
- tests/test_observability.py's TestTracingRoutes and TestObservabilityServer
  (the probes, /metrics and the live-profiling endpoints);
- the traced dense solve on both packages: the same span tree, and the same
  pods, groups, buckets, committed and to_host attributes;
- the family set: both packages' gen_docs renders, whose rows are equal
  less exactly the families of the JAX package's modules the port does not
  have yet, and but for the help text of the flight recorder's two
  `karpenter_jax_*` families, which count nvcc builds on the port.

Each package's singletons are restored after every test: the JAX package's
through `reference_singletons`, the port's tracer, decision log and lock
witness through `port_telemetry`.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def port_telemetry():
    """The port's tracer, decision log and lock witness, disabled and empty
    after every test however it ends (their default); and tracemalloc
    stopped again if the test started it (/debug/pprof/heap leaves it on
    for the process, and a later test in the same worker, such as
    tests/test_invariants.py's memory-slope case, counts on finding it
    off)."""
    import tracemalloc

    from karpenter_tpu_torch.analysis.witness import WITNESS
    from karpenter_tpu_torch.tracing import DECISIONS, TRACER

    was_tracing = tracemalloc.is_tracing()
    try:
        yield
    finally:
        TRACER.disable()
        TRACER.reset()
        DECISIONS.reset()
        WITNESS.disable()
        WITNESS.reset()
        if not was_tracing and tracemalloc.is_tracing():
            tracemalloc.stop()


def without(cls, *methods):
    """`cls` with the named test methods left out of collection."""
    return type(cls.__name__, (cls,), {m: None for m in methods})


def rendered_metrics(tmp_path) -> Path:
    """The port's gen_docs render, in a process of its own (a fresh
    registry), written to tmp_path/METRICS.md."""
    path = tmp_path / "METRICS.md"
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.gen_docs"], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    path.write_text(proc.stdout)
    return path


# -- tests/test_tracing.py ------------------------------------------------------

_TRACING = port_copy(
    "test_tracing",
    extra=(
        ("from karpenter_tpu import tracing", "from karpenter_tpu_torch import tracing"),
        ("from tests.env import Environment", "from karpenter_tpu_torch.testing import Environment"),
        ("from karpenter_tpu_torch.runtime import LeaderElector, Runtime", "from karpenter_tpu_torch.runtime import Runtime"),
        ("            LeaderElector._leader = None\n", ""),
        ('committed = (REPO_ROOT / "METRICS.md").read_text()', "committed = rendered_metrics(tmp_path).read_text()"),
        ("str(REPO_ROOT / 'METRICS.md')", "str(tmp_path / 'METRICS.md')"),
    ),
    inject={"rendered_metrics": rendered_metrics},
)
global_tracing = _TRACING.global_tracing
TestTracerCore = _TRACING.TestTracerCore
TestPipelineTrace = _TRACING.TestPipelineTrace
TestDecisionLog = _TRACING.TestDecisionLog
TestOverheadGuard = _TRACING.TestOverheadGuard
TestBoundedEvents = _TRACING.TestBoundedEvents
TestGenDocsCheck = _TRACING.TestGenDocsCheck


# -- tests/test_observability.py ---------------------------------------------------

_OBSERVABILITY = port_copy(
    "test_observability", extra=(("from karpenter_tpu import tracing", "from karpenter_tpu_torch import tracing"),)
)
TestObservabilityServer = _OBSERVABILITY.TestObservabilityServer
TestTracingRoutes = _OBSERVABILITY.TestTracingRoutes


# -- the traced dense solve on both packages --------------------------------------

# the attributes each package's phase spans must agree on
SOLVE_ATTRIBUTES = ("pods", "groups", "buckets", "committed", "to_host", "on_existing")


def _span_shape(node: dict) -> tuple:
    attrs = tuple(sorted((k, v) for k, v in node["attributes"].items() if k in SOLVE_ATTRIBUTES))
    return node["name"], attrs, tuple(_span_shape(c) for c in node["children"])


def _traced_round(side: str):
    if side == "ref":
        from karpenter_tpu.solver import DenseSolver
        from karpenter_tpu.tracing import DECISIONS, TRACER
        from tests.env import Environment
        from tests.helpers import make_pod, make_provisioner

        solver = DenseSolver(min_batch=1)
    else:
        from karpenter_tpu_torch.solver import DenseSolver
        from karpenter_tpu_torch.testing import Environment, make_pod, make_provisioner
        from karpenter_tpu_torch.tracing import DECISIONS, TRACER

        solver = DenseSolver(min_batch=1, device="cpu")
    TRACER.enable()
    TRACER.reset()
    DECISIONS.reset()
    try:
        env = Environment(dense_solver=solver)
        env.kube.create(make_provisioner())
        for i in range(24):
            cpu = 0.5 if i % 3 else 2
            env.kube.create(make_pod(name=f"traced-{i}", requests={"cpu": cpu, "memory": "1Gi"}))
        env.provision()
        tree = TRACER.span_tree(env.provisioner_controller.last_trace_id)
        outcomes = sorted(r["outcome"] for r in DECISIONS.recent(limit=1000))
    finally:
        TRACER.disable()
        TRACER.reset()
        DECISIONS.reset()
    solve = next(c for c in tree["children"] if c["name"] == "solve")
    return _span_shape(solve), solve["attributes"], outcomes


def test_traced_dense_solve_spans_on_both_packages():
    ref, port = _traced_round("ref"), _traced_round("port")
    shape, attrs, outcomes = port
    phases = [c[0] for c in shape[2]]
    assert phases == ["encode", "fill", "device", "commit"], phases
    device = shape[2][2]
    assert [c[0] for c in device[2]] == ["mask", "assemble"]
    assert dict(device[1])["buckets"] > 0
    assert outcomes == ["placed-new"] * 24
    assert port == ref


# -- the family set -------------------------------------------------------------------

# every family the JAX package registers that the port's render lacks, with
# the JAX package's module that defines it; a slice that ports one of these
# modules brings its families back and takes them off this list. Every
# module that registers a family is ported, so the list is empty
MISSING_FAMILIES: dict = {}

# shared families whose help text the port words for its own instrument: the
# flight recorder counts nvcc kernel builds where the JAX package counts XLA
# compilations (flight.py keeps the family names so dashboards line up); the
# solver fault domain holds batches where the JAX package falls back to the
# host loop (solver/faults.py)
HELP_DIFFERS = (
    "karpenter_jax_compilations_total",
    "karpenter_jax_compile_seconds_total",
    "karpenter_solver_faults_total",
    "karpenter_solver_degraded_solves_total",
    "karpenter_solver_breaker_state",
)


def _rows(module: str) -> dict:
    proc = subprocess.run([sys.executable, "-m", module], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return {line.split("`")[1]: line for line in proc.stdout.splitlines() if line.startswith("| `")}


def test_family_set_is_the_reference_less_the_unported_modules():
    ref, port = _rows("karpenter_tpu.cmd.gen_docs"), _rows("karpenter_tpu_torch.cmd.gen_docs")
    assert set(port) <= set(ref), f"families the JAX package lacks: {sorted(set(port) - set(ref))}"
    same = [name for name in port if name not in HELP_DIFFERS]
    assert {name: port[name] for name in same} == {name: ref[name] for name in same}, "a shared family's row differs"
    for name in HELP_DIFFERS:
        # name, type and labels equal; only the help text (the last cell) differs
        assert port[name].split("|")[:4] == ref[name].split("|")[:4], (port[name], ref[name])
    assert sorted(set(ref) - set(port)) == sorted(MISSING_FAMILIES)
    for name, module in MISSING_FAMILIES.items():
        assert f'"{name}"' in (REPO / "karpenter_tpu" / module).read_text(), f"{name} is not defined in {module}"
        assert not (REPO / "karpenter_tpu_torch" / module).exists(), f"{module} is ported: bring {name} back"


def test_gen_docs_check_needs_a_path(tmp_path):
    from karpenter_tpu_torch.cmd import gen_docs

    assert gen_docs.main(["--check"]) == 2
    assert gen_docs.check(str(tmp_path / "absent.md")) == 1
