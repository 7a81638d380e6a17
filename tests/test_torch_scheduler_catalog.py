"""The reference's scheduler catalog suites on the dense path, held on both packages.

- tests/test_scheduler_catalog.py: every case that takes the `path`
  fixture, with path="dense" (DenseSolver(min_batch=1));
- tests/test_instance_selection.py: every case (each solves on the host
  loop and on the dense path);
- tests/test_cost_parity.py::test_warm_cost_parity_sweep;
- tests/test_capacity_resilience.py::TestDenseAvailabilityMask.

The first two suites run as written, twice: once as the JAX package's test
module, once as a port copy of it, the module's source with its imports of
the JAX package (and of tests/helpers.py and tests/test_provisioning.py's
env_with) pointed at the port and the dense solver on the CPU. Each case's
own assertions run on both, and every solve a case makes is recorded
through the module's build_scheduler (new nodes by first option and pods,
existing placements, unschedulable pods, node count and cost; pods by
their index in the batch); a case that provisions through an Environment
adds the node types it launched. The two packages' records must be equal.
The reference's residency auditor is disabled (its tuple seed, ROADMAP C);
the module-level price stream of tests/test_instance_selection.py is
reseeded on both sides before each case.
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_dense_differential import DiffKit
from tests.test_torch_provisioning import reference_singletons  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# what a port copy of a reference test module changes in its source
SUBSTITUTIONS = (
    ("from karpenter_tpu.", "from karpenter_tpu_torch."),
    ("from tests.helpers import", "from karpenter_tpu_torch.testing import"),
    ("from tests.test_provisioning import env_with", "env_with = port_env_with"),
    ("DenseSolver(min_batch=1)", 'DenseSolver(min_batch=1, device="cpu")'),
)


def port_env_with(provisioners=None, instance_types_list=None, dense=False):
    """tests/test_provisioning.py's env_with on the port's Environment."""
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.testing import Environment, make_provisioner

    env = Environment(instance_types=instance_types_list, dense_solver=DenseSolver(min_batch=1, device="cpu") if dense else None)
    for prov in provisioners or [make_provisioner()]:
        env.kube.create(prov)
    return env


def port_copy(name: str, extra=(), inject=None, optional=()) -> types.ModuleType:
    """tests/<name>.py executed with SUBSTITUTIONS, then the module's own
    `extra` (old, new) pairs, applied, as a module of its own; `inject`
    names go into its namespace first. `optional` pairs apply where their
    old text occurs (a family of modules' shared substitutions)."""
    path = REPO / "tests" / f"{name}.py"
    source = path.read_text()
    for old, new in SUBSTITUTIONS:
        source = source.replace(old, new)
    for old, new in extra:
        assert old in source, f"tests/{name}.py: nothing to substitute for {old!r}"
        source = source.replace(old, new)
    for old, new in optional:
        source = source.replace(old, new)
    rest = source.replace("karpenter_tpu_torch", "")
    assert "karpenter_tpu." not in rest and "karpenter_tpu import" not in rest, f"tests/{name}.py: an import of the JAX package survived"
    module = types.ModuleType(f"tests._port_copy_{name}")
    module.__file__ = str(path)
    module.port_env_with = port_env_with
    module.__dict__.update(inject or {})
    sys.modules[module.__name__] = module  # dataclasses resolve annotations through it
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


REFERENCE = {name: importlib.import_module(f"tests.{name}") for name in ("test_scheduler_catalog", "test_instance_selection")}
PORT = {name: port_copy(name) for name in REFERENCE}


def _param_sets(fn, cls) -> list:
    """The (id, kwargs) combinations of a test's parametrize marks."""
    marks = [m for m in list(getattr(cls, "pytestmark", [])) + list(getattr(fn, "pytestmark", [])) if m.name == "parametrize"]
    axes = []
    for mark in marks:
        names = [n.strip() for n in mark.args[0].split(",")] if isinstance(mark.args[0], str) else list(mark.args[0])
        values = [v.values if hasattr(v, "values") else v for v in mark.args[1]]
        axes.append([(names, v if len(names) > 1 else (v,)) for v in values])
    out = []
    for combo in itertools.product(*axes):
        kwargs = {n: v for names, values in combo for n, v in zip(names, values)}
        out.append(("-".join(str(v) for v in kwargs.values()), kwargs))
    return out


def catalog_cases(name: str, fixture_path: bool, path: str = "dense", reference=None) -> list:
    """(module name, class, method, kwargs) for every test method of the
    reference module (`reference`, by default REFERENCE[name]), then
    (module name, None, function, kwargs) for its module-level test
    functions; with `fixture_path`, only those taking the `path` fixture.
    A test that takes the fixture runs at `path`."""
    module = reference if reference is not None else REFERENCE[name]
    tests = [
        (cls_name, cls, method, fn)
        for cls_name, cls in vars(module).items()
        if cls_name.startswith("Test") and isinstance(cls, type)
        for method, fn in vars(cls).items()
        if method.startswith("test_")
    ]
    tests += [(None, None, fn_name, fn) for fn_name, fn in vars(module).items() if fn_name.startswith("test_") and inspect.isfunction(fn)]
    cases = []
    for cls_name, cls, method, fn in tests:
        takes_path = "path" in inspect.signature(fn).parameters
        if fixture_path and not takes_path:
            continue
        for pid, kwargs in _param_sets(fn, cls):
            if takes_path:
                kwargs = {"path": path, **kwargs}
            case_id = (f"{cls_name}::{method}" if cls_name else method) + (f"[{pid}]" if pid else "")
            cases.append(pytest.param(name, cls_name, method, kwargs, id=case_id))
    return cases


def solve_record(results, batch) -> dict:
    """One solve, in package-neutral terms: pods by their index in the batch."""
    index = {p.metadata.name: i for i, p in enumerate(batch)}

    def pods_of(pods):
        return tuple(sorted(index.get(p.metadata.name, -1) for p in pods))

    new = sorted(
        (n.instance_type_options[0].name() if n.instance_type_options else "", pods_of(n.pods))
        for n in results.new_nodes
        if n.pods
    )
    prices = sorted(min(it.price() for it in n.instance_type_options) for n in results.new_nodes if n.pods and n.instance_type_options)
    return {
        "new": new,
        "existing": sorted(pods_of(v.pods) for v in results.existing_nodes if v.pods),
        "unschedulable": sorted(index.get(p.metadata.name, -1) for p in results.unschedulable),
        "nodes": len(new),
        "cost": sum(prices),
    }


def _recording(monkeypatch, module, sink: list) -> None:
    """Every scheduler the module builds records each of its solves."""
    real = module.build_scheduler

    def build(*args, **kwargs):
        scheduler = real(*args, **kwargs)
        solve = scheduler.solve

        def recorded(batch):
            results = solve(batch)
            sink.append(solve_record(results, batch))
            return results

        scheduler.solve = recorded
        return scheduler

    monkeypatch.setattr(module, "build_scheduler", build)


def _run_case(monkeypatch, module, cls_name: str, method: str, kwargs: dict, env_hook) -> list:
    """The case on one package's module; its solves' records, then the
    node types each Environment it built (through `env_hook`, the module
    and name its env_with is read from) launched."""
    sink, envs = [], []
    _recording(monkeypatch, module, sink)
    env_module, env_name = env_hook
    real_env_with = getattr(env_module, env_name)
    monkeypatch.setattr(env_module, env_name, lambda *a, **kw: envs.append(real_env_with(*a, **kw)) or envs[-1])
    if hasattr(module, "_rng"):
        monkeypatch.setattr(module, "_rng", np.random.default_rng(123))
    getattr(getattr(module, cls_name)(), method)(**kwargs)
    launched = [sorted(n.metadata.labels.get("node.kubernetes.io/instance-type") for n in env.kube.list_nodes()) for env in envs]
    return sink + launched


@pytest.mark.parametrize(
    "name,cls_name,method,kwargs",
    catalog_cases("test_scheduler_catalog", fixture_path=True) + catalog_cases("test_instance_selection", fixture_path=False),
)
def test_catalog_case_on_both_packages(name, cls_name, method, kwargs, monkeypatch):
    import tests.test_provisioning as ref_provisioning

    ref = _run_case(monkeypatch, REFERENCE[name], cls_name, method, kwargs, (ref_provisioning, "env_with"))
    port = _run_case(monkeypatch, PORT[name], cls_name, method, kwargs, (PORT[name], "port_env_with"))
    assert ref, "the case solved nothing that was recorded"
    assert port == ref


# -- tests/test_cost_parity.py::test_warm_cost_parity_sweep --------------------

PARITY_SEEDS = 40
PER_SEED_ALLOWANCE = 5  # cheapest-node units over host
AGGREGATE_RATIO = 1.01


def _parity_costs(k: DiffKit, seed: int):
    """tests/test_cost_parity.py's _costs: one seed's campaign instance,
    dense and host, priced."""

    def instance():
        rng = np.random.default_rng(1000 + seed)
        provider = k.fake.FakeCloudProvider(k.fake.instance_types(int(rng.integers(20, 120))))
        pods = k.rename(k.random_workload(rng, int(rng.integers(40, 140))), seed)
        return provider, pods, k.random_states(rng)

    provider, pods_d, states_d = instance()
    provider2, pods_h, states_h = instance()
    dres = k.build_scheduler(k.campaign_provisioners(), provider, pods_d, state_nodes=states_d, dense_solver=k.solver()).solve(pods_d)
    hres = k.build_scheduler(k.campaign_provisioners(), provider2, pods_h, state_nodes=states_h).solve(pods_h)
    dense_cost = sum(n.instance_type_options[0].price() for n in dres.new_nodes if n.pods)
    host_cost = sum(n.instance_type_options[0].price() for n in hres.new_nodes if n.pods)
    cheapest = min(it.price() for it in provider.get_instance_types(k.make_provisioner()))
    return dense_cost, host_cost, cheapest, solve_record(dres, pods_d), solve_record(hres, pods_h)


def test_warm_cost_parity_sweep():
    records = {}
    for side in ("ref", "port"):
        k = DiffKit(side, "dense")
        total_dense = total_host = 0.0
        seeds = []
        for seed in range(PARITY_SEEDS):
            dense_cost, host_cost, cheapest, dense_rec, host_rec = _parity_costs(k, seed)
            total_dense += dense_cost
            total_host += host_cost
            if host_cost > 0:
                assert dense_cost <= host_cost + PER_SEED_ALLOWANCE * cheapest + 1e-6, f"{side} seed {seed}: dense {dense_cost:.4f} vs host {host_cost:.4f}"
            seeds.append((dense_cost, host_cost, cheapest, dense_rec, host_rec))
        assert total_host > 0
        assert total_dense / total_host <= AGGREGATE_RATIO, f"{side}: aggregate dense/host ratio {total_dense / total_host:.4f}"
        records[side] = seeds
    assert records["port"] == records["ref"]


# -- tests/test_capacity_resilience.py::TestDenseAvailabilityMask ---------------


def test_masked_offerings_never_selected_device_side():
    """The dense path with the availability mask active: types whose every
    offering is unavailable are never selected, the mask engages, and no
    fully-masked type survives into a launchable option set."""
    from dataclasses import replace

    records = {}
    for side in ("ref", "port"):
        k = DiffKit(side, "dense")
        catalog = k.fake.instance_types(30)
        masked = {it.name() for it in catalog[:10]}
        for it in catalog[:10]:
            it._offerings = tuple(replace(o, available=False) for o in it._offerings)
        pods = [k.pod(requests={"cpu": "1", "memory": "1Gi"}) for _ in range(64)]
        solver = k.solver()
        results = k.build_scheduler([k.make_provisioner()], k.fake.FakeCloudProvider(catalog), pods, dense_solver=solver).solve(pods)
        assert not results.unschedulable
        assert solver.stats.masked_offerings > 0
        assert solver.stats.mask_seconds > 0
        for node in results.new_nodes:
            assert not (masked & {it.name() for it in node.instance_type_options}), "a fully-masked type survived"
        records[side] = [solve_record(results, pods), solver.stats.masked_offerings]
    assert records["port"] == records["ref"]
