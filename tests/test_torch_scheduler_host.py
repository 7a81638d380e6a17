"""The reference's host-scheduler suites held on the port, case by case.

Each reference module runs as written twice: once as the JAX package's test
module, once as a port copy of it (`port_copy`: its imports of the JAX
package and of tests/helpers.py pointed at the port, the dense solver on
the CPU, its imports of the other copied suites pointed at their copies).
Every case's own assertions run on both, and every solve it makes is
recorded through the `build_scheduler` of the module that calls it
(`solve_record`: new nodes by first option and pods, existing placements,
unschedulable pods, node count, cost; pods by their index in the batch).
The two packages' records must be equal.

- tests/test_scheduler.py, _scheduler_affinity_extended.py,
  _scheduler_existing_nodes.py, _scheduler_topology_combined.py: the host
  loop (`scheduler/scheduler.py`, `scheduler/topology.py`), the in-flight
  nodes of `controllers/state/cluster.py`;
- tests/test_scheduler_catalog.py at path="host" (its dense half is in
  tests/test_torch_scheduler_catalog.py);
- tests/test_topology_depth.py at both paths;
- tests/test_state.py: the cluster state's own assertions on the port's
  `controllers/state/cluster.py` (it solves nothing).

The helpers here (`SuiteSide`, `run_case`, `cases_of`) serve
tests/test_torch_requirements.py too. The reference's residency auditor is
disabled (`reference_auditor_off`, ROADMAP C), the JAX package's
singletons restored (`reference_singletons`), and what a case's Runtime
leaves process-wide on either package put back (`runtime_process_state`).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import logging
import sys

import numpy as np
import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import _restore, _state, reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import PORT as CATALOG_PORT
from tests.test_torch_scheduler_catalog import _recording, catalog_cases, port_copy

@pytest.fixture(autouse=True)
def runtime_process_state():
    """Put back what a case's Runtime leaves process-wide and
    reference_singletons does not hold: each package's log handler, level
    and propagation (a package logger that stops propagating hides its
    records from pytest's caplog in every later test of the worker) and
    the port's tracer."""
    from karpenter_tpu import logsetup as ref_logsetup
    from karpenter_tpu_torch import logsetup as port_logsetup
    from karpenter_tpu_torch.tracing import DECISIONS, TRACER

    saved = [(obj, _state(obj)) for obj in (TRACER, DECISIONS)]
    loggers = []
    for logsetup in (ref_logsetup, port_logsetup):
        root = logging.getLogger(logsetup.ROOT)
        loggers.append((logsetup, root, root.propagate, root.level, list(root.handlers), logsetup._configured))
    try:
        yield
    finally:
        for obj, state in saved:
            _restore(obj, state)
        for logsetup, root, propagate, level, handlers, configured in loggers:
            for handler in list(root.handlers):
                if handler not in handlers:
                    root.removeHandler(handler)
            root.propagate, logsetup._configured = propagate, configured
            root.setLevel(level)


# what every copied suite changes where it occurs: its imports of the other
# suites point at their port copies (registered in sys.modules by port_copy)
SUITE_IMPORTS = (
    ("from tests.test_scheduler import", "from tests._port_copy_test_scheduler import"),
    ("from tests.test_scheduler_catalog import", "from tests._port_copy_test_scheduler_catalog import"),
    ("from tests.test_differential_campaign import", "from tests._port_copy_test_differential_campaign import"),
)


class SuiteSide:
    """One package's side of a family of suites: each suite's module, and
    per suite the module names a case's solves go through (`holders`), the
    (module, name) of the environment classes whose instances' clusters
    are recorded (`envs`), the functions whose returns are recorded
    (`values`) and a record of the case's fixture values taken after it
    (`after`)."""

    def __init__(self, modules: dict, holders: dict, envs: dict = None, values: dict = None, after: dict = None):
        self.modules, self.holders = modules, holders
        self.envs, self.values, self.after = envs or {}, values or {}, after or {}


def _plain(value):
    """A returned value in package-neutral terms."""
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.shape, value.tolist())
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def env_record(env) -> dict:
    """An environment's cluster after a case: per node its type, zone,
    capacity type and pods bound; the pods left unbound."""
    from collections import Counter

    labels = ("node.kubernetes.io/instance-type", "topology.kubernetes.io/zone", "karpenter.sh/capacity-type")
    bound = Counter(p.spec.node_name for p in env.kube.list_pods() if p.spec.node_name)
    return {
        "nodes": sorted(tuple(n.metadata.labels.get(k, "") for k in labels) + (bound.get(n.metadata.name, 0),) for n in env.kube.list_nodes()),
        "unbound": sum(1 for p in env.kube.list_pods() if not p.spec.node_name),
    }


class _Request:
    """The part of pytest's `request` the suites use."""

    def __init__(self, finalizers: list):
        self._finalizers = finalizers

    def addfinalizer(self, fn) -> None:
        self._finalizers.append(fn)


@contextlib.contextmanager
def _fixtures(module, fn, kwargs: dict):
    """The case's arguments: its parameters, then `monkeypatch` (its own,
    undone after it), `request` and the module's own fixtures, each torn
    down after the case in reverse order."""
    finalizers, args = [], dict(kwargs)
    try:
        for name in inspect.signature(fn).parameters:
            if name in args:
                continue
            if name == "monkeypatch":
                args[name] = pytest.MonkeyPatch()
                finalizers.append(args[name].undo)
            elif name == "request":
                args[name] = _Request(finalizers)
            else:
                factory = getattr(module, name)._get_wrapped_function()
                value = factory()
                if inspect.isgenerator(value):
                    finalizers.append(lambda gen=value: next(gen, None))
                    value = next(value)
                args[name] = value
        yield args
    finally:
        for finalize in reversed(finalizers):
            finalize()


def _kept(real, sink: list, name: str = None):
    """`real`, each return of which is appended to `sink` (as `(name,
    _plain(value))` when named)."""

    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append((name, _plain(out)) if name else out)
        return out

    return call


def run_case(side: SuiteSide, name: str, cls_name, method: str, kwargs: dict) -> list:
    """The case on one package: its solves' records, then its recorded
    returns, then each environment's cluster."""
    module = side.modules[name]
    solves, values, envs = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        for holder in {id(h): h for h in side.holders.get(name, (module,))}.values():
            if hasattr(holder, "build_scheduler"):
                _recording(mp, holder, solves)
        for fn_name in side.values.get(name, ()):
            mp.setattr(module, fn_name, _kept(getattr(module, fn_name), values, fn_name))
        for env_module, env_name in side.envs.get(name, ()):
            mp.setattr(env_module, env_name, _kept(getattr(env_module, env_name), envs))
        fn = getattr(getattr(module, cls_name)(), method) if cls_name else getattr(module, method)
        with _fixtures(module, fn, kwargs) as args:
            fn(**args)
            after = [side.after[name](args)] if name in side.after else []
    return solves + values + [env_record(env) for env in envs] + after


def cases_of(name: str, reference, paths=("host",), fixture_path: bool = False, keep=lambda case_id: True) -> list:
    """catalog_cases of a reference module, ids prefixed by the module; a
    test that takes the `path` fixture once per path, with the path in its
    id, any other once."""
    out = []
    for i, path in enumerate(paths):
        for case in catalog_cases(name, fixture_path, path=path, reference=reference):
            _, cls_name, method, kwargs = case.values
            if ("path" not in kwargs and i) or not keep(case.id):
                continue
            suffix = f"-{path}" if "path" in kwargs else ""
            out.append(pytest.param(name, cls_name, method, kwargs, id=f"{name}::{case.id}{suffix}"))
    ids = [p.id for p in out]
    assert len(ids) == len(set(ids)), f"{name}: duplicate case ids"
    return out


# -- the suites -----------------------------------------------------------------------

NAMES = (
    "test_scheduler",
    "test_scheduler_affinity_extended",
    "test_scheduler_catalog",
    "test_scheduler_existing_nodes",
    "test_scheduler_topology_combined",
    "test_topology_depth",
    "test_state",
)

REFERENCE = {name: importlib.import_module(f"tests.{name}") for name in NAMES}
provisioning_suite = importlib.import_module("tests.test_provisioning")
PORT = {"test_scheduler": port_copy("test_scheduler", optional=SUITE_IMPORTS), "test_scheduler_catalog": CATALOG_PORT["test_scheduler_catalog"]}
# the copies the others import from, registered under their names here:
# pytest may import a test file twice (as tests.<file> and as <file>), and
# each import of tests/test_torch_scheduler_catalog.py registers a copy
for _module in PORT.values():
    sys.modules[_module.__name__] = _module
for _name in NAMES:
    if _name not in PORT:
        PORT[_name] = port_copy(_name, optional=SUITE_IMPORTS)


def state_record(args: dict) -> dict:
    """tests/test_state.py's `env` fixture after a case: each tracked node's
    allocatable, available and daemonset requests, and the pods tracked for
    required anti-affinity."""
    _kube, cluster = args["env"]
    nodes, anti = [], []
    cluster.for_each_node(lambda state: nodes.append(tuple(tuple(sorted(d.items())) for d in (state.allocatable, state.available, state.daemonset_requested))) or True)
    cluster.for_pods_with_anti_affinity(lambda pod, node: anti.append(pod.metadata.namespace) or True)
    return {"nodes": sorted(nodes), "anti_affinity_pods": len(anti)}


def _holders(modules: dict) -> dict:
    """The modules whose build_scheduler a suite's solves go through: its
    own, and the two suites whose `schedule` the others import."""
    shared = (modules["test_scheduler"], modules["test_scheduler_catalog"])
    return {name: (modules[name], *shared) for name in NAMES}


SIDES = {
    "ref": SuiteSide(REFERENCE, _holders(REFERENCE), envs={"test_scheduler_catalog": [(provisioning_suite, "env_with")]}, after={"test_state": state_record}),
    "port": SuiteSide(PORT, _holders(PORT), envs={"test_scheduler_catalog": [(PORT["test_scheduler_catalog"], "port_env_with")]}, after={"test_state": state_record}),
}

CASES = (
    cases_of("test_scheduler", REFERENCE["test_scheduler"])
    + cases_of("test_scheduler_affinity_extended", REFERENCE["test_scheduler_affinity_extended"])
    + cases_of("test_scheduler_catalog", REFERENCE["test_scheduler_catalog"], paths=("host",), fixture_path=True)
    + cases_of("test_scheduler_existing_nodes", REFERENCE["test_scheduler_existing_nodes"])
    + cases_of("test_scheduler_topology_combined", REFERENCE["test_scheduler_topology_combined"])
    + cases_of("test_topology_depth", REFERENCE["test_topology_depth"], paths=("host", "dense"))
    + cases_of("test_state", REFERENCE["test_state"])
)


@pytest.mark.parametrize("name,cls_name,method,kwargs", CASES)
def test_host_case_on_both_packages(name, cls_name, method, kwargs):
    ref = run_case(SIDES["ref"], name, cls_name, method, kwargs)
    port = run_case(SIDES["port"], name, cls_name, method, kwargs)
    assert port == ref
