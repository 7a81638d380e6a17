"""The reference's requirement, native-core, catalog and capacity suites held on the port.

Each reference module runs as written on both packages through the harness
of tests/test_torch_scheduler_host.py (`run_case`): once as the JAX
package's test module, once as its port copy. Every case's own assertions
run on both, and what the harness can see of a case is recorded on both
and must be equal:

- tests/test_requirements.py, tests/test_requirement_matrix.py
  (`scheduling/requirements.py`, `scheduling/requirement.py`) and
  tests/test_bootstrap_content.py (the launch templates' bootstrap
  payloads): their own assertions; they solve nothing;
- tests/test_native.py: the returns of `dedupe_sizes`, `pack_counts` and
  `assign_bins`, the C++ packing core built from the port's `native/csrc`;
- tests/test_node_catalog.py: the DeprovEnv's cluster after each case
  (per node its type, zone, capacity type and pods bound);
- tests/test_capacity_resilience.py (the classes other files do not hold:
  TestFallbackResolve is in tests/test_torch_trace_chains.py,
  TestDenseAvailabilityMask in tests/test_torch_scheduler_catalog.py) and
  tests/test_provider_catalog.py's in-process cases (its http cases are in
  tests/test_torch_cloud_api.py): the CrunchEnv's and IceEnv's clusters;
- tests/test_fill_certificates.py: each seed's certified solve and
  full-protocol solve on the port, both equal to the reference's certified
  solve of the same instance.

Two cases patch the package they test, so only their port copies run
(`PORT_ONLY`): no test patches the JAX package.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import _recording, port_copy
from tests.test_torch_scheduler_host import SUITE_IMPORTS, SuiteSide, cases_of, run_case, runtime_process_state  # noqa: F401

NAMES = (
    "test_requirements",
    "test_requirement_matrix",
    "test_native",
    "test_node_catalog",
    "test_bootstrap_content",
    "test_fill_certificates",
    "test_capacity_resilience",
    "test_provider_catalog",
)

# what a port copy changes beyond port_copy's own substitutions
EXTRA = {
    "test_native": (("from karpenter_tpu import native", "from karpenter_tpu_torch import native"),),
    "test_node_catalog": (("from tests.test_deprovisioning import DeprovEnv, owned_pod", "from karpenter_tpu_torch.testing import DeprovEnv, owned_pod"),),
}

REFERENCE = {name: importlib.import_module(f"tests.{name}") for name in NAMES}
DIFFERENTIAL = {"ref": importlib.import_module("tests.test_differential_campaign"), "port": port_copy("test_differential_campaign")}
PORT = {name: port_copy(name, extra=EXTRA.get(name, ()), optional=SUITE_IMPORTS) for name in NAMES}

# the module classes whose environments are recorded
ENVS = {"test_node_catalog": "DeprovEnv", "test_capacity_resilience": "CrunchEnv", "test_provider_catalog": "IceEnv"}
NATIVE_VALUES = ("dedupe_sizes", "pack_counts", "assign_bins")


def _side(modules: dict, differential) -> SuiteSide:
    return SuiteSide(
        modules,
        holders={name: (modules[name], differential) for name in NAMES},
        envs={name: [(modules[name], cls)] for name, cls in ENVS.items()},
        values={"test_native": NATIVE_VALUES},
    )


SIDES = {side: _side(modules, DIFFERENTIAL[side]) for side, modules in (("ref", REFERENCE), ("port", PORT))}

# cases whose reference run would patch the JAX package: the port copy
# runs alone, its own assertions on the port
PORT_ONLY = {
    # monkeypatches native.pack_assign / pack_dedicated to None to drive the
    # pure-Python packing path
    "test_native::test_fallback_when_disabled",
}

HELD_ELSEWHERE = ("TestFallbackResolve::", "TestDenseAvailabilityMask::")

CASES = (
    cases_of("test_requirements", REFERENCE["test_requirements"])
    + cases_of("test_requirement_matrix", REFERENCE["test_requirement_matrix"])
    + cases_of("test_native", REFERENCE["test_native"])
    + cases_of("test_node_catalog", REFERENCE["test_node_catalog"])
    + cases_of("test_bootstrap_content", REFERENCE["test_bootstrap_content"])
    + cases_of("test_capacity_resilience", REFERENCE["test_capacity_resilience"], keep=lambda case_id: not case_id.startswith(HELD_ELSEWHERE))
    + cases_of("test_provider_catalog", REFERENCE["test_provider_catalog"], keep=lambda case_id: "[http]" not in case_id)
)


@pytest.mark.parametrize("name,cls_name,method,kwargs", CASES)
def test_suite_case_on_both_packages(name, cls_name, method, kwargs, request):
    port = run_case(SIDES["port"], name, cls_name, method, kwargs)
    if request.node.callspec.id.startswith(tuple(PORT_ONLY)):
        return
    ref = run_case(SIDES["ref"], name, cls_name, method, kwargs)
    assert port == ref


@pytest.mark.parametrize("seed", range(12))
def test_fill_certificates_on_both_packages(seed):
    """tests/test_fill_certificates.py on the port as written: the certified
    fill and the full protocol place alike. Its full-protocol run patches
    ExistingNodeView, so on the reference only its certified solve of the
    same instance runs (the case's `run(disable_certs=False)`), through the
    reference's tests/test_differential_campaign.py."""
    port = run_case(SIDES["port"], "test_fill_certificates", None, "test_certified_fill_matches_full_protocol", {"seed": seed})
    dc, ref = DIFFERENTIAL["ref"], []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, dc, ref)
        rng = np.random.default_rng(4000 + seed)
        provider = dc.FakeCloudProvider(dc.instance_types(int(rng.integers(20, 120))))
        pods = dc._rename(dc._random_workload(rng, int(rng.integers(60, 160))), f"cert{seed}")
        dc._solve(pods, dc._random_states(rng), provider, dense=True)
    assert len(ref) == 1 and ref[0]["nodes"] > 0
    assert port == ref * 2
