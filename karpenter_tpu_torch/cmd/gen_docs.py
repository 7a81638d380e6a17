"""Generate the metrics reference from the live metric registry.

The reference auto-generates its metrics documentation (Makefile:103
`docgen`); this is the analog: boot a throwaway Runtime against the fake
provider so every controller registers its families, then render the
registry as a markdown reference.

    python -m karpenter_tpu_torch.cmd.gen_docs > PATH
    python -m karpenter_tpu_torch.cmd.gen_docs --check PATH   # staleness gate

--check regenerates in memory and diffs against the file at PATH: exit 0
when current, exit 1 with the missing/extra family names when a metric was
added or changed without regenerating the doc.

The port's copy of karpenter_tpu/cmd/gen_docs.py. --check takes its path and
has no default: the repository's METRICS.md is the JAX package's render,
which the port neither checks nor writes.
"""

from __future__ import annotations

import sys


def collect_registry():
    from ..cloudprovider.fake import FakeCloudProvider, instance_types
    from ..kube.cluster import KubeCluster
    from ..metrics import REGISTRY
    from ..runtime import Runtime
    from ..utils.options import Options

    kube = KubeCluster()
    # no dense solver: the boot touches no device
    rt = Runtime(
        kube=kube,
        cloud_provider=FakeCloudProvider(instance_types(2)),
        options=Options(leader_elect=False, dense_solver_enabled=False),
    )
    try:
        # one synchronous pass registers the scrapers' families
        rt.reconcile_once()
    finally:
        rt.stop()
    # the interruption controller's families register on construction; the
    # fake provider has no notification queue, so build one against the
    # simulated cloud (the provider that actually feeds the subsystem)
    from ..cloudprovider.simulated.provider import SimulatedCloudProvider
    from ..controllers.interruption import InterruptionController
    from ..controllers.state.cluster import Cluster

    sim_kube = KubeCluster()
    provider = SimulatedCloudProvider(kube=sim_kube)
    InterruptionController(
        sim_kube, Cluster(sim_kube, provider), provisioner=None, queue=provider.notification_source()
    )
    # the HTTP transport's retry counter registers on client construction
    # (no connection is made until a call): the socket-transport runtime is
    # the deployment whose retries the family observes
    from ..cloudprovider.simulated.apiclient import CloudAPIClient

    CloudAPIClient("http://127.0.0.1:1")
    # the chaos orchestrator's family registers at module import (the
    # campaign harness is the only consumer, so the runtime never pulls it
    # in); the invariant monitor's families ride the Runtime import above
    from ..scenarios import chaos_orchestrator  # noqa: F401

    # the incremental solve engine's pass/invalidation families and the
    # residency auditor's also register at module import — the runtime
    # only pulls the modules in when --solver-incremental or
    # --residency-audit-interval is set, which the docgen boot above is not
    from ..solver import audit, incremental  # noqa: F401

    return REGISTRY


def render(registry) -> str:
    lines = [
        "# Metrics reference",
        "",
        "Generated by `python -m karpenter_tpu_torch.cmd.gen_docs` (the analog of the",
        "reference's `make docgen`, Makefile:103). All families are exported in",
        "Prometheus text format from the registry on the metrics port.",
        "",
        "| name | type | labels | help |",
        "|---|---|---|---|",
    ]
    for name, kind, label_names, help_text in registry.families():
        labels = ", ".join(label_names) or "—"
        lines.append(f"| `{name}` | {kind} | {labels} | {help_text} |")
    lines.append("")
    return "\n".join(lines)


def check(path: str) -> int:
    """Exit-code staleness check: 0 when `path` matches the registry-rendered
    document, 1 (with a line-level summary on stderr) when it does not."""
    import os

    expected = render(collect_registry())
    if not os.path.exists(path):
        print(f"gen_docs --check: {path} does not exist; regenerate it:", file=sys.stderr)
        print(f"  python -m karpenter_tpu_torch.cmd.gen_docs > {path}", file=sys.stderr)
        return 1
    with open(path, encoding="utf-8") as f:
        actual = f.read()
    if actual == expected:
        return 0
    expected_rows = {line for line in expected.splitlines() if line.startswith("| `")}
    actual_rows = {line for line in actual.splitlines() if line.startswith("| `")}
    for row in sorted(expected_rows - actual_rows):
        print(f"gen_docs --check: missing from {path}: {row}", file=sys.stderr)
    for row in sorted(actual_rows - expected_rows):
        print(f"gen_docs --check: stale in {path}: {row}", file=sys.stderr)
    if expected_rows == actual_rows:
        print(f"gen_docs --check: {path} differs outside the family table", file=sys.stderr)
    print(f"gen_docs --check: regenerate with: python -m karpenter_tpu_torch.cmd.gen_docs > {path}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--check":
        if len(argv) != 2:
            print("usage: python -m karpenter_tpu_torch.cmd.gen_docs --check PATH", file=sys.stderr)
            return 2
        return check(argv[1])
    sys.stdout.write(render(collect_registry()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
