"""Static-analysis gate: the AST tier (lockcheck + devicecheck + hygiene +
copycheck) and the program-contracts tier (the traced dtype / in-place /
host-constant / recompile-axis audit) over karpenter_tpu_torch/.

    python -m karpenter_tpu_torch.cmd.analyze                        # AST report
    python -m karpenter_tpu_torch.cmd.analyze --check [root]         # AST CI gate
    python -m karpenter_tpu_torch.cmd.analyze --contracts [root]     # contract report (on the card)
    python -m karpenter_tpu_torch.cmd.analyze --contracts --check --device cpu   # contract CI gate
    python -m karpenter_tpu_torch.cmd.analyze --contracts --write --device cpu   # regen solver_contracts.json
    python -m karpenter_tpu_torch.cmd.analyze --write-baseline [--contracts]

Both gates mirror the `gen_docs --check` / `gen_manifests --check` contract:
exit 0 when clean, exit 1 with one line per problem on stderr otherwise.
The AST tier runs on parsed source (no torch); the contracts tier runs the
registered device entries under a TorchDispatchMode (analysis/contracts.py)
and additionally gates STALENESS: the committed
karpenter_tpu_torch/analysis/solver_contracts.json must equal the recomputed
contract, exactly as gen_docs --check pins METRICS.md.

`--device` names where the contracts tier runs its entries: `cuda` (the
default) or `cpu`. Without a card, `cuda` raises: the port's no-fallback
rule, as every entry point. The committed contract is written from the CPU
(the kernels' plain versions); on a card the report adds what exists only
there, each entry's host->device bytes and builds.

The two tiers share one baseline (analysis/baseline.json, split by rule
name): `--write-baseline` seeds the AST tier; `--write-baseline
--contracts` seeds both, deduping and preserving existing justifications.
A baseline entry that no longer matches any finding of ITS OWN tier is an
error — paid debt must be deleted.

The port's copy of karpenter_tpu/cmd/analyze.py, with `--device` added.
"""

from __future__ import annotations

import json
import os
import sys


def _report_failures(active, stale, baseline, baseline_path, root, out, gate: str) -> int:
    failures = 0
    for error in baseline.errors():
        print(f"{gate}: {error}", file=out)
        failures += 1
    for finding in active:
        print(f"{gate}: {finding.render()}", file=out)
        failures += 1
    for entry in stale:
        print(
            f"{gate}: stale baseline entry {entry.get('rule')}:{entry.get('path')}:"
            f"{entry.get('scope')}[{entry.get('key')}] matches no finding — delete it",
            file=out,
        )
        failures += 1
    if failures:
        print(
            f"{gate}: {failures} problem(s) ({len(active)} finding(s), "
            f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'}); "
            f"fix them or add a justified suppression to {os.path.relpath(baseline_path, root)}",
            file=out,
        )
    return failures


def run_check(root: str, baseline_path: str = None, out=sys.stderr) -> int:
    from ..analysis.core import Baseline, default_baseline_path, parse_modules, run_rules
    from ..analysis.rules import RULE_NAMES

    baseline_path = baseline_path or default_baseline_path()
    modules = parse_modules(root)
    findings = run_rules(modules)
    baseline = Baseline.load(baseline_path)
    active, suppressed, stale = baseline.split(findings, rules=RULE_NAMES)
    return 1 if _report_failures(active, stale, baseline, baseline_path, root, out, "analyze --check") else 0


def run_report(root: str, baseline_path: str = None, out=sys.stdout) -> int:
    from ..analysis.core import Baseline, default_baseline_path, parse_modules, run_rules
    from ..analysis.rules import RULE_NAMES

    baseline_path = baseline_path or default_baseline_path()
    modules = parse_modules(root)
    findings = run_rules(modules)
    baseline = Baseline.load(baseline_path)
    active, suppressed, stale = baseline.split(findings, rules=RULE_NAMES)
    for finding in active:
        print(finding.render(), file=out)
    for finding in suppressed:
        print(f"{finding.render()} (baselined)", file=out)
    print(
        f"{len(active)} active finding(s), {len(suppressed)} baselined, "
        f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} over {len(modules)} file(s)",
        file=out,
    )
    return 0


# -- the program-contracts tier ------------------------------------------------


def run_contracts_check(root: str, baseline_path: str = None, contracts_path: str = None, out=sys.stderr, device="cuda") -> int:
    """The `--contracts --check` gate: staleness first (the committed
    solver_contracts.json must equal the contract recomputed on `device`),
    then violations vs the shared baseline."""
    from ..analysis import contracts
    from ..analysis.core import Baseline, default_baseline_path
    from ..analysis.rules.programcheck import CONTRACT_RULE_NAMES, findings_from_contracts

    gate = "analyze --contracts --check"
    baseline_path = baseline_path or default_baseline_path()
    committed = contracts.load_committed(root, contracts_path)
    current = contracts.build_contracts(device=device)
    failures = 0
    for error in contracts.staleness_errors(committed, current):
        print(f"{gate}: {error}", file=out)
        failures += 1
    findings = findings_from_contracts(current)
    baseline = Baseline.load(baseline_path)
    active, suppressed, stale = baseline.split(findings, rules=CONTRACT_RULE_NAMES)
    failures += _report_failures(active, stale, baseline, baseline_path, root, out, gate)
    return 1 if failures else 0


def run_contracts_report(root: str, baseline_path: str = None, contracts_path: str = None, out=sys.stdout, device="cuda") -> int:
    """The contract report: findings, staleness, and per entry what this run
    on `device` saw (dtypes, in-place writes, host->device bytes per call,
    builds)."""
    from ..analysis import contracts
    from ..analysis.core import Baseline, default_baseline_path
    from ..analysis.rules.programcheck import CONTRACT_RULE_NAMES, findings_from_contracts

    baseline_path = baseline_path or default_baseline_path()
    current, facts = contracts.audit(device=device)
    committed = contracts.load_committed(root, contracts_path)
    stale_msgs = contracts.staleness_errors(committed, current)
    findings = findings_from_contracts(current)
    baseline = Baseline.load(baseline_path)
    active, suppressed, stale = baseline.split(findings, rules=CONTRACT_RULE_NAMES)
    for finding in active:
        print(finding.render(), file=out)
    for finding in suppressed:
        print(f"{finding.render()} (baselined)", file=out)
    for msg in stale_msgs:
        print(msg, file=out)
    entries = current.get("entries", {})
    for name, entry in entries.items():
        fact = facts[name]
        print(
            f"{name}: in {[a['dtype'] for a in entry['args']]} out {[o['dtype'] for o in entry['outputs']]}, "
            f"in place {entry['inplace']['written']}, h2d bytes/call {fact['h2d_bytes']}, "
            f"host-arg bytes/call {fact['host_arg_bytes']}, builds {fact['builds']}, library {entry['library']}"
            + ("" if fact["bit_equal"] is None else f", bit-equal to its plain version: {fact['bit_equal']}"),
            file=out,
        )
    written = sum(len(e["inplace"]["written"]) for e in entries.values())
    const_bytes = sum(e["captured_const_bytes"] for e in entries.values())
    print(
        f"{len(entries)} device entr{'y' if len(entries) == 1 else 'ies'} audited on {device}: "
        f"{len(active)} active finding(s), {len(suppressed)} baselined, "
        f"{written} in-place input(s), {const_bytes} host-constant byte(s)",
        file=out,
    )
    return 0


def write_contracts(root: str, contracts_path: str = None, device="cuda") -> int:
    from ..analysis import contracts

    doc = contracts.write_contracts(root, contracts_path, device=device)
    path = contracts_path or contracts.default_contracts_path(root)
    print(f"wrote {len(doc['entries'])} entry contract(s) to {path}", file=sys.stderr)
    return 0


def write_baseline(root: str, baseline_path: str = None, include_contracts: bool = False, device="cuda") -> int:
    """Seed/refresh the shared baseline. AST findings always; contract-tier
    findings when include_contracts (the two tiers share one file, keyed by
    rule name). Existing justifications are preserved; suppressions of the
    OTHER tier are never dropped by a one-tier reseed."""
    from ..analysis.core import Baseline, default_baseline_path, parse_modules, run_rules
    from ..analysis.rules import CONTRACT_RULE_NAMES, RULE_NAMES

    baseline_path = baseline_path or default_baseline_path()
    modules = parse_modules(root)
    findings = list(run_rules(modules))
    reseeded_rules = set(RULE_NAMES)
    if include_contracts:
        from ..analysis import contracts
        from ..analysis.rules.programcheck import findings_from_contracts

        findings.extend(findings_from_contracts(contracts.build_contracts(device=device)))
        reseeded_rules |= set(CONTRACT_RULE_NAMES)
    existing = Baseline.load(baseline_path)
    justifications = {
        (e.get("rule"), e.get("path"), e.get("scope"), e.get("key")): e.get("justification", "")
        for e in existing.suppressions
    }
    entries = []
    seen = set()
    # suppressions of the tier(s) NOT being reseeded survive verbatim
    for e in existing.suppressions:
        if e.get("rule") not in reseeded_rules:
            key = (e.get("rule"), e.get("path"), e.get("scope"), e.get("key"))
            if key not in seen:
                seen.add(key)
                entries.append(dict(e))
    for finding in findings:
        key = finding.suppression_key()
        if key in seen:  # several findings can share one (scope, key) site
            continue
        seen.add(key)
        entries.append(
            {
                "rule": finding.rule,
                "path": finding.path,
                "scope": finding.scope,
                "key": finding.key,
                "justification": justifications.get(key, "TODO"),
            }
        )
    entries.sort(key=lambda e: (e["rule"], e["path"], e["scope"], e["key"]))
    doc = {
        "comment": (
            "Vetted exceptions for `python -m karpenter_tpu_torch.cmd.analyze --check` (AST tier) "
            "and `--contracts --check` (program tier). Entries match findings on "
            "(rule, path, scope, key) — line-independent. Every entry needs a real "
            "justification; --check rejects TODO."
        ),
        "suppressions": entries,
    }
    with open(baseline_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {len(entries)} suppression(s) to {baseline_path}", file=sys.stderr)
    return 0


def _device_flag(argv: list):
    """(argv without `--device X` / `--device=X`, the named device or None)."""
    rest, device = [], None
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, "")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return rest, device


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, named = _device_flag(argv)
    flags = {a for a in argv if a.startswith("--")}
    rest = [a for a in argv if not a.startswith("--")]
    unknown = flags - {"--check", "--write-baseline", "--contracts", "--write"}
    if unknown:
        print(f"analyze: unknown flag(s) {sorted(unknown)}", file=sys.stderr)
        return 2
    if named == "":
        print("analyze: --device needs a value (cuda or cpu)", file=sys.stderr)
        return 2
    if "--write" in flags and "--contracts" not in flags:
        print("analyze: --write requires --contracts (to reseed the baseline use --write-baseline)", file=sys.stderr)
        return 2
    if "--check" in flags and flags & {"--write", "--write-baseline"}:
        print("analyze: --check cannot be combined with --write/--write-baseline", file=sys.stderr)
        return 2
    root = rest[0] if rest else os.getcwd()
    device = named or "cuda"
    if named is not None or "--contracts" in flags:
        # the contracts tier runs on the card unless the CPU is named;
        # without a card this raises (no fallback), as an explicit --device does
        from ..device import resolve_device

        device = resolve_device(device)
    if "--write-baseline" in flags:
        return write_baseline(root, include_contracts="--contracts" in flags, device=device)
    if "--contracts" in flags:
        if "--write" in flags:
            return write_contracts(root, device=device)
        if "--check" in flags:
            return run_contracts_check(root, device=device)
        return run_contracts_report(root, device=device)
    if "--check" in flags:
        return run_check(root)
    return run_report(root)


if __name__ == "__main__":
    raise SystemExit(main())
