"""Static-analysis core: file walking, findings, baseline, reporting.

The framework half of `python -m karpenter_tpu_torch.cmd.analyze`: rules
(analysis/rules/*) consume parsed modules and emit `Finding`s; the runner
diffs them against the vetted baseline (analysis/baseline.json) and renders
`path:line: rule[key]: message` output, mirroring the exit-code contract of
the existing `gen_docs --check` / `gen_manifests --check` CI gates.

The port's copy of karpenter_tpu/analysis/core.py: the scanned root is
karpenter_tpu_torch/.

Baseline entries match on (rule, path, scope, key) — never on line numbers,
so an unrelated edit above a vetted exception does not invalidate it. Every
entry must carry a non-empty justification, and an entry that no longer
matches any finding is itself an error: the baseline records debt, and paid
debt must be deleted, not accumulated.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

BASELINE_BASENAME = "baseline.json"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    scope: str  # "Class.method", "function", or "<module>"
    key: str  # stable detail (attribute/callee name) for baseline matching
    message: str

    def suppression_key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.key)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}[{self.key}]: {self.message}"


@dataclass
class Module:
    path: str  # repo-relative, forward slashes
    abspath: str
    tree: ast.AST
    source: str


@dataclass
class Baseline:
    suppressions: List[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(suppressions=list(doc.get("suppressions", [])))

    def errors(self) -> List[str]:
        """Malformed entries: the baseline only admits justified suppressions
        for rules that exist. The rule-name check matters because split()
        filters by tier — a typo'd or deleted rule name would otherwise be
        invisible to BOTH gates' staleness checks and suppress nothing,
        silently, forever."""
        from .rules import CONTRACT_RULE_NAMES, RULE_NAMES  # runtime: avoids the import cycle

        known_rules = set(RULE_NAMES) | set(CONTRACT_RULE_NAMES)
        out = []
        for i, entry in enumerate(self.suppressions):
            missing = [k for k in ("rule", "path", "scope", "key") if not entry.get(k)]
            if missing:
                out.append(f"baseline entry {i} missing field(s) {missing}: {entry}")
            if entry.get("rule") and entry.get("rule") not in known_rules:
                out.append(
                    f"baseline entry {i} names unknown rule {entry.get('rule')!r} "
                    f"(not in {sorted(known_rules)}) — typo, or the rule was deleted; delete the entry"
                )
            justification = str(entry.get("justification", "")).strip()
            if not justification or justification.lower() == "todo":
                # 'TODO' is the --write-baseline seed: committing it unvetted
                # must fail the gate, same as an empty justification
                out.append(
                    f"baseline entry {i} ({entry.get('rule')}:{entry.get('path')}:{entry.get('scope')}"
                    f"[{entry.get('key')}]) has no justification — every suppression must say why"
                )
        return out

    def split(self, findings: Sequence[Finding], rules: Optional[Sequence[str]] = None):
        """(active findings, suppressed findings, stale baseline entries).

        `rules` scopes the staleness check to one tier: the AST gate and the
        program-contracts gate share this one baseline file, and each must
        judge only its own suppressions stale (an entry for a rule the
        current run never evaluates is the other tier's business)."""
        suppressions = self.suppressions
        if rules is not None:
            wanted = set(rules)
            suppressions = [e for e in suppressions if e.get("rule") in wanted]
        index: Dict[Tuple[str, str, str, str], dict] = {
            (e.get("rule", ""), e.get("path", ""), e.get("scope", ""), e.get("key", "")): e
            for e in suppressions
        }
        matched = set()
        active, suppressed = [], []
        for finding in findings:
            entry = index.get(finding.suppression_key())
            if entry is not None:
                matched.add(finding.suppression_key())
                suppressed.append(finding)
            else:
                active.append(finding)
        stale = [entry for key, entry in index.items() if key not in matched]
        return active, suppressed, stale


def parse_modules(root: str, subdir: str = "karpenter_tpu_torch") -> List[Module]:
    """Parse every .py file under root/subdir into a Module. A file that
    does not parse is itself a finding-shaped error the caller surfaces, so
    we raise with the path attached rather than skipping silently."""
    modules: List[Module] = []
    base = os.path.join(root, subdir)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            abspath = os.path.join(dirpath, name)
            rel = os.path.relpath(abspath, root).replace(os.sep, "/")
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError as err:
                raise SyntaxError(f"{rel}: {err}") from err
            modules.append(Module(path=rel, abspath=abspath, tree=tree, source=source))
    return modules


def run_rules(modules: List[Module], rules=None) -> List[Finding]:
    if rules is None:
        from .rules import ALL_RULES

        rules = ALL_RULES
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), BASELINE_BASENAME)


# -- AST helpers shared by the rules ------------------------------------------


def self_attribute(node: ast.AST) -> Optional[str]:
    """'X' when node is `self.X`, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target, best effort ('' when dynamic)."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def decorator_name(node: ast.AST) -> str:
    """Name of a decorator, unwrapping calls: `@guarded_by(...)` -> 'guarded_by',
    `@functools.lru_cache(maxsize=1)` -> 'lru_cache'."""
    if isinstance(node, ast.Call):
        node = node.func
    name = dotted_name(node)
    return name.rsplit(".", 1)[-1] if name else ""


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor maintaining a Class.method / function scope string, the
    shared spine of the per-rule visitors (findings anchor to scopes, not
    lines, so baselines survive unrelated edits)."""

    def __init__(self):
        self._scopes: List[str] = []

    @property
    def scope(self) -> str:
        return ".".join(self._scopes) if self._scopes else "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scopes.append(node.name)
        self.generic_visit(node)
        self._scopes.pop()

    def _visit_function(self, node) -> None:
        self._scopes.append(node.name)
        self.generic_visit(node)
        self._scopes.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
