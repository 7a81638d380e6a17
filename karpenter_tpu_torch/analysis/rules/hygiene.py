"""Hygiene rules: swallowed exceptions, stray wall-clock calls, wild threads.

Three small rules that each encode an existing repo-wide discipline:

- **swallow** — a broad `except Exception:` / bare `except:` handler that
  neither re-raises nor leaves evidence (a logging call or a metrics
  counter increment) hides failures on self-healing controller loops; the
  fix is `log.<level>` + a counter, the baseline records the few handlers
  whose silence is the contract (e.g. typed-fallback returns).
- **clock** — direct `time.sleep` / `time.monotonic` outside
  `utils/clock.py` bypasses the Clock seam, so FakeClock suites cannot
  drive that code path deterministically.
- **threads** — `threading.Thread(...)` without BOTH `name=` and `daemon=`
  makes stack dumps unreadable and shutdown behavior accidental; every
  loop thread in the runtime is named and explicitly daemonized.

The port's copy of karpenter_tpu/analysis/rules/hygiene.py; the clock seam
it exempts is karpenter_tpu_torch/utils/clock.py.
"""

from __future__ import annotations

import ast
import hashlib
from typing import List, Set

from ..core import Finding, Module, ScopedVisitor, dotted_name

SWALLOW_RULE = "swallow"
CLOCK_RULE = "clock"
THREADS_RULE = "threads"

_CLOCK_EXEMPT = ("karpenter_tpu_torch/utils/clock.py",)
_LOG_LEVELS = {"exception", "warning", "error", "info", "debug", "critical", "log"}
_BROAD = {"Exception", "BaseException"}


# -- swallow -------------------------------------------------------------------


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    for t in types:
        name = dotted_name(t)
        if name.rsplit(".", 1)[-1] in _BROAD:
            return True
    return False


def _leaves_evidence(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-raises or records the failure somewhere a
    human or a metric scrape can see it."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            leaf = name.rsplit(".", 1)[-1]
            root = name.split(".", 1)[0]
            if leaf in _LOG_LEVELS and ("log" in root.lower() or "log" in name.lower()):
                return True
            if leaf == "inc":  # metrics counter
                return True
    return False


def _handler_key(handler: ast.ExceptHandler) -> str:
    """Content-derived key: a hash of the handler's (position-independent)
    AST dump. An ordinal key (except#0) would let a vetted suppression
    silently migrate to a NEW handler added earlier in the same scope; a
    content key pins the suppression to this handler's exact type+body —
    editing the handler invalidates it, which forces a re-vet (intended)."""
    return f"except:{hashlib.md5(ast.dump(handler).encode()).hexdigest()[:8]}"


class _SwallowVisitor(ScopedVisitor):
    def __init__(self, module: Module):
        super().__init__()
        self.module = module
        self.findings: List[Finding] = []

    def visit_Try(self, node: ast.Try) -> None:
        for handler in node.handlers:
            if _is_broad(handler) and not _leaves_evidence(handler):
                self.findings.append(
                    Finding(
                        rule=SWALLOW_RULE, path=self.module.path, line=handler.lineno,
                        scope=self.scope, key=_handler_key(handler),
                        message="broad except swallows the exception without logging or counting it",
                    )
                )
        self.generic_visit(node)


# -- clock ---------------------------------------------------------------------

_CLOCK_FNS = {"sleep", "monotonic", "monotonic_ns"}


class _ClockVisitor(ScopedVisitor):
    def __init__(self, module: Module, time_aliases: Set[str], from_imports: Set[str]):
        super().__init__()
        self.module = module
        self.time_aliases = time_aliases
        self.from_imports = from_imports
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        flagged = None
        if "." in name:
            root, leaf = name.split(".", 1)
            if root in self.time_aliases and leaf in _CLOCK_FNS:
                flagged = leaf
        elif name in self.from_imports:
            flagged = name
        if flagged is not None:
            self.findings.append(
                Finding(
                    rule=CLOCK_RULE, path=self.module.path, line=node.lineno, scope=self.scope,
                    key=flagged,
                    message=f"direct time.{flagged}() bypasses utils/clock.Clock (FakeClock cannot cover this path)",
                )
            )
        self.generic_visit(node)


def _time_imports(tree: ast.AST):
    aliases: Set[str] = set()
    from_imports: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    aliases.add(alias.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _CLOCK_FNS:
                    from_imports.add(alias.asname or alias.name)
    return aliases, from_imports


# -- threads -------------------------------------------------------------------


class _ThreadVisitor(ScopedVisitor):
    def __init__(self, module: Module, threading_aliases: Set[str]):
        super().__init__()
        self.module = module
        self.threading_aliases = threading_aliases
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        is_thread = name in {f"{alias}.Thread" for alias in self.threading_aliases} or name == "Thread"
        if is_thread:
            kwargs = {kw.arg for kw in node.keywords}
            for required in ("name", "daemon"):
                if required not in kwargs:
                    self.findings.append(
                        Finding(
                            rule=THREADS_RULE, path=self.module.path, line=node.lineno, scope=self.scope,
                            key=required,
                            message=f"threading.Thread(...) without {required}=: loop threads must be "
                                    f"named and explicitly daemonized",
                        )
                    )
        self.generic_visit(node)


def _threading_aliases(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "threading":
                    out.add(alias.asname or "threading")
    return out


# -- entry points --------------------------------------------------------------


def check_swallow(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        visitor = _SwallowVisitor(module)
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings


def check_clock(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        if module.path in _CLOCK_EXEMPT:
            continue
        aliases, from_imports = _time_imports(module.tree)
        if not aliases and not from_imports:
            continue
        visitor = _ClockVisitor(module, aliases, from_imports)
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings


def check_threads(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        aliases = _threading_aliases(module.tree)
        visitor = _ThreadVisitor(module, aliases or {"threading"})
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings
