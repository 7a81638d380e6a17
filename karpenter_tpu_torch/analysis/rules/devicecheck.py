"""devicecheck: no host syncs on the paths the device entries run.

The port's counterpart of karpenter_tpu/analysis/rules/jaxcheck.py. A torch
program has no trace to keep clean: every op runs eagerly, and a stray host
read of a CUDA tensor stalls the host until the card has caught up. This
rule finds the silent ones at lint time, inside the functions reachable from
the port's device entries:

- `.item()` / `.tolist()` / `.cpu()` / `.numpy()` and
  `torch.cuda.synchronize` — explicit host syncs;
- `np.asarray` / `np.array` — a device fetch that reads as a conversion;
- builtin `float()` / `int()` / `bool()` on a non-constant value — the
  value may be a tensor, whose conversion waits for the card;
- wall-clock (`time.*`) calls and host RNG (`random.*`, `np.random.*`, and
  `torch.rand*` without an explicit `generator=`) — a device path draws
  from a seeded `torch.Generator` and keeps no host time.

Entries: torch has no jit decorator to scan, so the entry set is the
program-contract registry (analysis/contracts.py `default_entries()`):
each entry names its module and function. Reachability follows
`self.<name>` to the same class, plain names to nested, module-level and
then other scanned modules' functions, and a class name to its `__init__`
and `__call__`. Scope: `ops/` and `parallel/`. Host orchestration that
calls the device entries (solver/dense.py's dispatch, the peer fabric's
broadcasts) is out of scope, as in the JAX package; a sync the entry
itself makes by design (AdmissionSurface's one wait, the sharded
dispatch's pinned copies) is justified in the baseline.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, Module, dotted_name

RULE = "devicecheck"

SCOPE_PREFIXES = ("karpenter_tpu_torch/ops/", "karpenter_tpu_torch/parallel/")

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}
_NP_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_CONCRETIZERS = {"float", "int", "bool"}
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like", "multinomial", "bernoulli", "normal"}


def _entry_functions() -> Set[Tuple[str, str]]:
    """(module path, function qualname) of every registered device entry."""
    from ..contracts import default_entries  # runtime: the registry imports no torch

    return {(spec.module, spec.function) for spec in default_entries()}


class _Indexer(ast.NodeVisitor):
    """Every def in one module by qualname, and its classes."""

    def __init__(self, module: Module):
        self.module = module
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Set[str] = set()
        self._stack: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.classes.add(".".join(self._stack))
        self.generic_visit(node)
        self._stack.pop()

    def _visit_function(self, node) -> None:
        self._stack.append(node.name)
        self.functions[".".join(self._stack)] = node
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function


def _own_nodes(fn: ast.AST):
    """The nodes of a function's body, not descending into nested defs or
    classes (each is checked on its own when it is reachable)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _Graph:
    def __init__(self, indexers: List[_Indexer]):
        self.by_path = {ix.module.path: ix for ix in indexers}

    def _callable(self, path: str, qualname: str) -> List[Tuple[str, str]]:
        ix = self.by_path[path]
        if qualname in ix.functions:
            return [(path, qualname)]
        if qualname in ix.classes:
            return [(path, f"{qualname}.{m}") for m in ("__init__", "__call__") if f"{qualname}.{m}" in ix.functions]
        return []

    def references(self, path: str, qualname: str) -> Set[Tuple[str, str]]:
        fn = self.by_path[path].functions[qualname]
        parts = qualname.split(".")
        ix = self.by_path[path]
        # the enclosing class of a method: the longest prefix that is a class
        cls = next((".".join(parts[:i]) for i in range(len(parts) - 1, 0, -1) if ".".join(parts[:i]) in ix.classes), None)
        out: Set[Tuple[str, str]] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id in ("self", "cls"):
                if cls is not None:
                    out.update(self._callable(path, f"{cls}.{node.attr}"))
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                out.update(self._resolve_name(path, parts, node.id))
        out.discard((path, qualname))
        return out

    def _resolve_name(self, path: str, parts: List[str], name: str) -> List[Tuple[str, str]]:
        # nested defs of the enclosing scopes first, then the module, then
        # any other scanned module's top level (an import)
        for i in range(len(parts), 0, -1):
            found = self._callable(path, ".".join(parts[:i] + [name]))
            if found:
                return found
        found = self._callable(path, name)
        if found:
            return found
        for other in sorted(self.by_path):
            if other != path:
                found = self._callable(other, name)
                if found:
                    return found
        return []


class _HostSyncChecker:
    def __init__(self, module: Module, fn: ast.AST, scope: str):
        self.module = module
        self.fn = fn
        self.scope = scope
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, key: str, message: str) -> None:
        self.findings.append(
            Finding(rule=RULE, path=self.module.path, line=node.lineno, scope=self.scope, key=key, message=message)
        )

    def run(self) -> List[Finding]:
        for node in _own_nodes(self.fn):
            if isinstance(node, ast.Call):
                self._call(node)
        return self.findings

    def _call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        root = name.split(".", 1)[0]
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS and name not in _NP_SYNC:
            self._flag(node, node.func.attr, f".{node.func.attr}() forces a device->host sync on a device path")
        elif name in _SYNC_CALLS:
            self._flag(node, name, f"{name}() waits for the whole card on a device path")
        elif name in _NP_SYNC:
            self._flag(node, name, f"{name}() on a tensor is a hidden device->host transfer")
        elif name in _CONCRETIZERS and node.args and not isinstance(node.args[0], ast.Constant):
            self._flag(node, name, f"builtin {name}() of a tensor waits for the card on a device path")
        elif root == "time":
            self._flag(node, "wall-clock", f"{name}() on a device path: host time, not the card's")
        elif root == "random" or (".random." in f".{name}." and root in ("np", "numpy")):
            self._flag(node, "host-rng", f"{name}() is host RNG on a device path; draw from a seeded torch.Generator")
        elif root == "torch" and leaf in _TORCH_RNG and not any(kw.arg == "generator" for kw in node.keywords):
            self._flag(node, "host-rng", f"{name}() without generator= draws from the global RNG; pass a seeded torch.Generator")


def check(modules: List[Module], entries: Optional[Set[Tuple[str, str]]] = None) -> List[Finding]:
    scanned = [m for m in modules if m.path.startswith(SCOPE_PREFIXES)]
    indexers = []
    for module in scanned:
        ix = _Indexer(module)
        ix.visit(module.tree)
        indexers.append(ix)
    graph = _Graph(indexers)
    entries = _entry_functions() if entries is None else entries
    worklist = [(path, name) for path, name in sorted(entries) if path in graph.by_path and name in graph.by_path[path].functions]
    reachable: Set[Tuple[str, str]] = set()
    while worklist:
        key = worklist.pop()
        if key in reachable:
            continue
        reachable.add(key)
        worklist.extend(graph.references(*key) - reachable)
    findings: List[Finding] = []
    for path, qualname in sorted(reachable):
        ix = graph.by_path[path]
        findings.extend(_HostSyncChecker(ix.module, ix.functions[qualname], qualname).run())
    return findings
