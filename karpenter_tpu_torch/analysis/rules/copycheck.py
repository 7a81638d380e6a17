"""copycheck: the port's own discipline, the copy rule and the no-fallback rule.

Two rules that keep karpenter_tpu_torch/ what it is, a package of its own
that runs on the card or raises:

- **copy** — any `import jax…` or `import karpenter_tpu…` (the JAX
  package, not karpenter_tpu_torch), plain or `from`, anywhere under
  karpenter_tpu_torch/. What the port needs of the JAX package's host
  layers it keeps as its own copy; only the tests import both packages.
- **fallback** — an exception handler in `ops/`, `solver/` or `parallel/`
  whose `try` body launches a kernel (a wrapper of K1 or K2, the
  admission surface, a library's launch call) and whose handler then calls
  a kernel's plain version or moves tensors to the CPU (`.cpu()`,
  `.to("cpu")`, `device="cpu"`). A failed launch is classified and
  raised; it is never answered on the host.

Both report through the same Finding shape and baseline as every other
rule.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..core import Finding, Module, ScopedVisitor, dotted_name

COPY_RULE = "copy"
FALLBACK_RULE = "fallback"

FALLBACK_PREFIXES = ("karpenter_tpu_torch/ops/", "karpenter_tpu_torch/solver/", "karpenter_tpu_torch/parallel/")

_FORBIDDEN_ROOTS = ("jax", "jaxlib", "karpenter_tpu")

# the kernels' launch surfaces (ops/bucket_cost.py, ops/warmfill.py,
# solver/warmfill.py) and their plain versions (ops/feasibility.py,
# ops/warmfill.py)
KERNEL_LAUNCHES = {
    "bucket_cost_packed", "bucket_cost_keyed", "warm_fill_counts_device",
    "counts_resident", "admission_counts", "warm_fill_launch", "bucket_cost_keyed_launch",
}
PLAIN_VERSIONS = {
    "bucket_type_cost", "bucket_type_cost_packed", "bucket_type_cost_keyed",
    "warm_fill_counts", "warm_fill_counts_np",
}


def _forbidden(module_name: Optional[str]) -> bool:
    root = (module_name or "").split(".", 1)[0]
    return root in _FORBIDDEN_ROOTS


class _CopyVisitor(ScopedVisitor):
    def __init__(self, module: Module):
        super().__init__()
        self.module = module
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, name: str) -> None:
        self.findings.append(
            Finding(
                rule=COPY_RULE, path=self.module.path, line=node.lineno, scope=self.scope, key=name,
                message=f"import of {name}: the port imports nothing of jax or the JAX package; copy what it needs",
            )
        )

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if _forbidden(alias.name):
                self._flag(node, alias.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level == 0 and _forbidden(node.module):
            self._flag(node, node.module)


def _leaf(call: ast.Call) -> str:
    """The called name's last part, also of a call on a call's result
    (`lib().warm_fill_launch(...)`)."""
    name = dotted_name(call.func)
    return name.rsplit(".", 1)[-1] if name else getattr(call.func, "attr", "")


def _launches(nodes) -> List[str]:
    found = set()
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and _leaf(node) in KERNEL_LAUNCHES:
                found.add(_leaf(node))
    return sorted(found)


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu" or (
        isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device" and bool(node.args) and _is_cpu(node.args[0])
    )


def _host_moves(handler: ast.ExceptHandler) -> List[str]:
    """What the handler does that answers on the host: plain versions
    called, tensors moved to the CPU."""
    found = set()
    for node in ast.walk(handler):
        if not isinstance(node, ast.Call):
            continue
        leaf = _leaf(node)
        if leaf in PLAIN_VERSIONS:
            found.add(leaf)
        elif leaf == "cpu" and isinstance(node.func, ast.Attribute):
            found.add("cpu")
        elif leaf == "to" and any(_is_cpu(a) for a in node.args):
            found.add("to-cpu")
        if any(kw.arg == "device" and _is_cpu(kw.value) for kw in node.keywords):
            found.add("device-cpu")
    return sorted(found)


class _FallbackVisitor(ScopedVisitor):
    def __init__(self, module: Module):
        super().__init__()
        self.module = module
        self.findings: List[Finding] = []

    def visit_Try(self, node: ast.Try) -> None:
        launches = _launches(node.body)
        if launches:
            for handler in node.handlers:
                for move in _host_moves(handler):
                    self.findings.append(
                        Finding(
                            rule=FALLBACK_RULE, path=self.module.path, line=handler.lineno, scope=self.scope,
                            key=f"{'+'.join(launches)}->{move}",
                            message=(
                                f"handler around {', '.join(launches)} answers on the host ({move}): a failed "
                                f"launch is classified and raised, never replaced by the plain version or the CPU"
                            ),
                        )
                    )
        self.generic_visit(node)


def check_copy(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        visitor = _CopyVisitor(module)
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings


def check_fallback(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        if not module.path.startswith(FALLBACK_PREFIXES):
            continue
        visitor = _FallbackVisitor(module)
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings
