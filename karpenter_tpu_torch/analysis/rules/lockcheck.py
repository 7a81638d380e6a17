"""lockcheck: guarded-attribute access must happen under the declared lock.

For every class carrying `@guarded_by(lock, *attrs, aliases=...)`
(analysis/guards.py), walk each method body and flag:

- any read/write of a guarded attribute (`self.<attr>`) that is not
  lexically inside a `with self.<lock>:` (or declared alias) block;
- any call to a lock-required sibling method (`@requires_lock`, or the
  `*_locked` naming convention) made outside such a block — the callee's
  body is checked as if the lock were held, so the obligation moves to the
  call site.

`__init__` is exempt (the object is unpublished), and nested functions /
lambdas inherit the lock state of their definition point — conservative,
since a closure can escape the block, but closures that stash guarded state
for later are exactly what the rule should surface.

The port's copy of karpenter_tpu/analysis/rules/lockcheck.py; the
declarations it reads come from the port's analysis/guards.py.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ..core import Finding, Module, decorator_name, dotted_name, self_attribute

RULE = "lockcheck"


def _guard_decl(cls: ast.ClassDef):
    """(lock, attrs, aliases) from an @guarded_by decorator, or None."""
    for dec in cls.decorator_list:
        if not isinstance(dec, ast.Call) or decorator_name(dec) != "guarded_by":
            continue
        consts = [a.value for a in dec.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if not consts:
            return None
        aliases: Tuple[str, ...] = ()
        for kw in dec.keywords:
            if kw.arg == "aliases" and isinstance(kw.value, (ast.Tuple, ast.List)):
                aliases = tuple(
                    e.value for e in kw.value.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
        return consts[0], tuple(consts[1:]), aliases
    return None


def _requires_lock(fn) -> bool:
    if fn.name.endswith("_locked"):
        return True
    return any(decorator_name(dec) == "requires_lock" for dec in fn.decorator_list)


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, module: Module, cls_name: str, method: str, lock: str,
                 attrs: Set[str], aliases: Set[str], locked_methods: Set[str], held: bool):
        self.module = module
        self.scope = f"{cls_name}.{method}"
        self.lock = lock
        self.attrs = attrs
        self.lock_names = {lock} | aliases
        self.locked_methods = locked_methods
        self.depth = 1 if held else 0
        self.findings: List[Finding] = []

    # -- lock-state tracking ---------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        holds = any(self._is_lock_expr(item.context_expr) for item in node.items)
        if holds:
            self.depth += 1
        self.generic_visit(node)
        if holds:
            self.depth -= 1

    def _is_lock_expr(self, expr: ast.AST) -> bool:
        # `with self._lock:` or `with self._cond:` (alias); also tolerate
        # `self._lock()`-style acquire wrappers should one appear
        if isinstance(expr, ast.Call):
            expr = expr.func
        attr = self_attribute(expr)
        return attr is not None and attr in self.lock_names

    # -- access checks ----------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self_attribute(node)
        if attr in self.attrs and self.depth == 0:
            self.findings.append(
                Finding(
                    rule=RULE, path=self.module.path, line=node.lineno, scope=self.scope, key=attr,
                    message=f"access of guarded attribute self.{attr} outside `with self.{self.lock}`",
                )
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name.startswith("self.") and "." not in name[5:]:
            callee = name[5:]
            if callee in self.locked_methods and self.depth == 0:
                self.findings.append(
                    Finding(
                        rule=RULE, path=self.module.path, line=node.lineno, scope=self.scope, key=callee,
                        message=(
                            f"call to lock-required method self.{callee}() outside "
                            f"`with self.{self.lock}` (callee assumes the lock is held)"
                        ),
                    )
                )
        self.generic_visit(node)


def check(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for module in modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            decl = _guard_decl(node)
            if decl is None:
                continue
            lock, attrs, aliases = decl
            methods = [
                n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            locked_methods = {m.name for m in methods if _requires_lock(m)}
            for method in methods:
                if method.name == "__init__":
                    continue
                checker = _MethodChecker(
                    module, node.name, method.name, lock, set(attrs), set(aliases),
                    locked_methods, held=_requires_lock(method),
                )
                for stmt in method.body:
                    checker.visit(stmt)
                findings.extend(checker.findings)
    return findings
