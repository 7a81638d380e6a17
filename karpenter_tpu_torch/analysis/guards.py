"""Lock-discipline declarations: the `@guarded_by` / `@requires_lock` seam.

Go-Karpenter gets its concurrency discipline checked for free (`go vet`,
the race detector, lint conventions like `mu` guarding the fields below it).
This module is the declaration half of the Python analog: shared-state
classes declare WHICH lock guards WHICH attributes, and the AST checker
(analysis/rules/lockcheck.py) verifies every method-body access happens
under `with self.<lock>`.

The decorators are deliberately inert at runtime — they attach metadata and
return the class/function unchanged, so declaring a contract costs nothing
on any hot path. The checker never imports the code; it reads the decorator
syntactically, which is what lets it run on a file with unimportable
dependencies (e.g. jax-free CI stages).

Conventions the checker understands:

- `@guarded_by("_lock", "_attr_a", "_attr_b", aliases=("_cond",))` on a
  class: `_attr_a`/`_attr_b` may only be read or written inside a
  `with self._lock:` block (or `with self._cond:` for declared aliases —
  a Condition constructed over the same lock).
- `@requires_lock` on a method: the CALLER must hold the class's declared
  lock; the method body is checked as if the lock were held, and every
  call site of the method outside a lock block is flagged instead.
- a method whose name ends in `_locked` is treated exactly like
  `@requires_lock` (the Go `fooLocked` convention).
- `__init__` is exempt: the object is not yet published to other threads.
"""

from __future__ import annotations

from typing import Tuple

GUARDED_ATTR = "__guarded_by__"
REQUIRES_LOCK_ATTR = "__requires_lock__"


def guarded_by(lock: str, *attrs: str, aliases: Tuple[str, ...] = ()):
    """Class decorator declaring that `attrs` are guarded by `self.<lock>`.

    `aliases` names attributes whose `with` block also proves the lock is
    held — e.g. a `threading.Condition` constructed over the same lock.
    """

    def decorate(cls):
        setattr(cls, GUARDED_ATTR, {"lock": lock, "attrs": tuple(attrs), "aliases": tuple(aliases)})
        return cls

    return decorate


def requires_lock(fn):
    """Marks a method whose caller must already hold the class's declared
    lock (the `fooLocked` convention, spelled as a decorator)."""
    setattr(fn, REQUIRES_LOCK_ATTR, True)
    return fn
