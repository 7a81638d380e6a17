"""Concurrency & hot-path correctness analysis.

Two halves, one discipline:

- **static** (core.py + rules/): the AST framework behind
  `python -m karpenter_tpu.cmd.analyze --check` — guarded-attribute lock
  checking (`@guarded_by`), JIT hygiene for the solver hot path, and the
  swallow/clock/threads hygiene rules, gated against a vetted baseline of
  justified exceptions (baseline.json).
- **dynamic** (witness.py): the opt-in lock-order witness — acquisition-
  order graph, cycle (deadlock) detection, hold-time accounting — that the
  storm/crash/campaign chaos suites run enabled.

The guards module is imported by production code (the declarations live on
the classes); everything else is tooling and stays import-light.
"""

from .guards import guarded_by, requires_lock

__all__ = ["guarded_by", "requires_lock", "WITNESS", "LockWitness"]


def __getattr__(name):
    # lazy: witness pulls in the metrics registry, and metrics.py itself
    # imports the guards — a package-level witness import would cycle
    if name in ("WITNESS", "LockWitness"):
        from . import witness

        return getattr(witness, name)
    raise AttributeError(name)
