"""Rule registry for the static-analysis framework (analysis/core.py).

Two tiers share one baseline:

- **AST tier** (ALL_RULES): callables `List[Module] -> List[Finding]` over
  parsed source — import-light, needs no torch. Adding a rule here is the
  ONLY registration step: the CLI, the baseline machinery, and the
  fixture-test harness all iterate ALL_RULES.
- **program tier** (programcheck / CONTRACT_RULE_NAMES): findings over the
  traced program contracts (analysis/contracts.py) — needs torch, runs
  behind `analyze --contracts`. Listed here by NAME ONLY so the shared
  baseline machinery can split suppressions by tier without importing
  torch.

The port's copy of karpenter_tpu/analysis/rules/__init__.py: devicecheck
takes jaxcheck's place, and copycheck's two rules are the port's own.
"""

from __future__ import annotations

from . import copycheck, devicecheck, hygiene, lockcheck
from .programcheck import CONTRACT_RULE_NAMES

ALL_RULES = (
    lockcheck.check,
    devicecheck.check,
    hygiene.check_swallow,
    hygiene.check_clock,
    hygiene.check_threads,
    copycheck.check_copy,
    copycheck.check_fallback,
)

RULE_NAMES = (
    lockcheck.RULE,
    devicecheck.RULE,
    hygiene.SWALLOW_RULE,
    hygiene.CLOCK_RULE,
    hygiene.THREADS_RULE,
    copycheck.COPY_RULE,
    copycheck.FALLBACK_RULE,
)

__all__ = ["ALL_RULES", "RULE_NAMES", "CONTRACT_RULE_NAMES", "lockcheck", "devicecheck", "hygiene", "copycheck"]
