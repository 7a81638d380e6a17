"""programcheck: findings over the traced program contracts.

The second analysis tier. Where the AST rules (devicecheck & co.) read the
port's *source*, these rules read what its device entries *do* when they
run — the contract dicts analysis/contracts.py records by running each
registered entry at the contract grid under a TorchDispatchMode that sees
every aten op — and emit `Finding`s through the exact same
justified-baseline machinery (one baseline.json, one (rule, path, scope,
key) shape). Scope is the entry's registered name, never a line number.

The port's copy of karpenter_tpu/analysis/rules/programcheck.py. The
reference's three rule classes keep their names, so baselines and tests
map one to one; each takes its torch meaning:

- **program-donation** — the in-place surface. Torch has no donation: an
  entry reuses a buffer by writing into it. Each argument tensor's
  `_version` (an ndarray argument: its bytes) says which inputs the entry
  wrote. A write the entry does not declare (`EntrySpec.inplace`) is a
  finding keyed by the argument (a caller's tensor changed under it); a
  declared in-place buffer the entry did not write is keyed
  `<arg>:unwritten` (the caller reads a stale buffer), the counterpart of
  the reference's rejected donation.
- **program-promotion** — a float64/int64 tensor (of at least one
  dimension: a 0-dim one is a scalar torch wrapped to match its operand)
  produced inside the entry by an op none of whose tensor inputs is
  64-bit: a widening the pinned f32/i32 inputs did not ask for, keyed
  `<op>:<dtype>`. Recording every
  op's dtype replaces the reference's re-trace under enable_x64; torch
  has no global x64 flag and no weak types, so there is no weak-type
  check. Torch's own index ops (argmin, an index cast to int64) produce
  int64 by definition; those the port needs are justified in the
  baseline.
- **program-constant** — a tensor of at least CONST_MIN_BYTES that an op
  of the entry reads and that is neither an argument (or a view of one's
  memory) nor made by an op of the same call: a tensor made from host data
  during the call, or captured from outside it, keyed
  `const:<dtype>[<shape>]`.
- **program-recompile** — the port's own: a kernel library (an
  `ops/_cuda_build.py` KernelLibrary) built more than once over the
  audit's calls of one entry. The kernels are shape-generic: no dimension
  may trigger a build after the library's first, keyed
  `<library>:rebuilt`.

Unlike the AST tier these rules need the traced contract (torch, and a
device), so they are NOT in ALL_RULES; `analyze --contracts` is their
entry point and tier-1 runs it on the CPU as a subprocess gate.
"""

from __future__ import annotations

from typing import List

from ..core import Finding

DONATION_RULE = "program-donation"
PROMOTION_RULE = "program-promotion"
CONSTANT_RULE = "program-constant"
RECOMPILE_RULE = "program-recompile"

CONTRACT_RULE_NAMES = (DONATION_RULE, PROMOTION_RULE, CONSTANT_RULE, RECOMPILE_RULE)

# a tensor read from outside the call above this is a per-call host payload
# worth a finding; scalars wrapped into 0-dim tensors stay below it
CONST_MIN_BYTES = 64


def findings_from_contracts(doc: dict) -> List[Finding]:
    """Contract dict (analysis/contracts.py build_contracts) -> Findings,
    sorted with the same key as the AST runner so output interleaves
    deterministically."""
    findings: List[Finding] = []
    for name, entry in sorted(doc.get("entries", {}).items()):
        path = entry.get("module", "")

        def add(rule: str, key: str, message: str) -> None:
            findings.append(Finding(rule=rule, path=path, line=1, scope=name, key=key, message=message))

        inplace = entry.get("inplace", {})
        declared, written = set(inplace.get("declared", ())), set(inplace.get("written", ()))
        for arg in sorted(written - declared):
            add(
                DONATION_RULE, arg,
                f"input {arg!r} is written in place but the entry does not declare it — the caller's "
                f"tensor changes under it; declare it in EntrySpec.inplace or write into a new tensor",
            )
        for arg in sorted(declared - written):
            add(
                DONATION_RULE, f"{arg}:unwritten",
                f"input {arg!r} is declared in place but the entry never wrote it — a caller that swaps "
                f"buffers reads a stale one",
            )
        for promo in entry.get("promotions", ()):
            add(
                PROMOTION_RULE, promo,
                f"{promo}: a 64-bit tensor produced from 32-bit inputs — pin the dtype (an explicit "
                f"dtype=, .to(torch.int32)) or baseline why the op needs it",
            )
        for const in entry.get("captured_consts", ()):
            if const.get("bytes", 0) < CONST_MIN_BYTES:
                continue
            shape = "x".join(str(d) for d in const.get("shape", ()))
            add(
                CONSTANT_RULE, f"const:{const.get('dtype')}[{shape}]",
                f"tensor {const.get('dtype')}[{shape}] ({const.get('bytes')} bytes) is read from outside the "
                f"call's arguments and ops — made from host data or captured; pass it as an argument or "
                f"baseline why the entry makes it",
            )
        if entry.get("rebuilds", 0):
            add(
                RECOMPILE_RULE, f"{entry.get('library')}:rebuilt",
                f"kernel library {entry.get('library')!r} was built {entry.get('rebuilds')} more time(s) "
                f"after its first over the contract grid — a shape must never trigger a build",
            )
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings
