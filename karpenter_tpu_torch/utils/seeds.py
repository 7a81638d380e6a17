"""Deterministic seed fan-out: ONE master seed per scenario, every consumer derived.

The three fault seams (solver `FaultPlan`, kube `KubeFaultPlan`, and the
chaos orchestrator's schedule) plus the workload stand-in's jitter each take
a seed. Keeping them as independent knobs invites silent drift: a scenario
that pins `fault_seed` but forgets `kube_fault_seed` is only half
reproducible, and nobody can tell from the artifact. `split_seed` is the
splitmix64-style fan-out that makes one `Scenario.seed` the single
reproducibility handle: every derived seed is a pure function of
(master, label), recorded in provenance, so two runs of any scenario are
replayable from one number.

In this package the residency auditor (solver/audit.py) is its consumer: its
sampled draw is seeded with an int derived from (seed, audit index).

splitmix64 is the standard seed-expansion mixer (Steele et al., "Fast
splittable pseudorandom number generators"): one round of add-and-mix whose
outputs are statistically independent across labels even for adjacent
masters (0, 1, 2, ...) — exactly the property a campaign sweeping master
seeds needs.
"""

from __future__ import annotations

import hashlib

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    """One splitmix64 output round."""
    z = (x + _GOLDEN) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & _MASK


def split_seed(master: int, label: str) -> int:
    """Derive the seed for one named consumer from the master seed.

    Pure, stable across processes and platforms (the label hashes through
    sha256, never Python's randomized `hash()`), and clamped to a positive
    63-bit int so every RNG constructor accepts it."""
    label_key = int.from_bytes(hashlib.sha256(label.encode("utf-8")).digest()[:8], "big")
    return _mix((int(master) & _MASK) ^ label_key) & 0x7FFFFFFFFFFFFFFF
