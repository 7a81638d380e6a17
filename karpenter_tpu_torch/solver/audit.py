"""Residency integrity auditor: divergence detection and auto-heal.

The port of karpenter_tpu/solver/audit.py. The incremental engine
(solver/incremental.py) keeps LONG-LIVED state: a host mirror of the
warm-view encoding plus a resident device buffer that survive across
provision passes. A missed DeltaJournal record, a splice bug or a corrupted
device buffer would compound into every later placement. On a cadence, the
auditor re-derives a bounded sample of the truth (re-encoding view rows
straight from cluster state, the same f64 expressions as the fresh path) and
compares it with everything the engine holds resident.

Four divergence kinds, each a distinct failure shape:

  row-drift       a resident host-mirror row disagrees with a fresh encode
                  of the same view and the world did NOT move under it —
                  the mirror itself was damaged;
  missed-delta    the world moved (the row's truth changed since the last
                  audit) but the DeltaJournal never named the node, so the
                  engine kept serving the stale row;
  device-corrupt  the resident device buffer's sampled rows disagree with
                  the host mirror's f32 projection (they are byte-equal by
                  construction: the upload writes f32(head0), every rebase
                  scatters f32 recomputes);
  cube-stale      the dense solver's cached availability cube no longer
                  matches the host availability array it was built from.

The missed-delta window starts where the previous audit's truth was
taken: at the epoch of the snapshot whose views it re-encoded, which the
engine holds as its resident checkpoint (`_Resident.epoch`). A record made
after that snapshot, while the round ran on, is in the next audit's window,
so truth that moved under it is never called a missed delta. Passes that
bypass the engine (views that are not the cluster's snapshot) are neither
audited nor counted toward the cadence.

Every INTERVAL-th pass is audited. The per-audit sample is a seeded
bounded draw of SAMPLE_ROWS rows, deterministic in (seed, audit index) and
seeded with an int (utils/seeds.split_seed); every SHADOW_EVERY-th audit
upgrades to a FULL shadow when the cluster fits SHADOW_BUDGET_BYTES. The
sampled device rows are read back with one gather (ops/rebase.gather_rows).

A divergence heals: the engine's residency is invalidated with reason
'audit', so the next pass is the byte-equal full re-encode, and the caller
discards the audited pass's encoding (and the cube cache on cube-stale).

The auditor is an object the caller creates and hands to the DenseSolver
(`auditor=`), not a process-wide singleton. Its audit interval is a
constructor argument (the Runtime passes --residency-audit-interval; left
unset, it is INTERVAL at construction). Like the engine, it lives in the
single-threaded provisioning loop; its counts are updated under a witnessed
`solver.audit` lock, as the reference's are. A readback that fails raises
out of the solve. Each auditor counts in plain attributes (`divergences`,
`audits`, `heals`) and in the registry's families, whose process-wide sums
the score helpers (`divergences_total`, `heals_total`,
`audit_passes_total`) read. A divergence fires a `residency-divergence`
incident capsule (capsule.py) when capsules are enabled. `routes(auditor)`
serves one auditor's `stats()` at /debug/residency.
"""

from __future__ import annotations

import hashlib
import json
import logging
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analysis.guards import guarded_by
from ..analysis.witness import WITNESS
from ..capsule import CAPSULE, TRIGGER_RESIDENCY
from ..ir.encode import encode_warm_views
from ..metrics import REGISTRY
from ..ops.rebase import gather_rows
from ..utils.seeds import split_seed

log = logging.getLogger("karpenter_tpu_torch.solver.audit")

KIND_ROW_DRIFT = "row-drift"
KIND_MISSED_DELTA = "missed-delta"
KIND_CUBE_STALE = "cube-stale"
KIND_DEVICE_CORRUPT = "device-corrupt"
DIVERGENCE_KINDS = (KIND_ROW_DRIFT, KIND_MISSED_DELTA, KIND_CUBE_STALE, KIND_DEVICE_CORRUPT)

# approximate bytes one shadow-encoded row costs (three [R] f64 arrays plus
# the identity lists) — the budget only needs the right order of magnitude
SHADOW_ROW_BYTES = 256

# the JAX package's defaults: audit every pass, 8 rows a sampled audit,
# every 8th audit a full shadow within 16 MiB
INTERVAL = 1
SAMPLE_ROWS = 8
SHADOW_EVERY = 8
SHADOW_BUDGET_BYTES = 16 * 2**20

# registered at import so gen_docs sees the families without a live auditor
RESIDENCY_DIVERGENCES = REGISTRY.counter(
    "karpenter_solver_residency_divergences_total",
    "Resident-state divergences the residency auditor detected, by kind:"
    " 'row-drift' (host mirror row damaged), 'missed-delta' (truth moved but"
    " the DeltaJournal never named the node), 'cube-stale' (cached"
    " availability cube disagrees with its host source), 'device-corrupt'"
    " (resident device buffer disagrees with the mirror's f32 projection).",
    ("kind",),
)
RESIDENCY_HEALS = REGISTRY.counter(
    "karpenter_solver_residency_heals_total",
    "Auto-heals the residency auditor issued: audits that found at least one"
    " divergence, invalidated the engine's resident state (reason 'audit'),"
    " and discarded the audited pass's encoding so the fresh full re-encode"
    " path owns the next placement.",
)
AUDIT_PASSES = REGISTRY.counter(
    "karpenter_solver_residency_audit_passes_total",
    "Residency audits executed (cadenced provision passes that re-encoded a"
    " seeded row sample — or a full shadow — from cluster truth and compared"
    " it against the engine's resident state).",
)


def divergences_total() -> int:
    """Sum of the divergence counter across kinds (score surface)."""
    return int(sum(RESIDENCY_DIVERGENCES.values().values()))


def heals_total() -> int:
    return int(RESIDENCY_HEALS.value())


def audit_passes_total() -> int:
    return int(AUDIT_PASSES.value())


def _row_digest(enc, i: int) -> str:
    """16-hex digest over every encoded field of row `i` — the unit of
    truth/mirror comparison. f64 bytes are hashed raw, so the digest is
    exact, not tolerance-based."""
    h = hashlib.sha256()
    h.update(b"1" if bool(enc.usable[i]) else b"0")
    h.update(np.ascontiguousarray(enc.avail_tol[i], dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(enc.requests0[i], dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(enc.head0[i], dtype=np.float64).tobytes())
    h.update(repr((enc.zone[i], enc.ct[i], enc.hostname[i], tuple(enc.taint_sig[i]))).encode("utf-8"))
    return h.hexdigest()[:16]


def _differing_fields(fresh, j: int, mirror, i: int) -> List[str]:
    """Which encoded fields disagree between fresh row j and mirror row i —
    divergence detail only, never on the clean path."""
    out = []
    if bool(fresh.usable[j]) != bool(mirror.usable[i]):
        out.append("usable")
    for name in ("avail_tol", "requests0", "head0"):
        if not np.array_equal(getattr(fresh, name)[j], getattr(mirror, name)[i]):
            out.append(name)
    for name in ("zone", "ct", "hostname"):
        if getattr(fresh, name)[j] != getattr(mirror, name)[i]:
            out.append(name)
    if tuple(fresh.taint_sig[j]) != tuple(mirror.taint_sig[i]):
        out.append("taint_sig")
    return out


@guarded_by(
    "_lock",
    "audits",
    "heals",
    "divergences",
    "_truth_digest",
    "_last_epoch",
    "last_divergence",
    "clean_streak",
)
class ResidencyAuditor:
    """Audits one engine's resident state. DenseSolver consults
    `maybe_audit` once per real provision pass, right after the engine
    advances and before the warm fill consumes the encoding, on passes
    that did not bypass it: the resident state, the caller's view snapshot
    and the journal checkpoint then all describe the snapshot's instant. `seed` seeds the sampled
    draw; every `shadow_every`-th audit is a full shadow."""

    def __init__(self, seed: int = 0, interval: Optional[int] = None, shadow_every: Optional[int] = None):
        self._lock = WITNESS.lock("solver.audit")
        self.seed = int(seed)
        self.interval = INTERVAL if interval is None else int(interval)
        self.shadow_every = SHADOW_EVERY if shadow_every is None else max(1, int(shadow_every))
        self.passes = 0
        self.audits = 0
        self.heals = 0
        self.divergences: Dict[str, int] = {}
        # last observed TRUTH digest per audited row: a divergent row whose
        # truth moved since its last audit without the journal naming the
        # node is a missed delta, not drift
        self._truth_digest: Dict[str, str] = {}
        # journal epoch of the snapshot the previous audit re-encoded (the
        # engine's resident checkpoint): the window `dirty_since` answers
        # the classifier over
        self._last_epoch = 0
        self.last_divergence: Optional[dict] = None
        # consecutive clean audits since the last divergence
        self.clean_streak = 0

    def sample(self, V: int, audit_index: int) -> List[int]:
        """The rows audit `audit_index` compares, of V: all of them for a
        full shadow or a cluster no larger than the sample, else a seeded
        draw of SAMPLE_ROWS."""
        shadow = audit_index % self.shadow_every == 0 and V * SHADOW_ROW_BYTES <= SHADOW_BUDGET_BYTES
        if shadow or V <= SAMPLE_ROWS:
            return list(range(V))
        rng = random.Random(split_seed(self.seed, f"audit-{audit_index}"))
        return sorted(rng.sample(range(V), SAMPLE_ROWS))

    def maybe_audit(self, engine, views: Sequence, cube_host=None, cube_dev=None) -> Optional[dict]:
        """Cadence gate + audit. Returns None when no audit ran or the audit
        was clean; on divergence returns a report dict (kinds, rows,
        cube_stale) AFTER healing the engine (invalidate reason 'audit') —
        the caller must then discard the pass's encoding and, on
        cube_stale, its cube cache."""
        res = engine._resident
        if res is None or not views:
            return None
        self.passes += 1
        if self.passes % self.interval != 0:
            return None
        # the mirror's row identity must match the caller's snapshot
        # exactly (advance() just committed against these views); anything
        # else means the engine is mid-transition — skip, never guess
        names = [v.node.name for v in views]
        if res.names != names:
            return None
        t0 = time.perf_counter()
        report = self._audit(engine, res, views, names, cube_host, cube_dev)
        if report is not None:
            with self._lock:
                audit_no = self.audits - 1
            log.warning(
                "residency divergence: kinds=%s rows=%s (audit #%d, %.1fms) — healing via full re-encode",
                report["kinds"], report["rows"], audit_no, (time.perf_counter() - t0) * 1000.0,
            )
        return report

    def _audit(self, engine, res, views: Sequence, names: List[str], cube_host, cube_dev) -> Optional[dict]:
        with self._lock:
            audit_index = self.audits
            last_epoch = self._last_epoch
            prior_digests = dict(self._truth_digest)
        idx = self.sample(len(views), audit_index)

        # truth: re-encode the sampled views with the exact fresh-path
        # expressions (encode_warm_views is row-independent, so sub-row j
        # is byte-identical to full-encode row idx[j])
        fresh = encode_warm_views([views[i] for i in idx])
        mirror = res.enc
        window = engine.journal.dirty_since(last_epoch)
        findings: List[dict] = []
        fresh_digests: Dict[str, str] = {}
        for j, i in enumerate(idx):
            name = names[i]
            truth_digest = _row_digest(fresh, j)
            fresh_digests[name] = truth_digest
            if truth_digest == _row_digest(mirror, i):
                continue
            prior = prior_digests.get(name)
            # the journal window since the previous audit is the engine's
            # only knowledge of motion: truth that moved OUTSIDE it is a
            # record the journal lost
            if prior is not None and prior != truth_digest and window is not None and name not in window:
                kind = KIND_MISSED_DELTA
            else:
                kind = KIND_ROW_DRIFT
            findings.append({"row": name, "kind": kind, "fields": _differing_fields(fresh, j, mirror, i)})

        # device residency: the sampled buffer rows must equal the mirror's
        # f32 projection byte for byte
        got = gather_rows(res.head_dev, torch.tensor(idx, dtype=torch.int64, device=res.head_dev.device)).cpu().numpy()
        want = mirror.head0[idx].astype(np.float32)
        device_rows: List[str] = []
        if not np.array_equal(got, want):
            bad = np.nonzero(~np.all(got == want, axis=1))[0]
            device_rows = [names[idx[int(b)]] for b in bad]

        # availability cube: dense's cached device cube against the host
        # array it was derived from (same reshape and cast the cache makes)
        cube_stale = False
        if cube_host is not None and cube_dev is not None:
            want_cube = np.ascontiguousarray(cube_host).reshape(cube_host.shape[0], -1).astype(np.float32)
            got_cube = cube_dev.cpu().numpy()
            cube_stale = got_cube.shape != want_cube.shape or not np.array_equal(got_cube, want_cube)

        kinds = [f["kind"] for f in findings] + [KIND_DEVICE_CORRUPT] * len(device_rows)
        if cube_stale:
            kinds.append(KIND_CUBE_STALE)
        row_names = sorted({f["row"] for f in findings} | set(device_rows))

        with self._lock:
            self.audits += 1
            AUDIT_PASSES.inc()
            self._truth_digest.update(fresh_digests)
            self._last_epoch = res.epoch
            if not kinds:
                self.clean_streak += 1
                return None
            self.clean_streak = 0
            for kind in kinds:
                self.divergences[kind] = self.divergences.get(kind, 0) + 1
                RESIDENCY_DIVERGENCES.inc(kind=kind)
            self.heals += 1
            RESIDENCY_HEALS.inc()
            self.last_divergence = {
                "audit": audit_index,
                "rows": row_names,
                "kinds": sorted(set(kinds)),
                "findings": findings + [{"row": n, "kind": KIND_DEVICE_CORRUPT, "fields": ["head_dev"]} for n in device_rows],
                "cube_stale": cube_stale,
                "journal_window": sorted(window) if window is not None else None,
                "shadow": len(idx) == len(views),
            }
            # capsule detail carries only transport-stable fields (kinds +
            # counts): row names embed process-relative instance counters
            if CAPSULE.enabled:
                CAPSULE.trigger(TRIGGER_RESIDENCY, kinds=sorted(set(kinds)), rows=len(row_names))
        engine.invalidate("audit")
        return {"kinds": sorted(set(kinds)), "rows": row_names, "cube_stale": cube_stale}

    # -- read surfaces -------------------------------------------------------

    def stats(self) -> dict:
        """The /debug/residency index document (an auditor that exists is
        enabled: the port has no switch on it)."""
        with self._lock:
            return {
                "enabled": True,
                "interval": self.interval,
                "sample_rows": SAMPLE_ROWS,
                "shadow_every": self.shadow_every,
                "shadow_budget_bytes": SHADOW_BUDGET_BYTES,
                "passes_seen": self.passes,
                "audits": self.audits,
                "divergences": dict(sorted(self.divergences.items())),
                "heals": self.heals,
                "clean_streak": self.clean_streak,
                "rows_tracked": len(self._truth_digest),
                "last_divergence": json.loads(json.dumps(self.last_divergence)),
            }

    def row_detail(self, name: str) -> Optional[dict]:
        """Per-row shadow state for ?row= queries; None when the row was
        never audited."""
        with self._lock:
            digest = self._truth_digest.get(name)
            if digest is None:
                return None
            return {"row": name, "truth_digest": digest, "audits": self.audits}


# -- HTTP route (ObservabilityServer extra routes) ----------------------------


def _json(status, payload) -> tuple:
    return status, "application/json; charset=utf-8", json.dumps(payload) + "\n"


def routes(auditor: ResidencyAuditor) -> dict:
    """The residency-auditor read surface of `auditor`, served from the
    metrics listener (cmd/controller.py wires the Runtime's behind
    --residency-audit-interval)."""

    def residency_route(query: dict) -> tuple:
        raw = (query.get("row") or [None])[0]
        if raw is None:
            return _json(200, auditor.stats())
        detail = auditor.row_detail(raw)
        if detail is None:
            return _json(404, {"error": f"row {raw!r} has never been audited", "status": 404})
        return _json(200, detail)

    return {"/debug/residency": residency_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/residency": "residency auditor: audit cadence/counters, divergences by kind, heal count, last divergence detail; ?row= per-row shadow digest",
    }
