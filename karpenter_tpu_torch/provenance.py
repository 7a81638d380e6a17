"""Artifact provenance: the who/when/what block every scored JSON carries.

The r2–r5 headline drift stayed unbisectable because the BENCH_*.json
artifacts of that range carried no identity: no commit, no timestamp, no
record of the config that produced them (docs/dense-pipeline.md). Every
emitted artifact — bench phases JSON, `--smoke` summaries, and the scenario
campaign's SCENARIO_*.json — now embeds one `provenance` block so a drifted
number can be walked back to the exact tree and configuration that produced
it without rerunning anything.

    {"git_sha": "4d0b82e...", "dirty": false,
     "timestamp": "2026-08-03T12:00:00+00:00",
     "config_hash": "9f2ab31c04d1e8aa"}

`config_hash` is a stable digest of the caller-supplied config dict
(canonical JSON, sorted keys), so two artifacts are comparable iff the
hashes match — the first question of any bisect.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
from datetime import datetime, timezone
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REQUIRED_KEYS = ("git_sha", "timestamp", "config_hash")


def git_sha(cwd: Optional[str] = None) -> str:
    """HEAD of the repo this module lives in; "unknown" outside a work tree
    (an installed wheel, a bare CI sandbox) — provenance must never be the
    reason an artifact fails to emit."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"


def _git_dirty(cwd: Optional[str] = None) -> Optional[bool]:
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd or REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return bool(out.stdout.strip())


def config_hash(config: dict) -> str:
    """Stable 16-hex digest of a config dict (canonical JSON; non-JSON
    values fall back to repr so a config carrying e.g. a class is still
    hashable deterministically)."""
    canonical = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(canonical.encode()).hexdigest()[:16]


def provenance_block(config: Optional[dict] = None) -> dict:
    block = {
        "git_sha": git_sha(),
        "timestamp": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "config_hash": config_hash(config or {}),
    }
    dirty = _git_dirty()
    if dirty is not None:
        block["dirty"] = dirty
    return block


def provenance_errors(block) -> list:
    """Schema check shared by the scenario validator and the bench smoke
    test: required keys present, sha/hash well-formed, timestamp ISO-8601."""
    errs = []
    if not isinstance(block, dict):
        return [f"provenance must be a dict, got {type(block).__name__}"]
    for key in REQUIRED_KEYS:
        if key not in block:
            errs.append(f"provenance missing key {key!r}")
    sha = block.get("git_sha")
    if sha is not None and sha != "unknown":
        if not isinstance(sha, str) or not all(c in "0123456789abcdef" for c in sha) or len(sha) < 7:
            errs.append(f"provenance git_sha {sha!r} is not a commit hash")
    ts = block.get("timestamp")
    if ts is not None:
        try:
            datetime.fromisoformat(str(ts))
        except ValueError:
            errs.append(f"provenance timestamp {ts!r} is not ISO-8601")
    digest = block.get("config_hash")
    if digest is not None and (not isinstance(digest, str) or len(digest) != 16):
        errs.append(f"provenance config_hash {digest!r} is not a 16-hex digest")
    return errs
