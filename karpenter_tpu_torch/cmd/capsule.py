"""Offline incident-capsule inspector.

A capsule (capsule.py) freezes every telemetry ring at the moment a trigger
fired; this command reads the captured `CAPSULE_<trigger>_<seq>.json` back
into the story a human debugs from — what fired, what the burn rates and
breaker looked like, the pending-latency waterfall at capture time, and the
fault timeline leading up to the trigger:

    python -m karpenter_tpu_torch.cmd.capsule inspect CAPSULE_breaker-open_0001.json
    python -m karpenter_tpu_torch.cmd.capsule inspect CAPSULE_... --replay [--compress 60]

`--replay` feeds the capsule's embedded journal slice through
scenarios/replay.py `ReplayTrace` and prints the reconstructed arrival
schedule — the recorded load pattern that produced the incident, ready to
re-present to a live Runtime (the capture-to-reproduction loop).

The port's copy of karpenter_tpu/cmd/capsule.py.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..capsule import capsule_errors


def _fmt_seconds(value) -> str:
    return f"{value:.3f}s" if isinstance(value, (int, float)) else "-"


def _print_header(doc: dict) -> None:
    meta = doc["capsule"]
    print(f"capsule   {meta['id']}")
    print(f"trigger   {meta['trigger']}  fingerprint {meta['fingerprint']}  t={meta['t']}")
    if meta["detail"]:
        detail = "  ".join(f"{k}={v}" for k, v in sorted(meta["detail"].items()))
        print(f"detail    {detail}")


def _print_burn(doc: dict) -> None:
    burn = doc.get("burn_rate") or {}
    if not burn:
        return
    print("\nburn rate (violating fraction / error budget; >=1 burns the budget)")
    for slo in sorted(burn):
        windows = burn[slo]
        row = "  ".join(f"{w}={windows.get(w, 0.0):.3f}" for w in ("fast", "slow"))
        print(f"  {slo:<16} {row}")


def _print_fault_domain(doc: dict) -> None:
    fd = doc.get("fault_domain") or {}
    breaker = fd.get("breaker") or {}
    print(
        f"\nbreaker   state={breaker.get('state', '?')}  consecutive={breaker.get('consecutive_faults', '?')}"
        f"  opened_total={breaker.get('opened_total', '?')}  last_fault={breaker.get('last_fault_kind') or '-'}"
    )
    print(f"faults    total={fd.get('faults_total', '?')}  degraded_solves={fd.get('degraded_total', '?')}")


def _print_waterfall(doc: dict) -> None:
    waterfall = (doc.get("journal") or {}).get("waterfall") or {}
    if not waterfall:
        print("\nwaterfall  (no completed pods at capture time)")
        return
    print("\nwaterfall (creation->bind decomposition at capture time)")
    print(f"  {'segment':<12} {'count':>5} {'p50':>10} {'p95':>10} {'p99':>10}")
    for segment in ("queue_wait", "batch_wait", "solve", "launch", "node_ready", "bind"):
        row = waterfall.get(segment)
        if not row:
            continue
        print(
            f"  {segment:<12} {row.get('count', 0):>5}"
            f" {_fmt_seconds(row.get('p50')):>10} {_fmt_seconds(row.get('p95')):>10} {_fmt_seconds(row.get('p99')):>10}"
        )


def _print_fault_timeline(doc: dict, limit: int = 40) -> None:
    events = (doc.get("journal") or {}).get("events") or []
    interesting = [
        e for e in events
        if e.get("kind") in ("solver", "chaos") or e.get("event") in ("failed", "deleted", "terminated")
    ]
    print(f"\nfault timeline ({len(interesting)} events; newest last)")
    for event in interesting[-limit:]:
        attrs = event.get("attrs") or {}
        extra = "  " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items())) if attrs else ""
        print(f"  t={event['t']:>10.3f}  {event['kind']:<6} {event['entity']:<24} {event['event']}{extra}")


def _print_replay(doc: dict, compress: float) -> int:
    from ..scenarios.replay import JournalSchemaError, ReplayTrace

    events = (doc.get("journal") or {}).get("events") or []
    source = doc["capsule"]["id"]
    try:
        trace = ReplayTrace.from_events(events, compress=compress, source=source)
    except JournalSchemaError as exc:
        print(f"capsule journal slice failed replay validation: {exc}", file=sys.stderr)
        return 1
    print(f"\nreplay schedule (compress {compress:g}x, digest {trace.source_digest})")
    if not trace.arrivals:
        print("  no pod `created` events in the capsule's journal slice — nothing to replay")
        return 0
    print(f"  {len(trace.arrivals)} arrivals over {trace.total_seconds():.3f}s")
    for delay, name in trace.schedule()[:20]:
        print(f"  +{delay:>8.3f}s  {name}")
    if len(trace.arrivals) > 20:
        print(f"  ... {len(trace.arrivals) - 20} more")
    return 0


def inspect(path: str, replay: bool = False, compress: float = 1.0) -> int:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"cannot read capsule {path}: {exc}", file=sys.stderr)
        return 1
    errs = capsule_errors(doc)
    if errs:
        for err in errs:
            print(f"capsule schema: {err}", file=sys.stderr)
        return 1
    _print_header(doc)
    _print_burn(doc)
    _print_fault_domain(doc)
    _print_waterfall(doc)
    _print_fault_timeline(doc)
    if replay:
        return _print_replay(doc, compress)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="capsule", description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    cmd = sub.add_parser("inspect", help="print a capsule's waterfall, burn rates, and fault timeline")
    cmd.add_argument("path", help="path to a CAPSULE_*.json file")
    cmd.add_argument("--replay", action="store_true", help="rebuild the arrival schedule via ReplayTrace")
    cmd.add_argument("--compress", type=float, default=1.0, help="replay clock compression (default 1.0)")
    args = parser.parse_args(argv)
    return inspect(args.path, replay=args.replay, compress=args.compress)


if __name__ == "__main__":
    raise SystemExit(main())
