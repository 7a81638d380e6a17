"""The port's scenario campaign (default_campaign()) on one CUDA card, run by run.

    python3 chip_campaign.py [--dense] [--scenarios a,b] [--out DIR]

Run from the repository root on a machine with a CUDA card. Each scenario of
karpenter_tpu_torch/scenarios/campaign.py:default_campaign() runs on both
cloud transports (the in-process CloudBackend and the HTTP cloud API pair)
through CampaignRunner(device="cuda"): a live Runtime with its own threads,
the workload stand-in around it, the scenario's primitives and fault plans.
With --dense every Runtime runs on the dense path (K1 and K2 carry every
batch); without it each scenario keeps its own choice (the device-chaos
scenarios and the soak run dense, the rest on the host loop).

It prints one JSON object per run: converged, the scores that must be zero
(lost pods, budget violations, leaked instances, double launches, informer
divergences, invariant violations, leaked threads and watches), pods bound
and desired, the solver and kube fault counts, the residency auditor's
divergences, heals and audits, the breaker's state, the
capsules, K1's and K2's launches in the run and its wall time. A run that
raises is reported with its error, and the campaign goes on. The lines
are also written to DIR/runs.jsonl, and the SCENARIO_*.json documents land
under DIR/<transport>/ (default chiprun_out/campaign). Then the card's name
and power limit. It exits 1 if a
run raised or did not converge, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from chip_smoke import card

ZERO_SCORES = (
    "lost_pods", "budget_violations", "leaked_instances", "double_launches", "informer_divergences",
    "invariant_violations", "leaked_threads", "leaked_watches",
)


def launches() -> dict:
    from karpenter_tpu_torch.ops import bucket_cost, warmfill

    return {"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": warmfill.LAUNCHES}


def run_one(scenario, transport: str, out: str) -> dict:
    from karpenter_tpu_torch.scenarios import CampaignRunner, scenario_doc_errors

    runner = CampaignRunner(out_dir=os.path.join(out, transport), transports=(transport,), device="cuda")
    before = launches()
    t0 = time.perf_counter()
    try:
        (doc,) = runner.run([scenario])
    except Exception as exc:  # noqa: BLE001 - reported in the run's line; the campaign goes on
        return {"scenario": scenario.name, "transport": transport, "error": f"{type(exc).__name__}: {exc}", "wall_s": time.perf_counter() - t0}
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = launches()
    (run,) = doc["runs"]
    scores = run["scores"]
    return {
        "scenario": scenario.name,
        "transport": transport,
        "converged": run["converged"],
        "doc_errors": scenario_doc_errors(doc),
        "zero_scores": {k: scores[k] for k in ZERO_SCORES},
        "pods": [scores["pods_bound"], scores["pods_desired"]],
        "solver_faults": {"injected": scores["solver_faults_injected"], "total": scores["solver_faults_total"], "degraded": scores["degraded_solves_total"]},
        "breaker_state": scores["breaker_state"],
        "residency": {"divergences": scores["residency_divergences"], "heals": scores["residency_heals"], "audit_passes": scores["audit_passes"]},
        "kube": {"injected": scores["kube_faults_injected"], "conflicts": scores["kube_conflicts_total"]},
        "capsule_triggers": sorted(scores["capsule_triggers"]),
        "restarts": scores["restarts"],
        "pending_p99_s": {k: v.get("p99") for k, v in scores["pending_latency_seconds"].items()},
        "kernel_launches": {k: after[k] - before[k] for k in after},
        "duration_s": run["duration_seconds"],
        "wall_s": wall_s,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chip_campaign")
    parser.add_argument("--dense", action="store_true", help="every scenario's Runtime on the dense path")
    parser.add_argument("--scenarios", default="", help="comma-separated subset of scenario names")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "campaign"), help="directory for the SCENARIO_*.json documents")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_campaign: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import logsetup
        from karpenter_tpu_torch.scenarios import TRANSPORTS, default_campaign
    except ImportError as exc:
        print(f"chip_campaign: the karpenter_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    scenarios = default_campaign()
    if args.dense:
        scenarios = [dataclasses.replace(s, dense_solver=True) for s in scenarios]
    if args.scenarios:
        wanted = set(args.scenarios.split(","))
        scenarios = [s for s in scenarios if s.name in wanted]
    card_name = card()
    failed = []
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "runs.jsonl"), "a", encoding="utf-8") as record:
        for scenario in scenarios:
            for transport in TRANSPORTS:
                line = {"card": card_name, "dense": args.dense, **run_one(scenario, transport, args.out)}
                logsetup.set_level("warning")  # each Runtime re-levels the log tree at info
                print(json.dumps(line), flush=True)
                record.write(json.dumps(line) + "\n")
                record.flush()
                if "error" in line or not line["converged"]:
                    failed.append(f"{scenario.name}/{transport}")
    print(json.dumps({"runs_failed": failed}), flush=True)
    print(card_name, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
