"""chip_smoke.py's incremental_residency cases, run on the package of each
source tree named, in the order given (at min_batch 64): this tree's
residency_cases (the same mutations and the same counts) loaded by path
into a process of its own in that tree's root, so the tree's own
karpenter_tpu_torch is the one imported, its kernels built from the tree's
sources. No check is applied, so a tree whose engine serves stale rows
reports them instead of failing. To compare two commits on one card, unpack
the other into a git-ignored directory (`git archive`) and name the trees
alternately, for example `old . . old`.

    python3 chip_residency.py [TREE ...]     # default TREE: .

Each run's output goes to chiprun_out/residency_<i>.log, a summary of each
run to stdout: per bind_after_snapshot pass its kind, the rows it served
that differ from a fresh encode of its views, the divergences, the nodes
booked beyond their room and whether it placed as a fresh solver; per
ice_resolve_incremental round each solve's engine passes, route and pods
onto standing nodes, the nodes over their room, the auditor's counts and
whether the outcome equals the round with no engine. Needs a CUDA card and
the CUDA toolkit, as chip_smoke.py."""
import json, os, subprocess, sys, time

CODE = r'''
import importlib.util, json, sys, time, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_residency", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from karpenter_tpu_torch import logsetup
from karpenter_tpu_torch.ops import bucket_cost, warmfill
cs.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
logsetup.set_level("error")
dev, card = torch.device("cuda"), cs.card()
t0 = time.perf_counter()
cases = cs.residency_cases(dev, 64)


def bind_run(run):
    return [{k: p[k] for k in ("step", "planted", "pass", "reason", "dirty_rows", "stale_rows", "head_dev_equal", "divergences", "overbooked", "same_as_fresh", "on_existing", "wall_ms", "launches", "held")} for p in run["passes"]]


def ice_run(run):
    return {"calls": run["calls"], "over_capacity": run["rec"]["outcome"]["broken"]["over_capacity"], "auditor": run["auditor"], "engine_passes": run["engine_passes"], "wall_ms": run["rec"]["wall_ms"], "launches": run["rec"]["launches"], "held": run["held"]}


bind, ice = cases["bind_after_snapshot"], cases["ice_resolve_incremental"]
out = {
    "summary": True,
    "wall_s": time.perf_counter() - t0,
    "bind_after_snapshot": {k: bind_run(bind[k]) for k in ("kernels", "plain")},
    "bind_same_as_plain": [p["outcome"] for p in bind["kernels"]["passes"]] == [p["outcome"] for p in bind["plain"]["passes"]],
    "ice_resolve_incremental": {k: ice_run(ice[k]) for k in ("kernels", "plain", "unaudited", "no_engine")},
    "ice_refused_types": ice["refused_types"],
    "ice_same_as_no_engine": {k: ice[k]["rec"]["outcome"] == ice["no_engine"]["rec"]["outcome"] for k in ("kernels", "plain", "unaudited")},
    "bind_s": cases["bind_s"],
    "ice_s": cases["ice_s"],
}
print(json.dumps(out), flush=True)
print(card, flush=True)
'''
root = os.getcwd()
here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
os.makedirs("chiprun_out", exist_ok=True)
failures = 0
for i, tree in enumerate(sys.argv[1:] or ["."]):
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CODE, here], cwd=os.path.join(root, tree), capture_output=True, text=True, timeout=900)
    with open(f"chiprun_out/residency_{i}.log", "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200000:])
    print(f"== run {i} tree {tree} rc {proc.returncode} wall {time.time() - t0:.1f} s", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith('{"summary"'):
            print(line, flush=True)
        elif "H100" in line or "NVIDIA" in line:
            print(line, flush=True)
    if proc.returncode != 0:
        failures += 1
        print(proc.stderr[-3000:], flush=True)
sys.exit(1 if failures else 0)
