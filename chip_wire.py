"""chip_smoke.py's two wire phases, runtime_round_http and
controller_process_http (the headline's 10,000 pods), of each source tree
named, each tree's own chip_smoke.py in a process of its own from that
tree's root, in the order given; then, with --delete, consolidation_delete
of the first tree (at min_batch 64). To compare two commits on one card,
unpack the other into a git-ignored directory (`git archive`) and name the
trees alternately, for example `. old . old`.

    python3 chip_wire.py [TREE ...] [--delete]     # default TREE: .

Each run's output goes to chiprun_out/wire_<i>.log, a summary of each phase
line to stdout. Needs a CUDA card and the CUDA toolkit, as chip_smoke.py."""
import json, os, subprocess, sys, time

CODE = r'''
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from karpenter_tpu_torch.ops import bucket_cost, warmfill
cs.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
dev, card = torch.device("cuda"), cs.card()
failed = 0
phases = [lambda: cs.consolidation_delete(dev, 64, card)] if sys.argv[1] == "delete" else [
    lambda: cs.runtime_round_http(dev, card), lambda: cs.controller_process_http(dev, card)]
for fn in phases:
    t0 = time.perf_counter()
    try:
        fn()
        status = "ok"
    except cs.PhaseFailed as exc:
        status = str(exc)
        failed += 1
    print(json.dumps({"summary": True, "status": status, "wall_s": time.perf_counter() - t0}), flush=True)
print(card, flush=True)
sys.exit(1 if failed else 0)
'''
root = os.getcwd()
os.makedirs("chiprun_out", exist_ok=True)
KEYS = ("pods_to_last_nomination_ms", "last_pod_delivered_to_cluster_ms", "first_round_start_ms", "get_pods_ms", "schedule_ms",
        "provisioner_pod_lists", "provisioner_rounds", "topology_requests", "watch_streams", "informer_store_sizes", "server_nodes",
        "node_store_wait_ms", "lists_by_thread_and_kind", "pod_lists_by_thread", "first_pod_to_last_node_ms", "boot_to_ready_ms", "batches",
        "nodes", "exit_code", "outcome_equal_to_in_memory", "kernel_launches", "log_problems", "at_s", "config", "pods", "passes_ms",
        "store_build_s", "wall_ms")
args = sys.argv[1:] or ["."]
if args == ["--delete"]:
    args = [".", "--delete"]
runs = [(tree, "wire") for tree in args if tree != "--delete"] + ([(args[0], "delete")] if "--delete" in args else [])
failures = 0
for i, (tree, what) in enumerate(runs):
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CODE, what], cwd=os.path.join(root, tree), capture_output=True, text=True, timeout=1500)
    with open(f"chiprun_out/wire_{i}.log", "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200000:])
    print(f"== run {i} tree {tree} {what} rc {proc.returncode} wall {time.time() - t0:.1f} s", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if "summary" in obj:
                print(json.dumps(obj), flush=True)
            elif "phase" in obj:
                print(json.dumps({"phase": obj["phase"], **{k: obj[k] for k in KEYS if k in obj}}), flush=True)
        elif "H100" in line or "NVIDIA" in line:
            print(line, flush=True)
    if proc.returncode != 0:
        failures += 1
        print(proc.stderr[-3000:], flush=True)
sys.exit(1 if failures else 0)
