"""One function of this tree's chip_smoke.py, run on the package of each
source tree named, in the order given (at min_batch 64): chip_smoke.py is
loaded by path into a process of its own in that tree's root, so the tree's
own karpenter_tpu_torch is the one imported, its kernels built from the
tree's sources. FUNCTION takes (dev, min_batch) or (dev, min_batch, card):
a `*_cases` function (window_cases, residency_cases) returns its runs with
no check applied, so a tree whose re-solves book a node beyond its room
reports it instead of failing; a phase (interruption_reclaim_wave, ...)
applies its checks, and a failed one is reported as its status. To compare
two commits on one card, unpack the other into a git-ignored directory
(`git archive`) and name the trees alternately, for example `old . . old`.

    python3 chip_cmp.py FUNCTION [TREE ...]     # default TREE: .

Each run's whole result goes to chiprun_out/<FUNCTION>_<i>.json, a brief
of it to stdout (numbers, strings and short lists; a longer list by its
length). Needs a CUDA card and the CUDA toolkit, as chip_smoke.py."""
import json, os, subprocess, sys, time

CODE = r'''
import importlib.util, inspect, json, sys, time, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_cmp", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from karpenter_tpu_torch import logsetup
from karpenter_tpu_torch.ops import bucket_cost, warmfill
cs.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
logsetup.set_level("error")
dev, card = torch.device("cuda"), cs.card()
fn = getattr(cs, sys.argv[2])
args = (dev, 64, card)[: len(inspect.signature(fn).parameters)]
t0 = time.perf_counter()
try:
    result, status = fn(*args), "ok"
except cs.PhaseFailed as exc:
    result, status = None, str(exc)
print(json.dumps({"cmp": True, "status": status, "wall_s": time.perf_counter() - t0, "card": card, "result": result}, default=str), flush=True)
'''


def brief(obj, depth: int = 4):
    """The numbers, strings and short lists of a result, to `depth` levels."""
    if isinstance(obj, dict):
        return {k: brief(v, depth - 1) for k, v in obj.items()} if depth > 0 else f"<{len(obj)} keys>"
    if isinstance(obj, list):
        if len(obj) <= 8 and depth > 0:
            return [brief(v, depth - 1) for v in obj]
        return f"<{len(obj)} items>"
    return obj


if len(sys.argv) < 2:
    sys.exit(__doc__)
function, trees = sys.argv[1], sys.argv[2:] or ["."]
root = os.getcwd()
here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
os.makedirs("chiprun_out", exist_ok=True)
failures = 0
for i, tree in enumerate(trees):
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CODE, here, function], cwd=os.path.join(root, tree), capture_output=True, text=True, timeout=900)
    out = next((json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"cmp"')), None)
    with open(f"chiprun_out/{function}_{i}.json", "w") as fh:
        json.dump({"tree": tree, "rc": proc.returncode, "out": out, "stderr": proc.stderr[-200000:]}, fh)
    print(f"== run {i} tree {tree} rc {proc.returncode} wall {time.time() - t0:.1f} s", flush=True)
    if out is not None:
        print(json.dumps(brief(out)), flush=True)
    if proc.returncode != 0 or out is None or out["status"] != "ok":
        failures += 1
        print(proc.stderr[-3000:], flush=True)
sys.exit(1 if failures else 0)
