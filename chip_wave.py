"""chip_smoke.py's spot reclaim wave phase, interruption_reclaim_wave, of
each source tree named, each tree's own chip_smoke.py in a process of its
own from that tree's root, in the order given (at min_batch 64). A tree
whose chip_smoke.py has no WaveBookings (one from before the interruption
controller's booking ledger) gets this tree's attached to each of its
waves, so every tree's bookings, replacements, post-drain launches and end
state $/hour are read by the same code. To compare two commits on one
card, unpack the other into a git-ignored directory (`git archive`) and
name the trees alternately, for example `old . . old`.

    python3 chip_wave.py [TREE ...]     # default TREE: .

Each run's output goes to chiprun_out/wave_<i>.log, a summary of each wave
to stdout. Needs a CUDA card and the CUDA toolkit, as chip_smoke.py."""
import json, os, subprocess, sys, time

CODE = r'''
import importlib.util, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from karpenter_tpu_torch.ops import bucket_cost, warmfill
cs.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
dev, card = torch.device("cuda"), cs.card()
waves = []
if not hasattr(cs, "WaveBookings"):
    spec = importlib.util.spec_from_file_location("chip_smoke_bookings", sys.argv[1])
    counting = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(counting)
    wave_env, wave_run, attached = cs.wave_env, cs.wave_run, []

    def booked_env(*args, **kwargs):
        env = wave_env(*args, **kwargs)
        attached.append(counting.WaveBookings(env))
        return env

    def booked_run(*args, **kwargs):
        run = wave_run(*args, **kwargs)
        bookings = attached.pop().summary()
        waves.append({**bookings, "post_drain_launches": len(run["post_drain_launches"]), "launches_total": bookings["replacements"] + len(run["post_drain_launches"]), "wave_ms": run["wave_ms"], "plain": kwargs.get("plain", False)})
        return run

    cs.wave_env, cs.wave_run = booked_env, booked_run
t0 = time.perf_counter()
try:
    line = cs.interruption_reclaim_wave(dev, 64, card)
    status = "ok"
except cs.PhaseFailed as exc:
    line, status = None, str(exc)
if line is not None and "bookings_runs" in line:
    for i, b in enumerate(line["bookings_runs"]):
        waves.append({**b, "wave_ms": ([None] + line["wave_ms_runs"])[i], "plain": False})
    waves.append({**line["split_run"]["bookings"], "wave_ms": line["split_run"]["wave_ms"], "split": True})
print(json.dumps({"summary": True, "status": status, "wall_s": time.perf_counter() - t0, "waves": waves}), flush=True)
print(card, flush=True)
sys.exit(0 if status == "ok" else 1)
'''
root = os.getcwd()
here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
os.makedirs("chiprun_out", exist_ok=True)
KEYS = ("config", "pods", "fleet_nodes", "victims", "wave_ms", "wave_ms_runs", "polls", "overbooked", "post_drain_launches",
        "launches_total_runs", "end_price_per_hour_runs", "kernel_launches", "converge_ms", "split_run", "at_s")
failures = 0
for i, tree in enumerate(sys.argv[1:] or ["."]):
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CODE, here], cwd=os.path.join(root, tree), capture_output=True, text=True, timeout=900)
    with open(f"chiprun_out/wave_{i}.log", "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200000:])
    print(f"== run {i} tree {tree} rc {proc.returncode} wall {time.time() - t0:.1f} s", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if "summary" in obj:
                print(json.dumps(obj), flush=True)
            elif obj.get("phase") == "interruption":
                print(json.dumps({"phase": obj["phase"], **{k: obj[k] for k in KEYS if k in obj}}), flush=True)
        elif "H100" in line or "NVIDIA" in line:
            print(line, flush=True)
    if proc.returncode != 0:
        failures += 1
        print(proc.stderr[-3000:], flush=True)
sys.exit(1 if failures else 0)
