"""runtime_round_faulted (chip_smoke.py) twice on one CUDA card, with the
interpreter's garbage-collection pauses logged.

    python3 chip_gc_pauses.py

Run from the repository root on a machine with a CUDA card. It builds both
kernels, runs runtime_round, then runtime_round_faulted twice, and prints
one JSON line per attempt: its status and seconds, the wall-clock window of
each faulted cell's batch writes, every collection over 50 ms (its start,
milliseconds and generation) and the last six flight records (time, pods,
buckets, rungs), times relative to the first write; then the card's name
and power limit. A batcher whose 1 s idle window closes on part of a batch
shows as a collection inside a write window and a split solve.
"""
import gc, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from karpenter_tpu_torch.ops import bucket_cost, warmfill

pauses, writes = [], []
state = {}
def on_gc(phase, info):
    if phase == "start":
        state["t"] = time.time()
    elif "t" in state:
        ms = (time.time() - state["t"]) * 1e3
        if ms > 50:
            pauses.append({"at": state["t"], "ms": ms, "gen": info["generation"], "collected": info.get("collected")})
gc.callbacks.append(on_gc)

faulted_runtime = cs.faulted_runtime
def traced_faulted_runtime(dev, tag, spool, extra=()):
    kube, catalog, rt, env, names, write = faulted_runtime(dev, tag, spool, extra)
    def timed_write():
        a = time.time()
        out = write()
        writes.append({"tag": tag, "start": a, "end": time.time()})
        return out
    return kube, catalog, rt, env, names, timed_write
cs.faulted_runtime = traced_faulted_runtime

cs.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
dev, card = torch.device("cuda"), cs.card()
line = cs.runtime_round(dev, card)
for attempt in range(2):
    t = time.perf_counter()
    try:
        cs.runtime_round_faulted(dev, card, line)
        status = "ok"
    except Exception as exc:
        status = f"{type(exc).__name__}: {exc}"[:1500]
    from karpenter_tpu_torch.flight import FLIGHT
    recs = [{"id": r.id, "t": r.timestamp, "pods": r.signature.get("pods"), "buckets": r.signature.get("buckets"), "rungs": r.rungs} for r in FLIGHT.records()[-6:]]
    print(json.dumps({"attempt": attempt, "status": status, "s": time.perf_counter() - t, "writes": writes[-6:], "gc_pauses": pauses[-40:], "records": recs}), flush=True)
    pauses.clear()
print(card)
