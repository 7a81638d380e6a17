"""chip_smoke.py's controller_process_http, run several times on one CUDA card.

    python3 chip_process_http.py [--busy 0,6,6]

Run from the repository root on a machine with a CUDA card. It builds both
kernels, then runs the phase once per entry of --busy: a fresh
`python -m karpenter_tpu_torch.cmd.controller --apiserver-url URL` process
against an APIServer in a process of its own, the headline batch of 10,000
pods on an empty cluster, SIGTERM once the last Node has settled. Each entry
is the number of busy-looping processes started beside that run, so the
child's threads contend for the host's cores as on a loaded machine; they
are stopped after the run. Each run prints the phase's own line (the
child's exit code, its shutdown time and its log above info level among
it), then one JSON object with the run's number, its busy processes, "ok"
or the check that failed, and its wall time. Then the card's name and power
limit. It exits 1 if a run failed, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import chip_smoke


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--busy", default="0,6,6", help="busy processes beside each run, comma-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_process_http: no CUDA device available", file=sys.stderr)
        return 2
    from karpenter_tpu_torch.ops import bucket_cost, warmfill

    chip_smoke.build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
    dev, card_name = torch.device("cuda"), chip_smoke.card()
    failed = 0
    for run, busy in enumerate(int(b) for b in args.busy.split(",")):
        hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(busy)]
        t0 = time.perf_counter()
        try:
            chip_smoke.controller_process_http(dev, card_name, pods_n=chip_smoke.HEADLINE_PODS)
            status = "ok"
        except chip_smoke.PhaseFailed as exc:
            status, failed = str(exc), failed + 1
        finally:
            for hog in hogs:
                hog.kill()
                hog.wait()
        print(json.dumps({"run": run, "busy": busy, "status": status, "wall_s": time.perf_counter() - t0}), flush=True)
    print(card_name)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
