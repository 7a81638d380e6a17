"""The wire's one-protocol case under load, 30 times.

test_each_client_speaks_to_each_server[port-port] (tests/test_torch_kube_http.py)
raced its watch's initial LIST under xdist: the LIST could land after the
node's update, so the update's MODIFIED event never came. This runs the
file in a pytest run of its own under `-n 6`, with the port-to-port
case repeated 30 times beside the file's other cases
(tests/wire_repeat_plugin.py), and requires every repeat to pass.
"""

from __future__ import annotations

import os
import subprocess
import sys
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 600.0


def test_port_pair_passes_30_of_30_under_xdist_load(tmp_path):
    report = tmp_path / "report.xml"
    proc = subprocess.run(
        [
            sys.executable, "-m", "pytest", "tests/test_torch_kube_http.py", "-q", "-p", "no:cacheprovider",
            "-p", "no:randomly", "-p", "xdist", "-n", "6", "-p", "tests.wire_repeat_plugin", f"--junitxml={report}",
        ],
        cwd=REPO, capture_output=True, text=True, timeout=DEADLINE_S, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout[-4000:]
    cases = [c for c in ET.parse(report).getroot().iter("testcase") if "test_each_client_speaks_to_each_server" in c.get("name", "")]
    repeats = [c for c in cases if c.get("name").endswith("-port-port]")]
    assert len(repeats) == 30 and len(cases) == 30
    assert all(not list(c) for c in repeats), "a repeat failed, errored or skipped"
