"""The port's analysis tiers held against the JAX package's.

- The AST rules both packages share (lockcheck, swallow, clock, threads) on
  the very seeded sources of tests/test_analysis.py's TestLockcheck,
  TestSwallow, TestClockRule and TestThreadsRule (read from that file),
  written into a throwaway tree under each package's prefix: equal
  (rule, scope, key) findings.
- The baseline machinery (errors, tiered split, the --write-baseline round
  trip of the AST tier) and the CLI's flag conflicts, the same way.
- `staleness_errors` and `recompile_violations` on the same seeded contract
  documents on both sides (built by hand: the reference's tracer needs
  jax.experimental.enable_x64, which JAX 0.9.0 removed).
- The port's own: devicecheck from a registered entry and not from host
  orchestration; the copy and fallback rules; each program rule on a seeded
  drift through the traced audit; the gates on the repo, on a tampered
  contract and without a card; the registry against the JAX package's 13
  entries; the copy rule over the port and chip_smoke.py.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
PREFIX = {"ref": "karpenter_tpu", "port": "karpenter_tpu_torch"}
SHARED_RULES = {"lockcheck", "swallow", "clock", "threads"}
SEEDED_CLASSES = ("TestLockcheck", "TestSwallow", "TestClockRule", "TestThreadsRule")

# the JAX package's 13 registered entries and their port counterparts
REFERENCE_TO_PORT = {
    "resource_fit": "resource_fit",
    "feasibility_mask": "feasibility_mask",
    "availability_counts": "availability_counts",
    "bucket_type_cost": "bucket_type_cost",
    "bucket_type_cost_packed": "bucket_type_cost_packed",
    "segment_usage": "segment_usage",
    "audit_layout": "audit_layout",
    "warm_fill_counts": "warm_fill_counts",
    "warm_fill_counts_pallas": "warm_fill_counts_device",
    "rebase_view_state": "rebase_view_state",
    "bucket_type_cost_pallas": "bucket_cost_packed",
    "sharded_solve_step": "sharded_solve_step",
    "sharded_bucket_cost": "sharded_bucket_cost",
}
PORT_ONLY_ENTRIES = {"bucket_cost_keyed", "counts_resident"}


def _seeded_sources() -> list:
    """(case id, files) of every `_findings(tmp_path, {...})` call in the
    four shared-rule classes of tests/test_analysis.py."""
    tree = ast.parse((REPO_ROOT / "tests" / "test_analysis.py").read_text())
    out = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in SEEDED_CLASSES):
            continue
        for fn in cls.body:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_findings" and isinstance(node.args[1], ast.Dict):
                    out.append((f"{cls.name}.{fn.name}", ast.literal_eval(node.args[1])))
    return out


SEEDED = _seeded_sources()


def _analysis(side: str):
    if side == "ref":
        from karpenter_tpu.analysis import core
        from karpenter_tpu.cmd import analyze
    else:
        from karpenter_tpu_torch.analysis import core
        from karpenter_tpu_torch.cmd import analyze
    return core, analyze


def _tree(root: Path, side: str, files: dict) -> str:
    for rel, source in files.items():
        path = root / PREFIX[side] / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return str(root)


def _shared_keys(side: str, root: str) -> set:
    core, _ = _analysis(side)
    return {(f.rule, f.scope, f.key) for f in core.run_rules(core.parse_modules(root)) if f.rule in SHARED_RULES}


# -- the AST tier on both packages ---------------------------------------------


def test_every_seeded_class_was_read():
    assert {case.split(".")[0] for case, _ in SEEDED} == set(SEEDED_CLASSES)
    assert len(SEEDED) >= 9


@pytest.mark.parametrize("case,files", SEEDED, ids=[case for case, _ in SEEDED])
def test_shared_rules_give_equal_findings(case, files, tmp_path):
    ref = _shared_keys("ref", _tree(tmp_path / "ref", "ref", files))
    port = _shared_keys("port", _tree(tmp_path / "port", "port", files))
    assert port == ref


def test_baseline_machinery_is_the_same(tmp_path):
    def judge(side: str) -> dict:
        core, _ = _analysis(side)
        finding = core.Finding(rule="swallow", path=f"{PREFIX[side]}/mod.py", line=9, scope="loop", key="except#0", message="m")
        entry = {"rule": "swallow", "path": f"{PREFIX[side]}/mod.py", "scope": "loop", "key": "except#0"}
        out = {}
        for label, justification in (("vetted", "intentional"), ("todo", "TODO"), ("blank", "  ")):
            baseline = core.Baseline(suppressions=[{**entry, "justification": justification}])
            active, suppressed, stale = baseline.split([finding])
            out[label] = (len(active), len(suppressed), len(stale), bool(baseline.errors()))
        gone = core.Baseline(suppressions=[{**entry, "path": "gone.py", "justification": "paid"}])
        out["stale"] = tuple(len(x) for x in gone.split([finding]))
        typo = core.Baseline(suppressions=[{**entry, "rule": "swallowed", "justification": "typo"}])
        out["unknown_rule"] = any("unknown rule" in e for e in typo.errors())
        other_tier = core.Baseline(suppressions=[{**entry, "rule": "program-donation", "justification": "other tier"}])
        from importlib import import_module

        rules = import_module(f"{PREFIX[side]}.analysis.rules")
        out["tiers"] = (len(other_tier.split([], rules=rules.RULE_NAMES)[2]), len(other_tier.split([], rules=rules.CONTRACT_RULE_NAMES)[2]))
        return out

    assert judge("port") == judge("ref")


def test_write_baseline_round_trip_is_the_same(tmp_path):
    """The AST tier's --write-baseline on the same seeded tree: a vetted
    entry keeps its justification, a new finding is seeded TODO, the other
    tier's entry survives verbatim; and the gate's exit codes."""
    source = {"mod.py": "def loop():\n    try:\n        work()\n    except Exception:\n        pass\n\n\ndef other():\n    import time\n    time.sleep(1)\n"}

    def round_trip(side: str):
        core, analyze = _analysis(side)
        root = _tree(tmp_path / side, side, source)
        findings = sorted(core.run_rules(core.parse_modules(root)), key=lambda f: f.rule)
        clock = next(f for f in findings if f.rule == "clock")
        path = tmp_path / side / "baseline.json"
        path.write_text(json.dumps({"suppressions": [
            {"rule": clock.rule, "path": clock.path, "scope": clock.scope, "key": clock.key, "justification": "vetted"},
            {"rule": "program-donation", "path": "p", "scope": "s", "key": "k", "justification": "other tier"},
        ]}))
        assert analyze.write_baseline(root, str(path), include_contracts=False) == 0
        doc = json.loads(path.read_text())
        rc_todo = analyze.run_check(root, str(path), out=sys.stderr)
        for entry in doc["suppressions"]:
            entry["justification"] = entry["justification"] if entry["justification"] != "TODO" else "vetted now"
        path.write_text(json.dumps(doc))
        rc_vetted = analyze.run_check(root, str(path), out=sys.stderr)
        rows = [(e["rule"], e["path"].replace(PREFIX[side] + "/", ""), e["scope"], e["key"]) for e in doc["suppressions"]]
        return rows, rc_todo, rc_vetted

    assert round_trip("port") == round_trip("ref")


@pytest.mark.parametrize("argv", [["--write"], ["--check", "--write-baseline"], ["--check", "--contracts", "--write"], ["--bogus"]])
def test_flag_conflicts_are_refused_the_same(argv):
    assert _analysis("port")[1].main(argv) == _analysis("ref")[1].main(argv) == 2


def test_device_flag_needs_a_value():
    assert _analysis("port")[1].main(["--contracts", "--device"]) == 2


# -- the contract documents on both packages ---------------------------------


def _seeded_doc() -> dict:
    entry = {
        "module": "ops/fake.py", "varying_axes": ["pods"], "static_axes": ["resources", "zones"],
        "args": [{"name": "x", "axes": ["pods"], "dtype": "float32"}], "outputs": [{"shape": [4], "dtype": "float32"}],
    }
    return {
        "schema_version": 1,
        "grid": {"base": {"pods": 4}, "alt": {"pods": 8}},
        "entries": {"fake_entry": entry, "other_entry": {**entry, "varying_axes": ["zones"]}},
        "digest": "0123456789abcdef",
    }


def _contracts(side: str):
    from importlib import import_module

    return import_module(f"{PREFIX[side]}.analysis.contracts")


def _stale(side: str, committed, current) -> list:
    mod = _contracts(side)
    return [e.replace(mod.CONTRACTS_BASENAME, "<contract>") for e in mod.staleness_errors(committed, current)]


def test_staleness_errors_are_the_same():
    doc = _seeded_doc()
    tampered = json.loads(json.dumps(doc))
    tampered["entries"]["fake_entry"]["varying_axes"] = ["types"]
    dropped = json.loads(json.dumps(doc))
    del dropped["entries"]["other_entry"]
    redigested = {**doc, "digest": "f" * 16}
    for committed in (doc, tampered, dropped, redigested, None):
        assert _stale("port", committed, doc) == _stale("ref", committed, doc)
    assert _stale("port", doc, doc) == []
    assert any("fake_entry" in e and "varying_axes" in e for e in _stale("port", tampered, doc))


def test_recompile_violations_are_the_same():
    doc = _seeded_doc()

    def record(fns, attribution, first=(), signature=None):
        return {"id": 7, "recompile": bool(attribution), "recompile_attribution": attribution, "compiled_fns": fns,
                "first_compiles": list(first), "signature": signature or {"zones": 2}}

    records = [
        record({"fake_entry": 1}, ["zones"]),  # a declared-static axis
        record({"fake_entry": 1}, ["pods"]),  # declared varying
        record({"fake_entry": 1}, ["zones"], first=["fake_entry"]),  # a first build
        record({"fake_entry": 1}, ["cold-start"]),
        record({"other": 1}, ["zones"]),
        record({"mystery": 1}, ["zones"]),  # no contract
        record({}, []),
    ]
    for recs in ([r] for r in records):
        assert _contracts("port").recompile_violations(recs, doc) == _contracts("ref").recompile_violations(recs, doc)
    missing = [_contracts(side).recompile_violations([], None)[0].replace(_contracts(side).CONTRACTS_BASENAME, "<contract>") for side in ("port", "ref")]
    assert missing[0] == missing[1]
    assert len(_contracts("port").recompile_violations(records, doc)) == 2


def test_a_library_rebuild_on_a_shape_change_violates_the_committed_contract():
    contracts = _contracts("port")
    committed = contracts.load_committed(str(REPO_ROOT))
    assert set(committed["libraries"]) == {"bucket_cost", "warm_fill"}
    rebuild = {"id": 3, "recompile": True, "recompile_attribution": ["pods"], "compiled_fns": {"bucket_cost": 1}, "signature": {"pods": 90}}
    (violation,) = contracts.recompile_violations([rebuild], committed)
    assert "bucket_cost" in violation and "pods" in violation
    assert contracts.recompile_violations([{**rebuild, "first_compiles": ["bucket_cost"]}], committed) == []


def test_contract_dims_are_the_port_flight_recorders():
    from karpenter_tpu_torch.analysis.contracts import FLIGHT_DIMS
    from karpenter_tpu_torch.flight import _SIGNATURE_DIMS

    assert FLIGHT_DIMS == tuple(_SIGNATURE_DIMS)


# -- the port's own AST rules --------------------------------------------------


def _port_findings(tmp_path, files: dict) -> set:
    core, _ = _analysis("port")
    return {(f.rule, f.scope, f.key) for f in core.run_rules(core.parse_modules(_tree(tmp_path, "port", files)))}


def test_devicecheck_flags_a_registered_entry_and_not_host_orchestration(tmp_path):
    keys = _port_findings(tmp_path, {
        "ops/feasibility.py": """
            import time
            import numpy as np
            import torch

            def _helper(x):
                return x.sum().item()

            def resource_fit(requests, caps):
                time.perf_counter()
                torch.rand(3)
                torch.rand(3, generator=torch.Generator())
                return float(requests.sum()) + _helper(caps) + np.asarray(caps).sum()

            def unreachable(x):
                return x.tolist()
        """,
        "solver/dense.py": """
            def dispatch(out):
                return out.cpu().numpy().item()
        """,
    })
    device = {k for k in keys if k[0] == "devicecheck"}
    assert device == {
        ("devicecheck", "resource_fit", "wall-clock"),
        ("devicecheck", "resource_fit", "host-rng"),
        ("devicecheck", "resource_fit", "float"),
        ("devicecheck", "resource_fit", "np.asarray"),
        ("devicecheck", "_helper", "item"),
    }


def test_devicecheck_follows_methods_and_classes(tmp_path):
    keys = _port_findings(tmp_path, {
        "parallel/sharded.py": """
            class ShardedBucketCost:
                def __call__(self, x):
                    return self._combine(x)

                def _combine(self, x):
                    return x.cpu()

                def unrelated(self, x):
                    return x.item()

            def make_sharded_bucket_cost(mesh):
                return ShardedBucketCost()
        """,
    })
    assert {k for k in keys if k[0] == "devicecheck"} == {("devicecheck", "ShardedBucketCost._combine", "cpu")}


def test_copy_rule_flags_the_jax_package_and_jax(tmp_path):
    keys = _port_findings(tmp_path, {
        "mod.py": """
            import jax
            import jax.numpy as jnp
            from karpenter_tpu.solver import dense
            from karpenter_tpu_torch.solver import dense as ours
            from .solver import dense as relative

            def late():
                import karpenter_tpu.ops
        """,
    })
    assert {k for k in keys if k[0] == "copy"} == {
        ("copy", "<module>", "jax"),
        ("copy", "<module>", "jax.numpy"),
        ("copy", "<module>", "karpenter_tpu.solver"),
        ("copy", "late", "karpenter_tpu.ops"),
    }


def test_fallback_rule_flags_a_plain_version_or_the_cpu_around_a_launch(tmp_path):
    keys = _port_findings(tmp_path, {
        "solver/route.py": """
            def plain_after_launch(stats, caps, prices, allowed):
                try:
                    return bucket_cost_packed(stats, caps, prices, allowed)
                except RuntimeError:
                    return bucket_type_cost_packed(stats.cpu(), caps.cpu(), prices.cpu(), allowed.cpu())

            def cpu_after_launch(sizes, head):
                try:
                    return warm_fill_counts_device(sizes, head)
                except Exception:
                    return sizes.to("cpu")

            def raises(stats, caps, prices, allowed):
                try:
                    return bucket_cost_packed(stats, caps, prices, allowed)
                except RuntimeError as exc:
                    raise SolverFault(exc)
        """,
        "controllers/elsewhere.py": """
            def outside_scope(x):
                try:
                    return bucket_cost_packed(x)
                except Exception:
                    return bucket_type_cost_packed(x)
        """,
    })
    assert {k for k in keys if k[0] == "fallback"} == {
        ("fallback", "plain_after_launch", "bucket_cost_packed->bucket_type_cost_packed"),
        ("fallback", "plain_after_launch", "bucket_cost_packed->cpu"),
        ("fallback", "cpu_after_launch", "warm_fill_counts_device->to-cpu"),
    }


def test_copy_rule_finds_nothing_in_the_port_or_chip_smoke():
    from karpenter_tpu_torch.analysis.core import Module, parse_modules
    from karpenter_tpu_torch.analysis.rules import copycheck

    modules = parse_modules(str(REPO_ROOT))
    for script in ("chip_smoke.py", "chip_process_http.py", "chip_campaign.py", "chip_sweep.py"):
        source = (REPO_ROOT / script).read_text()
        modules.append(Module(path=script, abspath=str(REPO_ROOT / script), tree=ast.parse(source), source=source))
    assert copycheck.check_copy(modules) == []


# -- the program tier on seeded drifts -------------------------------------------


def _seeded_entries():
    from karpenter_tpu_torch.analysis.contracts import ArgSpec, EntrySpec
    from karpenter_tpu_torch.ops import _cuda_build

    def builds_every_call(x):
        for listener in list(_cuda_build.BUILD_LISTENERS):
            listener("seed_lib", 0.0)
        return x + 1

    def spec(name, fn, axes=("pods",), **kw):
        return EntrySpec(
            name=name, module="karpenter_tpu_torch/ops/fake.py", function=name,
            resolve=lambda dims, device, fn=fn: fn, args=(ArgSpec("x", axes, "float32"),), varying=("pods",), **kw,
        )

    baked = np.arange(64, dtype=np.float32)  # 256 bytes, made into a tensor inside the call
    return (
        spec("seed_widening", lambda x: x.double() + 1),
        spec("seed_undeclared_write", lambda x: x.add_(1)),
        spec("seed_unwritten", lambda x: x + 1, inplace=("x",)),
        spec("seed_host_constant", lambda x: x + torch.from_numpy(baked), axes=(64,)),
        spec("seed_rebuild", builds_every_call, library="seed_lib"),
        spec("seed_clean", lambda x: x * 2),
    )


SEEDED_DRIFTS = {
    ("program-promotion", "seed_widening", "_to_copy:float64"),
    ("program-donation", "seed_undeclared_write", "x"),
    ("program-donation", "seed_unwritten", "x:unwritten"),
    ("program-constant", "seed_host_constant", "const:float32[64]"),
    ("program-recompile", "seed_rebuild", "seed_lib:rebuilt"),
}


@pytest.fixture(scope="module")
def seeded_doc():
    from karpenter_tpu_torch.analysis import contracts

    return contracts.build_contracts(entries=_seeded_entries(), device="cpu")


def test_each_seeded_drift_yields_its_finding(seeded_doc):
    from karpenter_tpu_torch.analysis.rules.programcheck import findings_from_contracts

    findings = findings_from_contracts(seeded_doc)
    assert {(f.rule, f.scope, f.key) for f in findings} == SEEDED_DRIFTS
    assert seeded_doc["entries"]["seed_undeclared_write"]["inplace"] == {"declared": [], "written": ["x"]}
    assert seeded_doc["libraries"] == {"seed_lib": {"entries": ["seed_rebuild"], "varying_axes": [], "static_axes": seeded_doc["libraries"]["seed_lib"]["static_axes"]}}


def test_seeded_drifts_fail_the_gate_and_a_justified_baseline_passes_it(seeded_doc, tmp_path, monkeypatch, capsys):
    from karpenter_tpu_torch.analysis import contracts
    from karpenter_tpu_torch.analysis.rules.programcheck import findings_from_contracts
    from karpenter_tpu_torch.cmd import analyze

    monkeypatch.setattr(contracts, "build_contracts", lambda entries=None, device="cuda": seeded_doc)
    contracts_path = tmp_path / "solver_contracts.json"
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"suppressions": []}))
    # missing, then equal to the current (staleness green, the drifts red)
    assert analyze.run_contracts_check(str(tmp_path), str(baseline), str(contracts_path), out=sys.stdout, device="cpu") == 1
    assert "missing" in capsys.readouterr().out
    contracts_path.write_text(json.dumps(seeded_doc))
    assert analyze.run_contracts_check(str(tmp_path), str(baseline), str(contracts_path), out=sys.stdout, device="cpu") == 1
    out = capsys.readouterr().out
    for rule, _scope, key in SEEDED_DRIFTS:
        assert f"{rule}[{key}]" in out
    baseline.write_text(json.dumps({"suppressions": [
        {"rule": f.rule, "path": f.path, "scope": f.scope, "key": f.key, "justification": "seeded fixture"}
        for f in findings_from_contracts(seeded_doc)
    ]}))
    assert analyze.run_contracts_check(str(tmp_path), str(baseline), str(contracts_path), out=sys.stdout, device="cpu") == 0
    tampered = json.loads(json.dumps(seeded_doc))
    del tampered["entries"]["seed_clean"]
    contracts_path.write_text(json.dumps(tampered))
    assert analyze.run_contracts_check(str(tmp_path), str(baseline), str(contracts_path), out=sys.stdout, device="cpu") == 1
    out = capsys.readouterr().out
    assert "stale" in out and "seed_clean" in out


def test_the_audit_is_deterministic_and_reads_the_rebase_in_place():
    from karpenter_tpu_torch.analysis import contracts

    specs = [s for s in contracts.default_entries() if s.name in ("rebase_view_state", "sharded_bucket_cost")]
    first, again = (contracts.build_contracts(entries=specs, device="cpu") for _ in range(2))
    assert first == again
    assert first["entries"]["rebase_view_state"]["inplace"] == {"declared": ["out"], "written": ["out"]}


# -- the registry and the gates on the repo ------------------------------------


def test_every_reference_entry_has_its_port_counterpart_committed():
    from karpenter_tpu_torch.analysis import contracts

    reference = json.loads((REPO_ROOT / "SOLVER_CONTRACTS.json").read_text())
    assert set(reference["entries"]) == set(REFERENCE_TO_PORT)
    committed = contracts.load_committed(str(REPO_ROOT))
    assert set(committed["entries"]) == set(REFERENCE_TO_PORT.values()) | PORT_ONLY_ENTRIES
    assert {s.name for s in contracts.default_entries()} == set(committed["entries"])
    for name, entry in committed["entries"].items():
        assert entry["varying_axes"] and entry["args"] and entry["outputs"], name
        assert entry["rebuilds"] == 0, name
    kernels = {n: e["library"] for n, e in committed["entries"].items() if e["library"]}
    assert kernels["bucket_cost_packed"] == kernels["bucket_cost_keyed"] == "bucket_cost"
    assert kernels["warm_fill_counts_device"] == kernels["counts_resident"] == "warm_fill"


def _analyze(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.analyze", *args],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=timeout,
    )


def test_analyze_check_exits_zero_on_the_repo():
    proc = _analyze("--check")
    assert proc.returncode == 0, proc.stderr


def test_contracts_check_exits_zero_on_the_repo_on_the_cpu():
    proc = _analyze("--contracts", "--check", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr


def test_contracts_check_catches_a_tampered_contract(tmp_path):
    committed = json.loads((REPO_ROOT / "karpenter_tpu_torch" / "analysis" / "solver_contracts.json").read_text())
    committed["entries"]["resource_fit"]["promotions"] = ["matmul:float64"]
    path = tmp_path / "karpenter_tpu_torch" / "analysis" / "solver_contracts.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(committed))
    proc = _analyze("--contracts", "--check", "--device", "cpu", str(tmp_path))
    assert proc.returncode == 1
    assert "stale" in proc.stderr and "resource_fit" in proc.stderr
    assert all(line.startswith("analyze --contracts --check:") for line in proc.stderr.strip().splitlines())


def test_analyze_check_catches_a_seeded_violation(tmp_path):
    root = _tree(tmp_path, "port", {"ops/mod.py": "import jax\n"})
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"suppressions": []}))
    assert _analysis("port")[1].run_check(root, str(baseline), out=sys.stderr) == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("argv", [["--device", "cuda"], ["--contracts", "--check"]])
def test_the_card_is_refused_without_one(argv):
    proc = _analyze(*argv)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
