"""Solver program contracts: the traced audit behind `analyze --contracts`.

The AST tier (rules/*.py) reads *source*; this second tier reads what the
port's device entries *do*. Every registered entry of the solver pipeline
is run at the two points of the contract grid on the device the caller
names, under a TorchDispatchMode that records every aten op, and the facts
that govern the steady-state solve are extracted into a committed
machine-readable contract, `karpenter_tpu_torch/analysis/solver_contracts.json`:

- **dtype surface** — every argument's and output's dtype and shape, and
  the 64-bit tensors an op produced from narrower inputs (promotions);
- **in-place surface** — which argument tensors the entry wrote, read from
  each tensor's `_version` (an ndarray argument: its bytes), against the
  writes the entry declares (the rebase's spare buffer);
- **host constants** — tensors an op of the entry read that are neither
  arguments (or views of their memory) nor made by an op of the same call;
- **recompile axes** — each entry's kernel library (ops/_cuda_build.py
  KernelLibrary) or none, and the builds of it over the grid after its
  first (a shape must never trigger one). The flight recorder's runtime
  build attribution is cross-checked against the libraries' declaration by
  `recompile_violations`, as the capsule engine's steady-recompile trigger
  does.

The committed contract is written from the CPU, where the kernel entries
run their plain versions, so `--contracts --check --device cpu` and its
staleness gate run without a card. On a card the same audit gives the same
device-independent facts: an entry with a kernel library is run there and,
on copies of the same inputs, on the CPU (its plain version), the outputs
held bit for bit and the promotions of both runs united — the launch makes
no aten op, and its plain version's dtype discipline is part of its
contract. What exists only on the card is reported, never committed:
host->device bytes per call and nvcc builds.

The port's copy of karpenter_tpu/analysis/contracts.py. The reference
abstractly interprets jaxprs with `jax.make_jaxpr`; torch programs run
eagerly, so the audit runs them on seeded inputs of the grid's shapes.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..flight import _SIGNATURE_DIMS

CONTRACTS_BASENAME = "solver_contracts.json"
SCHEMA_VERSION = 1

# the flight recorder's recompile-attribution vocabulary, imported (not
# duplicated) so contracts declare varying/static in exactly the terms the
# runtime cross-check compares
FLIGHT_DIMS = tuple(_SIGNATURE_DIMS)

# The shape grid the entries are audited over, the JAX package's: BASE
# mirrors the smoke configs' scaled shapes, ALT perturbs every
# runtime-varying dimension. "resources" is identical in both: it is the
# canonical declared-STATIC axis.
GRID_BASE: Dict[str, int] = {
    "pods": 304,
    "groups": 8,
    "buckets": 24,
    "types": 56,
    "zones": 3,
    "capacity_types": 2,
    "resources": 3,
    "segments": 41,
    "sizes": 16,
    "views": 48,
    "bins": 40,
    "offerings": 6,  # zones x capacity_types, flattened
    "buckets_padded": 24,
    "types_padded": 128,
    "sizes_padded": 16,
    "views_padded": 128,
    "dirty_padded": 8,
}
GRID_ALT: Dict[str, int] = {
    **GRID_BASE,
    "pods": 712,
    "groups": 12,
    "buckets": 40,
    "types": 104,
    "zones": 4,
    "capacity_types": 3,
    "segments": 57,
    "sizes": 24,
    "views": 160,
    "bins": 56,
    "offerings": 12,
    "buckets_padded": 40,
    "types_padded": 256,
    "sizes_padded": 24,
    "views_padded": 256,
    "dirty_padded": 16,
}


@dataclass(frozen=True)
class ArgSpec:
    """One array argument: named axes (grid dims or literal ints), dtype,
    how the audit fills it, and whether it is a host ndarray (the entry
    takes host arrays) or a tensor on the audit's device."""

    name: str
    axes: Tuple[object, ...]
    dtype: str  # numpy dtype name
    fill: str = ""  # "" (by dtype), binary, mixed, stats, sizes, ids:<dim>, bins:<dim>, perm:<dim>, unique:<dim>
    host: bool = False

    def shape(self, dims: Dict[str, int]) -> Tuple[int, ...]:
        return tuple(dims[a] if isinstance(a, str) else int(a) for a in self.axes)


@dataclass(frozen=True)
class EntrySpec:
    """One registered device entry: where it lives, how to build it for a
    device, its argument surface, its declared recompile axes, the
    arguments it writes in place, and its kernel library."""

    name: str
    module: str  # repo-relative path, forward slashes
    function: str  # qualname in `module`: the AST tier's entry (rules/devicecheck.py)
    resolve: Callable[[Dict[str, int], object], Callable]  # (dims, device) -> callable
    args: Tuple[ArgSpec, ...]
    varying: Tuple[str, ...]  # FLIGHT_DIMS declared runtime-varying
    static_args: Tuple[Tuple[str, object], ...] = ()  # trailing (name, grid-dim name or literal)
    inplace: Tuple[str, ...] = ()
    library: Optional[str] = None

    def static_values(self, dims: Dict[str, int]) -> Tuple[object, ...]:
        return tuple(dims[v] if isinstance(v, str) and v in dims else v for _, v in self.static_args)


def _audit_mesh(device):
    """One block on the audit's device: the contract facts are mesh-shape
    independent, and one block keeps the committed JSON the same on every
    host."""
    from ..parallel.mesh import solver_mesh

    return solver_mesh(1, types_parallel=1, devices=[device])


def _resolve_plain(module_name: str, attr: str):
    def resolve(dims: Dict[str, int], device):
        import importlib

        return getattr(importlib.import_module(module_name), attr)

    return resolve


def _resolve_counts_resident(dims: Dict[str, int], device):
    """AdmissionSurface.counts_resident's counts on a card; on the CPU, where
    the surface cannot exist, K2's plain version on the same rows."""
    import torch

    if torch.device(device).type == "cuda":
        from ..ops.warmfill import AdmissionSurface

        surface = AdmissionSurface(device)
        return lambda sizes, head, V: surface.counts_resident(sizes, head, V)[0].copy()
    from ..ops.warmfill import warm_fill_counts

    return lambda sizes, head, V: warm_fill_counts(torch.from_numpy(sizes), head[:V])


def _resolve_sharded_step(dims: Dict[str, int], device):
    from ..parallel.sharded import make_sharded_solve_step

    return make_sharded_solve_step(_audit_mesh(device), dims["bins"])


def _resolve_sharded_bucket_cost(dims: Dict[str, int], device):
    from ..parallel.sharded import make_sharded_bucket_cost

    return make_sharded_bucket_cost(_audit_mesh(device))


def default_entries() -> Tuple[EntrySpec, ...]:
    """The audited program surface: the port's counterpart of each of the
    JAX package's 13 entries, and K1's keyed mode and the resident K2 trip.
    Building the specs imports no torch (rules/devicecheck.py reads them)."""
    f32, i32, i64, b8 = "float32", "int32", "int64", "bool"
    ops, pkg = "karpenter_tpu_torch.ops.", "karpenter_tpu_torch/"
    stats = ArgSpec("bucket_stats", (2, "buckets", "resources"), f32, "stats")
    caps = ArgSpec("caps", ("types", "resources"), f32)
    prices = ArgSpec("prices", ("types",), f32)
    allowed = ArgSpec("allowed", ("buckets", "types"), b8)
    sizes = ArgSpec("sizes", ("sizes", "resources"), f32, "sizes")
    head = ArgSpec("head", ("views", "resources"), f32, "mixed")
    return (
        EntrySpec(
            name="resource_fit", module=pkg + "ops/feasibility.py", function="resource_fit",
            resolve=_resolve_plain(ops + "feasibility", "resource_fit"),
            args=(ArgSpec("requests", ("pods", "resources"), f32), caps),
            varying=("pods", "types"),
        ),
        EntrySpec(
            name="feasibility_mask", module=pkg + "ops/feasibility.py", function="feasibility_mask",
            resolve=_resolve_plain(ops + "feasibility", "feasibility_mask"),
            args=(
                ArgSpec("requests", ("pods", "resources"), f32), caps,
                ArgSpec("compat", ("groups", "types"), b8), ArgSpec("group_ids", ("pods",), i32, "ids:groups"),
            ),
            varying=("pods", "types", "groups"),
        ),
        EntrySpec(
            name="availability_counts", module=pkg + "ops/feasibility.py", function="availability_counts",
            resolve=_resolve_plain(ops + "feasibility", "availability_counts"),
            args=(ArgSpec("pair", ("buckets", "offerings"), f32, "binary"), ArgSpec("cube", ("types", "offerings"), f32, "binary")),
            varying=("buckets", "types", "zones", "capacity_types"),
        ),
        EntrySpec(
            name="bucket_type_cost", module=pkg + "ops/feasibility.py", function="bucket_type_cost",
            resolve=_resolve_plain(ops + "feasibility", "bucket_type_cost"),
            args=(
                ArgSpec("sum_requests", ("buckets", "resources"), f32), ArgSpec("max_requests", ("buckets", "resources"), f32),
                caps, prices, allowed,
            ),
            varying=("buckets", "types"),
        ),
        EntrySpec(
            name="bucket_type_cost_packed", module=pkg + "ops/feasibility.py", function="bucket_type_cost_packed",
            resolve=_resolve_plain(ops + "feasibility", "bucket_type_cost_packed"),
            args=(stats, caps, prices, allowed),
            varying=("buckets", "types"),
        ),
        EntrySpec(
            name="segment_usage", module=pkg + "ops/packing.py", function="segment_usage",
            resolve=_resolve_plain(ops + "packing", "segment_usage"),
            args=(ArgSpec("requests", ("pods", "resources"), f32), ArgSpec("bin_ids", ("pods",), i32, "bins:segments")),
            static_args=(("num_segments", "segments"),),
            varying=("pods", "buckets"),
        ),
        EntrySpec(
            name="audit_layout", module=pkg + "ops/packing.py", function="audit_layout",
            resolve=_resolve_plain(ops + "packing", "audit_layout"),
            args=(ArgSpec("usage", ("buckets", "resources"), f32), ArgSpec("caps_of_bin", ("buckets", "resources"), f32)),
            varying=("buckets",),
        ),
        EntrySpec(
            name="warm_fill_counts", module=pkg + "ops/warmfill.py", function="warm_fill_counts",
            resolve=_resolve_plain(ops + "warmfill", "warm_fill_counts"),
            args=(sizes, head),
            varying=("pods",),
        ),
        EntrySpec(
            name="warm_fill_counts_device", module=pkg + "ops/warmfill.py", function="warm_fill_counts_device",
            resolve=_resolve_plain(ops + "warmfill", "warm_fill_counts_device"),
            args=(sizes, head),
            varying=("pods",),
            library="warm_fill",
        ),
        EntrySpec(
            name="counts_resident", module=pkg + "ops/warmfill.py", function="AdmissionSurface.counts_resident",
            resolve=_resolve_counts_resident,
            args=(ArgSpec("sizes", ("sizes", "resources"), f32, "sizes", host=True), ArgSpec("head", ("views_padded", "resources"), f32, "mixed")),
            static_args=(("V", "views"),),
            varying=("pods",),
            library="warm_fill",
        ),
        EntrySpec(
            name="rebase_view_state", module=pkg + "ops/rebase.py", function="rebase_view_state",
            resolve=_resolve_plain(ops + "rebase", "rebase_view_state"),
            args=(
                ArgSpec("buf", ("views_padded", "resources"), f32, "mixed"),
                ArgSpec("perm", ("views_padded",), i64, "perm:views_padded"),
                ArgSpec("rows", ("dirty_padded", "resources"), f32, "mixed"),
                ArgSpec("idx", ("dirty_padded",), i64, "unique:views_padded"),
                ArgSpec("out", ("views_padded", "resources"), f32, "mixed"),
            ),
            varying=("pods",),
            inplace=("out",),
        ),
        EntrySpec(
            name="bucket_cost_packed", module=pkg + "ops/bucket_cost.py", function="bucket_cost_packed",
            resolve=_resolve_plain(ops + "bucket_cost", "bucket_cost_packed"),
            args=(stats, caps, prices, allowed),
            varying=("buckets", "types"),
            library="bucket_cost",
        ),
        EntrySpec(
            name="bucket_cost_keyed", module=pkg + "ops/bucket_cost.py", function="bucket_cost_keyed",
            resolve=_resolve_plain(ops + "bucket_cost", "bucket_cost_keyed"),
            args=(stats, caps, prices, allowed),
            varying=("buckets", "types"),
            library="bucket_cost",
        ),
        EntrySpec(
            name="sharded_solve_step", module=pkg + "parallel/sharded.py", function="make_sharded_solve_step",
            resolve=_resolve_sharded_step,
            args=tuple(
                ArgSpec(a.name, a.axes, a.dtype, a.fill, host=True)
                for a in (
                    ArgSpec("requests", ("pods", "resources"), f32),
                    ArgSpec("group_ids", ("pods",), i32, "ids:groups"),
                    ArgSpec("compat", ("groups", "types"), b8),
                    caps, prices, allowed,
                    ArgSpec("bucket_sum", ("buckets", "resources"), f32),
                    ArgSpec("bucket_max", ("buckets", "resources"), f32),
                    ArgSpec("bin_ids", ("pods",), i32, "bins:bins"),
                )
            ),
            varying=("pods", "groups", "buckets", "types", "buckets_padded", "types_padded"),
            library="bucket_cost",
        ),
        EntrySpec(
            name="sharded_bucket_cost", module=pkg + "parallel/sharded.py", function="make_sharded_bucket_cost",
            resolve=_resolve_sharded_bucket_cost,
            args=tuple(ArgSpec(a.name, a.axes, a.dtype, a.fill, host=True) for a in (stats, caps, prices, allowed)),
            varying=("buckets", "types", "buckets_padded", "types_padded"),
            library="bucket_cost",
        ),
    )


# -- the traced audit ------------------------------------------------------------


def _dtype_name(dtype) -> str:
    import numpy as np

    text = str(dtype)
    return text[len("torch."):] if text.startswith("torch.") else np.dtype(dtype).name


def _make_args(spec: EntrySpec, dims: Dict[str, int], device, seed: int) -> list:
    """Seeded inputs of the grid point's shapes: host ndarrays or tensors
    on `device`, the same values on every device for one seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for arg in spec.args:
        shape = arg.shape(dims)
        kind, _, dim = arg.fill.partition(":")
        if arg.dtype == "bool":
            value = rng.random(shape) < 0.7
        elif kind == "binary":
            value = rng.integers(0, 2, shape)
        elif kind == "mixed":
            value = rng.uniform(-0.5, 16.0, shape)
        elif kind == "stats":
            peak = rng.uniform(0.05, 2.0, shape[1:])
            value = np.stack([peak * rng.uniform(1.0, 6.0, shape[1:]), peak])
        elif kind == "sizes":
            value = rng.uniform(0.1, 2.0, shape) * (rng.random(shape) < 0.8)
        elif kind == "ids":
            value = rng.integers(0, dims[dim], shape)
        elif kind in ("bins", "perm"):
            value = rng.integers(-1, dims[dim], shape)
        elif kind == "unique":
            value = rng.permutation(dims[dim])[: shape[0]]
        elif arg.dtype.startswith("int"):
            value = rng.integers(0, 8, shape)
        else:
            value = rng.uniform(0.1, 64.0, shape)
        value = np.ascontiguousarray(value, dtype=np.dtype(arg.dtype))
        out.append(value if arg.host else torch.from_numpy(value).to(device))
    return out


def _leaves(value) -> list:
    if isinstance(value, (tuple, list)):
        return [leaf for item in value for leaf in _leaves(item)]
    return [value]


def _memory_range(value) -> Optional[Tuple[int, int]]:
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        storage = value.untyped_storage()
        return storage.data_ptr(), storage.data_ptr() + storage.nbytes()
    if isinstance(value, np.ndarray):
        start = value.__array_interface__["data"][0]
        return start, start + value.nbytes
    return None


def _recorder(arg_ranges: List[Tuple[int, int]]):
    """A TorchDispatchMode that records, over one call: promotions, foreign
    tensors (host constants), host->device copy bytes and the op count."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from .rules.programcheck import CONST_MIN_BYTES

    wide = {torch.float64, torch.int64, torch.complex128}
    copies = {torch.ops.aten._to_copy, torch.ops.aten.copy_}

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made: List[Tuple[int, int]] = []
            # every op output is held to the end of the call, so no later
            # allocation reuses its memory and reads as made in the call
            self.held: list = []
            self.consts: Dict[tuple, dict] = {}
            self.promotions = set()
            self.h2d_bytes = 0
            self.ops = 0

        def _known(self, ptr: int) -> bool:
            return any(lo <= ptr < hi for lo, hi in arg_ranges) or any(lo <= ptr < hi for lo, hi in self.made)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            for t in inputs:
                nbytes = t.numel() * t.element_size()
                if nbytes >= CONST_MIN_BYTES and not self._known(t.data_ptr()):
                    key = (t.device.type, t.data_ptr(), tuple(t.shape), t.dtype)
                    self.consts.setdefault(key, {"shape": list(t.shape), "dtype": _dtype_name(t.dtype), "bytes": nbytes})
            out = func(*args, **kwargs)
            self.ops += 1
            outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            for t in outputs:
                self.made.append(_memory_range(t))
                self.held.append(t)
            if not any(t.dtype in wide for t in inputs):
                for t in outputs:
                    # a 0-dim output is a scalar torch wrapped to the other
                    # operand's dtype, not a widening
                    if t.dtype in wide and t.dim() > 0:
                        self.promotions.add(f"{func.overloadpacket.__name__}:{_dtype_name(t.dtype)}")
            if func.overloadpacket in copies and inputs:
                src = args[0] if func.overloadpacket is torch.ops.aten._to_copy else args[1]
                dst = outputs[0].device if outputs else args[0].device
                if src.device.type == "cpu" and dst.type == "cuda":
                    self.h2d_bytes += src.numel() * src.element_size()
            return out

    return Recorder()


def _run(spec: EntrySpec, dims: Dict[str, int], device, seed: int) -> dict:
    """One call of the entry at one grid point on `device`, recorded."""
    import numpy as np
    import torch

    from ..ops import _cuda_build

    fn = spec.resolve(dims, device)
    args = _make_args(spec, dims, device, seed)
    ranges = [r for r in (_memory_range(a) for a in args) if r is not None]
    before = [a._version if isinstance(a, torch.Tensor) else a.copy() for a in args]
    builds: List[str] = []

    def listener(name: str, seconds: float) -> None:
        builds.append(name)

    _cuda_build.BUILD_LISTENERS.append(listener)
    try:
        with _recorder(ranges) as rec:
            out = fn(*args, *spec.static_values(dims))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        _cuda_build.BUILD_LISTENERS.remove(listener)
    written = [
        arg.name
        for arg, value, old in zip(spec.args, args, before)
        if (value._version != old if isinstance(value, torch.Tensor) else value.tobytes() != old.tobytes())
    ]
    leaves = _leaves(out)
    return {
        "outputs": [{"shape": [int(d) for d in leaf.shape], "dtype": _dtype_name(leaf.dtype)} for leaf in leaves],
        "values": [leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf) for leaf in leaves],
        "written": written,
        "promotions": set(rec.promotions),
        "consts": sorted(rec.consts.values(), key=lambda c: (-c["bytes"], c["dtype"], c["shape"])),
        "h2d_bytes": rec.h2d_bytes,
        "host_arg_bytes": sum(a.nbytes for a in args if isinstance(a, np.ndarray)),
        "builds": builds,
        "ops": rec.ops,
    }


def _seed(spec: EntrySpec, point: int) -> int:
    return zlib.crc32(f"{spec.name}:{point}".encode())


def audit_entry(spec: EntrySpec, device="cpu", grid_points: Sequence[Dict[str, int]] = (GRID_BASE, GRID_ALT)) -> Tuple[dict, dict]:
    """Audit one entry over the grid on `device`: (its contract dict, the
    facts of this run that only a card has or that are not committed:
    host->device bytes and builds per call, the op count, and for a
    kernel entry on a card, per output, whether it was bit-equal to its
    plain version and the largest |difference|)."""
    import numpy as np
    import torch

    device = torch.device(device)
    runs = [_run(spec, dims, device, _seed(spec, i)) for i, dims in enumerate(grid_points)]
    promotions = set().union(*(r["promotions"] for r in runs))
    bit_equal = max_abs_err = None
    if spec.library is not None and device.type == "cuda":
        # the kernel's launch makes no aten op: its plain version, on copies
        # of the same inputs, is what it is held to and what its dtype
        # discipline is read from. Per output over the grid points: bit for
        # bit, and the largest |difference|
        bit_equal, max_abs_err = [True] * len(runs[0]["values"]), [0.0] * len(runs[0]["values"])
        for i, (dims, run) in enumerate(zip(grid_points, runs)):
            plain = _run(spec, dims, torch.device("cpu"), _seed(spec, i))
            promotions |= plain["promotions"]
            for k, (a, b) in enumerate(zip(run["values"], plain["values"])):
                same = a.dtype == b.dtype and a.shape == b.shape
                bit_equal[k] &= same and np.array_equal(a, b)
                if same and a.size:
                    max_abs_err[k] = max(max_abs_err[k], float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()))
    base = runs[0]
    library_builds = [sum(1 for name in r["builds"] if name == spec.library) for r in runs]
    # the first call may build the library (on a card that has not yet run
    # it); any later build is one a shape triggered
    rebuilds = sum(library_builds) - (1 if library_builds[0] else 0)
    varying = sorted(spec.varying)
    contract = {
        "module": spec.module,
        "function": spec.function,
        "args": [
            {"name": a.name, "axes": [ax if isinstance(ax, str) else int(ax) for ax in a.axes], "dtype": a.dtype, "host": a.host}
            for a in spec.args
        ],
        "static_args": [name for name, _ in spec.static_args],
        "outputs": base["outputs"],
        "varying_axes": varying,
        "static_axes": sorted(set(FLIGHT_DIMS) - set(varying)),
        "inplace": {"declared": sorted(spec.inplace), "written": sorted(set().union(*(r["written"] for r in runs)))},
        "promotions": sorted(promotions),
        "captured_consts": base["consts"],
        "captured_const_bytes": sum(c["bytes"] for c in base["consts"]),
        "library": spec.library,
        "rebuilds": rebuilds,
    }
    facts = {
        "device": str(device),
        "h2d_bytes": [r["h2d_bytes"] for r in runs],
        "host_arg_bytes": [r["host_arg_bytes"] for r in runs],
        "builds": [r["builds"] for r in runs],
        "ops": [r["ops"] for r in runs],
        "bit_equal": bit_equal,
        "max_abs_err": max_abs_err,
    }
    return contract, facts


def _document(entries: Dict[str, dict]) -> dict:
    libraries: Dict[str, dict] = {}
    for name, entry in entries.items():
        if entry["library"] is not None:
            lib = libraries.setdefault(entry["library"], {"entries": [], "varying_axes": [], "static_axes": sorted(FLIGHT_DIMS)})
            lib["entries"].append(name)
    body = {
        "schema_version": SCHEMA_VERSION,
        "grid": {"base": GRID_BASE, "alt": GRID_ALT},
        "entries": {name: entries[name] for name in sorted(entries)},
        "libraries": {name: {**lib, "entries": sorted(lib["entries"])} for name, lib in sorted(libraries.items())},
    }
    digest = hashlib.sha256(json.dumps(body, sort_keys=True).encode("utf-8")).hexdigest()[:16]
    return {
        "comment": (
            "Solver program contracts — generated by `python -m karpenter_tpu_torch.cmd.analyze "
            "--contracts --write --device cpu`, gated by `--contracts --check`. Per device entry: "
            "declared varying/static recompile axes and its kernel library (cross-checked against the "
            "flight recorder's build attribution), the dtype surface with 64-bit promotions, the "
            "in-place surface, and host constants. Do not edit by hand."
        ),
        **body,
        "digest": digest,
    }


def audit(entries: Optional[Sequence[EntrySpec]] = None, device="cuda") -> Tuple[dict, Dict[str, dict]]:
    """The contract document and each entry's run facts on `device` (the
    card unless the caller names the CPU; without a card it raises)."""
    from ..device import resolve_device

    device = resolve_device(device)
    specs = list(entries if entries is not None else default_entries())
    contracts, facts = {}, {}
    for spec in specs:
        contracts[spec.name], facts[spec.name] = audit_entry(spec, device)
    return _document(contracts), facts


def build_contracts(entries: Optional[Sequence[EntrySpec]] = None, device="cuda") -> dict:
    """The full contract document (deterministic: sorted entries, no
    timestamps; the digest keys the staleness gate)."""
    return audit(entries, device)[0]


def default_contracts_path(root: str) -> str:
    return os.path.join(root, "karpenter_tpu_torch", "analysis", CONTRACTS_BASENAME)


def load_committed(root: str, path: Optional[str] = None) -> Optional[dict]:
    path = path or default_contracts_path(root)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_contracts(root: str, path: Optional[str] = None, entries: Optional[Sequence[EntrySpec]] = None, device="cuda") -> dict:
    doc = build_contracts(entries, device)
    path = path or default_contracts_path(root)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def staleness_errors(committed: Optional[dict], current: dict) -> List[str]:
    """Staleness gate: the committed contract must equal the recomputed one.
    Equality is judged on CONTENT, never on the committed file's own digest
    field — a hand-edited file keeps its old digest, and trusting it would
    wave the tamper through."""
    if committed is None:
        return [f"{CONTRACTS_BASENAME} missing — run `analyze --contracts --write` and commit it"]

    def body(doc: dict) -> dict:
        return {k: doc.get(k) for k in ("schema_version", "grid", "entries", "libraries")}

    if body(committed) == body(current) and committed.get("digest") == current.get("digest"):
        return []
    errors = [f"{CONTRACTS_BASENAME} is stale — run `analyze --contracts --write` and commit the diff"]
    old_entries = committed.get("entries", {})
    new_entries = current.get("entries", {})
    for name in sorted(set(old_entries) | set(new_entries)):
        old, new = old_entries.get(name), new_entries.get(name)
        if old is None:
            errors.append(f"  entry {name}: new (no committed contract)")
        elif new is None:
            errors.append(f"  entry {name}: removed (committed contract is orphaned)")
        elif json.dumps(old, sort_keys=True) != json.dumps(new, sort_keys=True):
            changed = [k for k in sorted(set(old) | set(new)) if old.get(k) != new.get(k)]
            errors.append(f"  entry {name}: changed field(s) {changed}")
    return errors


# -- the runtime cross-check (flight recorder <-> static contract) ------------


def recompile_violations(records: Sequence[object], doc: Optional[dict]) -> List[str]:
    """Cross-validate observed builds against the declared contract.

    A recompile of E attributed to changed shape axes D is
    *contract-explained* when at least one axis in D is declared varying
    for E; it is a violation when every changed axis is declared static.
    E is an entry of the document or, as the port's flight recorder
    attributes builds, a kernel library: a library declares no varying
    axis, so any build of it after its first that a shape change is
    attributed to is a violation. Out of scope: cold starts, unattributed
    ('other') builds, and per-library FIRST builds (record.first_compiles).
    A name with no contract at all is itself a violation."""
    if doc is None:
        return [f"{CONTRACTS_BASENAME} missing — the recompile cross-check has no contract to check against"]
    entries = doc.get("entries", {})
    libraries = doc.get("libraries", {})
    violations: List[str] = []
    for rec in records:
        recompile = rec.recompile if hasattr(rec, "recompile") else rec.get("recompile")
        attribution = list(
            rec.recompile_attribution if hasattr(rec, "recompile_attribution") else rec.get("recompile_attribution", [])
        )
        compiled = dict(rec.compiled_fns if hasattr(rec, "compiled_fns") else rec.get("compiled_fns", {}))
        first = set(rec.first_compiles if hasattr(rec, "first_compiles") else rec.get("first_compiles", ()))
        signature = dict(rec.signature if hasattr(rec, "signature") else rec.get("signature", {}))
        rec_id = rec.id if hasattr(rec, "id") else rec.get("id")
        if not recompile or not attribution or attribution == ["cold-start"]:
            continue
        for fn_name in sorted(compiled):
            if fn_name == "other" or fn_name in first:
                continue
            entry = entries.get(fn_name) or libraries.get(fn_name)
            if entry is None:
                violations.append(
                    f"solve {rec_id}: recompile of {fn_name!r} but no contract entry exists — "
                    f"add it to analysis/contracts.py default_entries()"
                )
                continue
            varying = set(entry.get("varying_axes", ()))
            observed = set(attribution)
            if observed & varying:
                continue
            observed_sig = {dim: signature.get(dim) for dim in sorted(observed)}
            violations.append(
                f"solve {rec_id}: recompile of {fn_name!r} attributed to declared-STATIC axis(es) "
                f"{sorted(observed)} — contract declares varying={sorted(varying)}, "
                f"static={entry.get('static_axes')}; observed signature change: {observed_sig}"
            )
    return violations
