"""Multi-pod dry run: every (arch x shape x mesh) cell projected on a fake
process group.

For each cell this opens a fake process group of the production mesh's
size (256 ranks, or 512 with ``--mesh multi``) in this one process, builds
the state and the inputs under ``FakeTensorMode`` as DTensors with the
active rules' placements (no memory is allocated), runs the real step
(``make_train_step`` for train_4k, ``Model.prefill`` for prefill_32k,
``make_serve_step`` for the decode shapes) as rank 0, and records:

  * FLOPs per device: counted by a ``FlopCounterMode`` on the local ops
    DTensor issues on rank 0's shards (a dispatch mode that counted the
    DTensor-level ops would see their global shapes, and the attention
    runs on the shards), so work repeated on replicated dims is counted
    on every rank; ``flops_all_devices`` is that times the rank count;
  * bytes: every local op's tensor inputs read once and outputs written
    once (views and collectives left out), per rank;
  * collectives: each local collective op, counted and with its per-rank
    wire bytes from its shapes and group size, cross-checked against
    ``CommDebugMode``'s counts;
  * memory: per-rank state bytes from the placements, and per-rank peak
    bytes from ``MemTracker`` under fake mode;
  * the 3-term roofline (``perf/roofline.py``) against the H100 SXM's
    dense bf16 tensor-core peak, HBM and NVLink rates.

Every record says in ``source`` that its numbers are this projection for
an H100 SXM: not XLA's ``memory_analysis``/``cost_analysis``, and not a
measurement.  Results land in ``<out>/<mesh>/<arch>__<shape>.json`` (one
file per cell; existing files are skipped, so the sweep is restartable).
The exit code is 1 if any cell failed.

The fake tensors live on ``--device`` (default the card, whose kernels'
shapes the projection is for; no card memory is used).  ``--device cpu``
runs where there is no card: the CPU build multiplies bf16 operands as
upcast f32 copies (``matmul_f32``), which its bytes and peak then count,
and the record says ``"device_type": "cpu"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table  # the records
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import SHAPES
from ..configs import ARCHS, cell_skip_reason, get_arch
from ..device import resolve_device
from ..models.api import build_model
from ..models.params import (
    NamedSharding,
    contiguous_strides,
    count_params,
    mesh_axis_sizes,
    set_rules_profile,
    tree_leaves,
    tree_map,
)
from ..perf.roofline import HARDWARE, roofline_terms
from ..train.optimizer import make_optimizer
from ..train.step import (
    make_prefill,
    make_serve_step,
    make_train_step,
    on_mesh,
    state_specs,
)
from .mesh import batch_shardings, make_production_mesh, state_shardings

__all__ = ["SOURCE", "lower_cell", "main", "model_flops_for", "run_cell",
           "table"]

OUT_DIR = os.path.join("build", "dryrun")
HW = HARDWARE["h100_sxm_bf16"]
SOURCE = ("torch fake-tensor projection for an NVIDIA H100 SXM from "
          "datasheet rates (989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3, "
          "450 GB/s NVLink 4 each way): one step run as rank 0 of a fake "
          "process group under FakeTensorMode with DTensor state, FLOPs, "
          "bytes and collectives counted from its ops; not XLA's "
          "memory_analysis or cost_analysis, and not a measurement")

# ops that move no tensor bytes: views, and allocations left uninitialized
_NO_TRAFFIC = {"view", "_unsafe_view", "reshape", "expand", "permute",
             "transpose", "t", "unsqueeze", "squeeze", "select", "slice",
             "alias", "as_strided", "detach", "unbind", "split",
             "split_with_sizes", "chunk", "narrow", "diagonal",
             "view_as_real", "view_as_complex", "_reshape_alias", "lift_fresh",
             "empty_strided", "empty", "new_empty", "new_empty_strided"}


_DTYPE_PRODUCTS = (torch.ops.aten.mm.dtype, torch.ops.aten.bmm.dtype)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D train, 2*N_active*D inference."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class LocalCost(TorchDispatchMode):
    """Per-rank FLOPs, bytes and collectives of the local ops DTensor
    issues.  A DTensor-level op is handed on (``NotImplemented``), so the
    mode sees the ops on this rank's shards; the fake ops DTensor runs to
    propagate output shapes are not counted (:meth:`paused`).  FLOPs are
    ``FlopCounterMode``'s count of those ops (``self.counter``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.counter = FlopCounterMode(display=False)
        self._on = True
        self.bytes = 0
        self.wire = {}
        self.counts = {}

    @contextlib.contextmanager
    def paused(self):
        on, self._on = self._on, False
        try:
            yield
        finally:
            self._on = on

    def _collective(self, name: str, args) -> None:
        x = args[0]
        b = _nbytes(x) if isinstance(x, torch.Tensor) else sum(
            _nbytes(t) for t in x)
        if name == "all_gather_into_tensor":
            n = int(args[1])
            wire = b * (n - 1)
        elif name == "reduce_scatter_tensor":
            n = int(args[2])
            wire = b * (n - 1) / n
        elif name == "all_reduce":
            n = _group_size(args[2])
            wire = 2 * b * (n - 1) / n
        elif name in ("all_to_all_single", "shard_dim_alltoall"):
            n = _group_size(args[3])
            wire = b * (n - 1) / n
        else:
            wire = b
        self.wire[name] = self.wire.get(name, 0.0) + wire
        self.counts[name] = self.counts.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:
            # a composite op (inference mode leaves some, e.g. matmul)
            # counts as the ops it decomposes into, as FlopCounterMode
            # counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._on or any(t.device.type == "meta"
                               for t in _tensors(out)):
            # DTensor also propagates some ops' placements by running
            # their decompositions on meta tensors of the global shapes
            return out
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in ("_c10d_functional", "c10d", "_dtensor"):
            if name not in ("wait_tensor", "wait"):
                self._collective(name.rstrip("_"), args)
            return out
        # the f32-output products count as the products they are (the
        # formulas would read their dtype argument as an output shape)
        counted = args[:2] if func in _DTYPE_PRODUCTS else args
        self.counter._count_flops(packet, out, counted, kwargs)
        if name not in _NO_TRAFFIC and ns == "aten":
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


@contextlib.contextmanager
def _propagation_paused(mode: LocalCost):
    """Leave DTensor's output-shape propagation (fake ops at global
    shapes) out of ``mode``'s counts and, by running it under a fake mode
    of its own, out of ``MemTracker``'s (which counts only the ops of the
    fake mode active when it was entered)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, *a, **k):
        with mode.paused(), unset_fake_temporarily():
            return orig(self, *a, **k)

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def _alltoall_on_cpu():
    """DTensor emulates an all-to-all on a CPU mesh by an all-gather and a
    chunk (gloo has no all-to-all), which would count the gathered tensor
    as traffic and memory.  The fake group exchanges nothing, so the dry
    run issues the all-to-all op itself, as on the card."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    orig = cu.shard_dim_alltoall

    def direct(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol

        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    cu.shard_dim_alltoall = pt.shard_dim_alltoall = direct
    try:
        yield
    finally:
        cu.shard_dim_alltoall = pt.shard_dim_alltoall = orig


def _local_empty(shape, dtype, sharding: NamedSharding) -> DTensor:
    """An uninitialized DTensor of global ``shape`` whose local tensor is
    rank 0's chunk alone (so its storage is the chunk's)."""
    mesh = sharding.mesh
    sizes = mesh_axis_sizes(mesh)
    local = list(shape)
    for i, r in enumerate(sharding.spec):
        if r is not None:
            for nm in ((r,) if isinstance(r, str) else r):
                local[i] //= sizes[nm]
    t = torch.empty(local, dtype=dtype, device=mesh.device_type)
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def _state_bytes(specs, shardings) -> int:
    """Per-rank bytes of a ParamSpec tree under its shardings."""
    sizes = mesh_axis_sizes(next(iter(tree_leaves(shardings))).mesh)
    total = 0
    for s, sh in zip(tree_leaves(specs), tree_leaves(shardings)):
        div = 1
        for r in sh.spec:
            if r is not None:
                for nm in ((r,) if isinstance(r, str) else r):
                    div *= sizes[nm]
        total += math.prod(s.shape) * torch.empty(
            (), dtype=s.dtype).element_size() // div
    return total


def _fake_tree(specs, shardings):
    return tree_map(lambda s, sh: _local_empty(s.shape, s.dtype, sh), specs,
                    shardings)


def lower_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True):
    """Build one cell's step and its fake inputs (call under
    ``FakeTensorMode``).  Returns (fn, args, meta): ``fn(*args)`` runs the
    step; ``meta`` holds the cell's counts from its specs.  ``verbose`` is
    the JAX package's flag, which its ``lower_cell`` takes and does not
    read either: neither prints here; the ``[dryrun]`` progress lines come
    from :func:`run_cell`."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    # the zero3 profile targets training (decode batches don't divide all
    # axes); inference cells keep tp_fsdp
    set_rules_profile(cfg.sharding_profile if shape.kind == "train"
                      else "tp_fsdp")
    model = build_model(cfg)
    if shape.kind != "train":
        # the serving methods run under inference mode, and a DTensor view
        # made there of a tensor made outside it cannot be versioned
        with torch.inference_mode():
            return _lower(cfg, model, shape, mesh, arch, shape_name)
    return _lower(cfg, model, shape, mesh, arch, shape_name)


def _lower(cfg, model, shape, mesh, arch: str, shape_name: str):
    in_specs = model.input_specs(shape)
    in_sh = batch_shardings(in_specs, mesh)
    batch = {k: _local_empty(shp, dt, in_sh[k])
             for k, (shp, dt) in in_specs.items()}
    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        specs = state_specs(model, opt)
        sh = state_shardings(specs, mesh)
        fn, args = make_train_step(model, opt), (_fake_tree(specs, sh), batch)
        n_state = count_params(specs["params"])
    elif shape.kind == "prefill":
        specs = model.param_specs()
        sh = state_shardings(specs, mesh)

        fn = make_prefill(model)

        args = (_fake_tree(specs, sh), batch)
        n_state = count_params(specs)
    else:  # decode
        specs = model.param_specs()
        sh = state_shardings(specs, mesh)
        c_specs = model.cache_specs(shape.global_batch, shape.seq_len)
        c_sh = state_shardings(c_specs, mesh)
        fn = make_serve_step(model)
        args = (_fake_tree(specs, sh), _fake_tree(c_specs, c_sh),
                batch["tokens"])
        n_state = count_params(specs)
        specs = {"params": specs, "caches": c_specs}
        sh = {"params": sh, "caches": c_sh}
    meta = {"arch": arch, "shape": shape_name, "n_chips": mesh.size(),
            "n_state_params": n_state,
            "state_bytes_per_device": _state_bytes(specs, sh),
            "rules": "zero3" if shape.kind == "train"
            and cfg.sharding_profile == "zero3" else "tp_fsdp"}
    return fn, args, meta


def analyze(fn, args, meta, mesh, hw=HW) -> dict:
    """Run ``fn(*args)`` once as rank 0 under the counting modes (call
    under ``FakeTensorMode``) and build the cell's record."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    mt = MemTracker()
    mt.track_external(*[t.to_local() for t in _tensors(args)
                        if isinstance(t, DTensor)])
    local = LocalCost()
    comm = CommDebugMode()
    t0 = time.perf_counter()
    cpu = (contextlib.nullcontext() if mesh.device_type != "cpu"
           else _alltoall_on_cpu())
    with _propagation_paused(local), cpu, mt, comm, local, on_mesh(mesh):
        fn(*args)
    secs = time.perf_counter() - t0
    peak = sum(snap["Total"] for dev, snap in
               mt.get_tracker_snapshot("peak").items()
               if torch.device(dev).type == mesh.device_type)
    n = meta["n_chips"]
    cfg = get_arch(meta["arch"])
    shape = SHAPES[meta["shape"]]
    mf = model_flops_for(cfg, shape)
    wire = sum(local.wire.values())
    flops = local.counter.get_total_flops()
    rt = roofline_terms(hlo_flops=flops * n, hlo_bytes=local.bytes * n,
                        collective_bytes=wire, n_chips=n, hw=hw,
                        model_flops=mf)
    return {
        **meta,
        "source": SOURCE,
        "hardware": hw.name,
        "cost": {"flops_per_device": float(flops),
                 "flops_all_devices": float(flops * n),
                 "bytes_per_device": float(local.bytes)},
        "collectives": {
            "by_kind_wire": local.wire,
            "by_kind_count": local.counts,
            "wire_bytes": wire,
            "comm_debug_counts": {str(k): v for k, v in
                                  comm.get_comm_counts().items()},
        },
        "hbm_bytes_per_device": int(peak),
        "roofline": {
            "compute_s": rt.compute_s,
            "memory_s": rt.memory_s,
            "collective_s": rt.collective_s,
            "dominant": rt.dominant,
            "bound_s": rt.bound_s,
            "model_flops": rt.model_flops,
            "useful_flops_ratio": rt.useful_flops_ratio,
            "mfu_bound": rt.mfu_bound,
        },
        "seconds": {"run": secs},
    }


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0
    (no communication; every collective's output is a placeholder)."""
    import torch.testing._internal.distributed.fake_pg as fake_pg

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already open")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, device="cuda") -> dict | None:
    os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
    path = os.path.join(out_dir, mesh_kind, f"{arch}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_arch(arch)
    reason = cell_skip_reason(cfg, SHAPES[shape_name])
    if reason:
        rec = {"arch": arch, "shape": shape_name, "skipped": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] SKIP  {mesh_kind:6s} {arch:28s} {shape_name:12s} "
              f"{reason}")
        return rec
    from torch._subclasses.fake_tensor import FakeTensorMode

    multi = mesh_kind == "multi"
    device_type = resolve_device(device).type
    t0 = time.time()
    try:
        with fake_process_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi,
                                        device_type=device_type)
            try:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    fn, args, meta = lower_cell(arch, shape_name, mesh)
                    t_build = time.time() - t0
                    rec = analyze(fn, args, meta, mesh)
            finally:
                set_rules_profile("tp_fsdp")
        rec["seconds"]["build"] = t_build
        rec["mesh"] = mesh_kind
        rec["device_type"] = device_type
        r = rec["roofline"]
        print(f"[dryrun] OK    {mesh_kind:6s} {arch:28s} {shape_name:12s} "
              f"hbm/dev={rec['hbm_bytes_per_device'] / 2**30:6.2f}GiB "
              f"dom={r['dominant']:10s} bound={r['bound_s'] * 1e3:8.2f}ms "
              f"(projection; build {t_build:.0f}s run "
              f"{rec['seconds']['run']:.0f}s)")
    except Exception as e:  # record the failure; the sweep continues
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "source": SOURCE,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] FAIL  {mesh_kind:6s} {arch:28s} {shape_name:12s} "
              f"{type(e).__name__}: {str(e)[:120]}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def table(out_dir: str) -> str:
    """One markdown row per record under ``out_dir``: per-device state and
    peak GiB, FLOPs, the dominant roofline term, the bound in ms (all
    projections) and the seconds the cell took here (build + run)."""
    rows = ["| mesh | arch | shape | state GiB | peak GiB | FLOP/device | "
            "dominant | bound ms | s |", "| --- " * 9 + "|"]
    for mesh_kind in ("single", "multi"):
        d = os.path.join(out_dir, mesh_kind)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name)) as f:
                r = json.load(f)
            cell = f"| {mesh_kind} | {r['arch']} | {r['shape']} |"
            if "skipped" in r or "error" in r:
                what = ("skipped: " + r["skipped"] if "skipped" in r
                        else "error: " + r["error"][:80])
                rows.append(f"{cell} {what} |" + " |" * 5)
                continue
            rt = r["roofline"]
            rows.append(
                f"{cell} {r['state_bytes_per_device'] / 2 ** 30:.2f} | "
                f"{r['hbm_bytes_per_device'] / 2 ** 30:.2f} | "
                f"{r['cost']['flops_per_device']:.4e} | {rt['dominant']} | "
                f"{rt['bound_s'] * 1e3:.2f} | "
                f"{r['seconds']['build'] + r['seconds']['run']:.0f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (default: the "
                         "card's)")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown "
                         "table and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0
    resolve_device(args.device)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    n_fail = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               force=args.force, device=args.device)
                if rec and "error" in rec:
                    n_fail += 1
    print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
