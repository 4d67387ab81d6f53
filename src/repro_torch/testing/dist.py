"""Multi-rank harness: spawn ``torch.distributed`` ranks on one host.

:func:`run_ranks` starts ``world`` processes (``spawn``), each joining a
process group through a ``file://`` rendezvous, runs one function of
this package on every rank, and returns each rank's result.  A rank that
raises, or a run that outlives ``timeout``, fails the call, and every
rank still running is terminated, so a hang costs the caller its timeout
and nothing more.  The children import this package and ``torch`` only.

:func:`sharded_mesh_checks` and :func:`grid_mesh_checks` are the rank
bodies of the multi-rank tests of the row-sharded and the N-D grid tiers,
:func:`mesh_train_checks`, :func:`elastic_restore_checks` and
:func:`launcher_checks` those of LM training on a ``("data", "model")``
DeviceMesh: the same inputs (numpy, from the caller) through the mesh
path on every rank.  :func:`example_checks` runs an example script's
``main`` on every rank.
"""
from __future__ import annotations

import os
import pickle
import traceback
import warnings

import numpy as np
import torch

__all__ = ["elastic_restore_checks", "example_checks", "grid_mesh_checks",
           "idle", "launcher_checks", "mesh_train_checks", "run_ranks",
           "sharded_mesh_checks"]


def _rank_main(rank: int, world: int, init_file: str, backend: str,
               fn_name: str, args: tuple, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            result = ("ok", globals()[fn_name](rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = ("error", traceback.format_exc())
    with open(path, "wb") as f:
        pickle.dump(result, f)


def run_ranks(world: int, fn_name: str, args: tuple, work_dir: str,
              timeout: float = 300.0, backend: str = "gloo") -> list:
    """Run ``fn_name(rank, world, *args)`` of this module on ``world``
    spawned ranks; returns the per-rank results in rank order.

    ``work_dir`` (a new or empty directory per call) holds the rendezvous
    file and the results.  Raises ``RuntimeError`` with the rank's
    traceback when a rank fails, and ``TimeoutError`` when the ranks have
    not all ended after ``timeout`` seconds (every rank still alive is
    then killed).
    """
    import multiprocessing as mp
    import time

    os.makedirs(work_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    init_file = os.path.join(work_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_file, backend, fn_name, args,
                               work_dir), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} of {world} still running "
                               f"after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        path = os.path.join(work_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} ended (exit code "
                               f"{procs[r].exitcode}) without a result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        out.append(value)
    return out


def idle(rank: int, world: int, seconds: float) -> None:
    """A rank body that only sleeps: a hang, for the timeout's tests."""
    import time

    time.sleep(seconds)


def _problem(p: dict):
    from ..core.convert import ktensor_from_numpy, sparse_tensor_from_numpy

    t = sparse_tensor_from_numpy(p["shape"], p["indices"], p["values"],
                                 device="cpu")
    kt = ktensor_from_numpy(p["lam"], p["factors"], "cpu")
    return t, kt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def sharded_mesh_checks(rank: int, world: int, problems: dict, bn: int,
                        br: int, rank_r: int, dist_cfg: dict,
                        pi_problem: "dict | None" = None) -> dict:
    """The multi-rank checks of one world size, on one rank.

    ``problems`` maps a name to numpy ``shape``/``indices``/``values``/
    ``lam``/``factors``.  Returns numpy results keyed by case:

      * ``("phi"|"krao", name, mode, combine, local_pi)`` and
        ``("owner_mu", name, mode)``: the sharded entry points over a
        ``("data",)`` mesh of ``world`` ranks;
      * ``("wire", name, mode)``: the collectives
        (:func:`repro_torch.perf.comm.record_collectives`) of the fused
        owner step (``"owner"``) and of ``phi_sharded(combine="psum")``
        (``"psum"``), and on ``"uniform"``'s mode 0 the same two in bf16
        (``"owner_bf16"``, ``"psum_bf16"``);
      * ``"pi_gather"``, given ``pi_problem`` (a problem as above plus
        its ``bn``/``br``): on mode 0, the per-rank bytes of what this
        rank's shard-local Π reads (``values``, ``touched`` rows per
        gathered mode, ``index`` maps, ``valid``) and the collectives of
        a psum ``phi_sharded`` on that path;
      * ``("cpapr", name, combine)``: a sharded ``cpapr_mu`` over that
        mesh (``rebalance_every=1``);
      * ``("dist", name)``: ``dist_cpapr_mu`` on a ``(world,)`` data mesh
        (world 2) or a ``(2, 2)`` data x model mesh (world 4), and
        ``("dist_fallback", name)`` with a rank the model axis does not
        divide (its warnings beside it);
      * ``"mesh_error"``: the message of ``make_phi_mesh(world + 1)``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    from ..core import cpapr
    from ..core.distributed import (
        PHI_COMBINES,
        DistCPAPRConfig,
        dist_cpapr_mu,
        krao_sharded,
        make_phi_mesh,
        owner_stack,
        owner_unstack,
        phi_mu_sharded_owner,
        phi_sharded,
    )
    from ..core.layout import (
        build_blocked_layout,
        build_shard_pi_gather,
        owner_partition,
        shard_blocked_layout,
    )
    from ..core.phi import expand_to_shards
    from ..core.pi import pi_rows
    from ..core.policy import PhiPolicy
    from ..core.sparse_tensor import sort_mode
    from ..perf.comm import record_collectives

    mesh = make_phi_mesh(world, "cpu")
    out: dict = {}
    for name, p in problems.items():
        t, kt = _problem(p)
        for mode in range(t.ndim):
            mv = sort_mode(t, mode)
            pi = pi_rows(mv.sorted_idx, kt.factors, mode)
            b = kt.factors[mode] * kt.lam[None, :]
            base = build_blocked_layout(mv.rows.numpy(), mv.n_rows, bn, br)
            sl = shard_blocked_layout(base, world)
            vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
            pig = build_shard_pi_gather(sl, mv.sorted_idx, mode)
            wire: dict = {}
            for combine in PHI_COMBINES:
                for local_pi in (False, True):
                    kw = dict(mesh=mesh, combine=combine)
                    if local_pi:
                        kw.update(pi_gather=pig, factors=kt.factors)
                    with record_collectives() as log:
                        out[("phi", name, mode, combine, local_pi)] = _np(
                            phi_sharded(sl, vals_es, pi_es, b, **kw))
                    if (combine, local_pi) == ("psum", False):
                        wire["psum"] = log
                    out[("krao", name, mode, combine, local_pi)] = _np(
                        krao_sharded(sl, vals_es, pi_es, **kw))
            opart = owner_partition(sl)
            with record_collectives() as wire["owner"]:
                b_own, viol = phi_mu_sharded_owner(
                    sl, opart, vals_es, pi_es, owner_stack(opart, b, mesh),
                    mesh=mesh)
            out[("owner_mu", name, mode)] = (
                _np(owner_unstack(opart, b_own, mesh)), float(viol))
            if (name, mode) == ("uniform", 0):
                h = torch.bfloat16
                vals_h, pi_h, b_h = (x.to(h) for x in (vals_es, pi_es, b))
                with record_collectives() as wire["psum_bf16"]:
                    phi_sharded(sl, vals_h, pi_h, b_h, mesh=mesh)
                with record_collectives() as wire["owner_bf16"]:
                    phi_mu_sharded_owner(sl, opart, vals_h, pi_h,
                                         owner_stack(opart, b_h, mesh),
                                         mesh=mesh)
            out[("wire", name, mode)] = wire
        for combine in PHI_COMBINES:
            cfg = cpapr.CPAPRConfig(
                rank=rank_r, max_outer=3, strategy="sharded", mesh=mesh,
                combine=combine, rebalance_every=1,
                policy=PhiPolicy(strategy="blocked", block_nnz=bn,
                                 block_rows=br))
            res = cpapr.cpapr_mu(t, rank_r, init=kt, config=cfg,
                                 device="cpu")
            out[("cpapr", name, combine)] = dict(
                factors=[_np(f) for f in res.ktensor.factors],
                lam=_np(res.ktensor.lam), kkt=res.kkt_history,
                loglik=res.loglik_history, inner=res.inner_iters,
                rebalances=res.rebalances)
        dcfg = DistCPAPRConfig(rank=rank_r, **dist_cfg)
        shape, names = ((world,), ("data",)) if world != 4 \
            else ((2, 2), ("data", "model"))
        dmesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        kt_d, hist = dist_cpapr_mu(t, rank_r, dmesh, init=kt, config=dcfg,
                                   device="cpu")
        out[("dist", name)] = dict(factors=[_np(f) for f in kt_d.factors],
                                   lam=_np(kt_d.lam), kkt=hist)
        if world == 4:
            odd = rank_r - 1  # not divisible by the model axis (2)
            init = type(kt)(lam=kt.lam[:odd],
                            factors=tuple(f[:, :odd] for f in kt.factors))
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                kt_f, hist_f = dist_cpapr_mu(
                    t, odd, dmesh, init=init,
                    config=DistCPAPRConfig(rank=odd, **dist_cfg),
                    device="cpu")
            out[("dist_fallback", name)] = dict(
                factors=[_np(f) for f in kt_f.factors], kkt=hist_f,
                warnings=[str(x.message) for x in w])
    if pi_problem is not None:
        out["pi_gather"] = _pi_gather_bytes(pi_problem, mesh, world)
    try:
        make_phi_mesh(world + 1, "cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out


def _pi_gather_bytes(p: dict, mesh, world: int) -> dict:
    """Mode 0 of ``p`` on the shard-local Π path: the per-rank bytes of
    the tensors this rank's shard reads, and the collectives of one psum
    Φ on that path."""
    from ..core import distributed as D
    from ..core.layout import (
        build_blocked_layout,
        build_shard_pi_gather,
        shard_blocked_layout,
    )
    from ..core.phi import expand_vals_to_shards
    from ..core.sparse_tensor import sort_mode
    from ..perf.comm import entry_parameter_bytes, record_collectives

    t, kt = _problem(p)
    mv = sort_mode(t, 0)
    sl = shard_blocked_layout(build_blocked_layout(
        mv.rows.numpy(), mv.n_rows, p["bn"], p["br"]), world)
    pig = build_shard_pi_gather(sl, mv.sorted_idx, 0)
    vals_es = expand_vals_to_shards(sl, mv.sorted_vals)
    touched, lidx = pig.on(vals_es.device)
    vals, fg, li, valid = D._pi_operands(
        pig, sl.on(vals_es.device).valid, touched, lidx, vals_es,
        kt.factors, torch.distributed.get_rank())
    b = kt.factors[0] * kt.lam[None, :]
    with record_collectives() as log:
        D.phi_sharded(sl, vals_es, None, b, mesh=mesh, pi_gather=pig,
                      factors=kt.factors)
    return {"values": entry_parameter_bytes([vals])[0],
            "touched": entry_parameter_bytes(fg),
            "index": entry_parameter_bytes(li),
            "valid": entry_parameter_bytes([valid])[0],
            "collectives": log}


def _as_numpy_problem(t, kt) -> dict:
    """The numpy form of a (SparseTensor, KTensor) pair that
    :func:`sharded_mesh_checks` takes (port or JAX-package objects)."""
    return {"shape": tuple(int(s) for s in t.shape),
            "indices": np.asarray(_np(t.indices)),
            "values": np.asarray(_np(t.values)),
            "lam": np.asarray(_np(kt.lam)),
            "factors": [np.asarray(_np(f)) for f in kt.factors]}


def grid_mesh_checks(rank: int, world: int, problems: dict, bn: int,
                     br: int, rank_r: int, grid_shape: tuple) -> dict:
    """The multi-rank checks of the N-D grid tier, on one rank of a
    ``grid_shape`` (A, B) ``("row", "col")`` mesh of ``world = A*B``
    ranks.  ``problems`` as for :func:`sharded_mesh_checks`.  Returns
    numpy results keyed by case:

      * ``("phi"|"krao", name, mode)`` and ``("mu", name, mode)`` (B' and
        the KKT value): the grid entry points over the mesh;
      * ``("collectives", name, mode)``: the collectives one fused step
        (``phi_mu_grid_owner``) issued, as
        :func:`repro_torch.perf.comm.record_collectives` logs them;
      * ``("sx1", name, mode)`` where ``B > 1``: the same step's log and
        ``phi_grid``'s result on a ``(world, 1)`` grid of the same ranks;
      * ``("cpapr", name)``: a grid ``cpapr_mu`` over the mesh;
      * ``("rung", name)``: the same solve with one injected kernel fault
        on a blocked grid mode, ladder on (the grid -> sharded rung runs
        the 1-D path on the mesh's ``"row"`` sub-mesh), and its
        recoveries;
      * ``"mesh_error"``: the message of ``make_grid_mesh`` past the
        world size.
    """
    from ..core import cpapr
    from ..core import distributed as D
    from ..core.layout import build_blocked_layout, build_grid_layout
    from ..core.phi import expand_to_grid
    from ..core.pi import pi_rows
    from ..core.policy import PhiPolicy
    from ..core.sparse_tensor import sort_mode
    from ..perf.comm import record_collectives
    from . import faults

    a, b_ax = (int(x) for x in grid_shape)
    mesh = D.make_grid_mesh(a, b_ax, "cpu")
    mesh_sx1 = D.make_grid_mesh(world, 1, "cpu") if b_ax > 1 else None
    out: dict = {}
    for name, p in problems.items():
        t, kt = _problem(p)
        for mode in range(t.ndim):
            mv = sort_mode(t, mode)
            pi = pi_rows(mv.sorted_idx, kt.factors, mode)
            b = kt.factors[mode] * kt.lam[None, :]
            base = build_blocked_layout(mv.rows.numpy(), mv.n_rows, bn, br)
            g = build_grid_layout(base, (a, b_ax))
            vals_cs, pi_cs = expand_to_grid(g, mv.sorted_vals, pi)
            out[("phi", name, mode)] = _np(D.phi_grid(g, vals_cs, pi_cs, b,
                                                      mesh=mesh))
            out[("krao", name, mode)] = _np(D.krao_grid(g, vals_cs, pi_cs,
                                                        mesh=mesh))
            b_new, viol = D.phi_mu_grid(g, vals_cs, pi_cs, b, mesh=mesh)
            out[("mu", name, mode)] = (_np(b_new), float(viol))
            b_own = D.grid_stack(g, b, mesh)
            with record_collectives() as log:
                D.phi_mu_grid_owner(g, vals_cs, pi_cs, b_own, mesh=mesh)
            out[("collectives", name, mode)] = log
            if mesh_sx1 is not None:
                g1 = build_grid_layout(base, (world, 1))
                vals_1, pi_1 = expand_to_grid(g1, mv.sorted_vals, pi)
                with record_collectives() as log:
                    D.phi_mu_grid_owner(g1, vals_1, pi_1,
                                        D.grid_stack(g1, b, mesh_sx1),
                                        mesh=mesh_sx1)
                out[("sx1", name, mode)] = (log, _np(D.phi_grid(
                    g1, vals_1, pi_1, b, mesh=mesh_sx1)))
        cfg = dict(rank=rank_r, max_outer=3, strategy="grid", mesh=mesh,
                   grid_shape=(a, b_ax),
                   policy=PhiPolicy(strategy="blocked", block_nnz=bn,
                                    block_rows=br))
        res = cpapr.cpapr_mu(t, rank_r, init=kt, device="cpu",
                             config=cpapr.CPAPRConfig(**cfg))
        out[("cpapr", name)] = _solve_result(res)
        with faults.fail_strategy(strategy="grid", mode=0):
            res = cpapr.cpapr_mu(t, rank_r, init=kt, device="cpu",
                                 config=cpapr.CPAPRConfig(max_demotions=4,
                                                          **cfg))
        out[("rung", name)] = _solve_result(res)
    try:
        D.make_grid_mesh(world + 1, 1, "cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out


def _solve_result(res) -> dict:
    return dict(factors=[_np(f) for f in res.ktensor.factors],
                lam=_np(res.ktensor.lam), kkt=res.kkt_history,
                loglik=res.loglik_history, inner=res.inner_iters,
                recoveries=[(e.kind, e.mode, e.detail.get("action"))
                            for e in res.recoveries or []])


# ---------------------------------------------------------------------------
# LM training on a ("data", "model") mesh
# ---------------------------------------------------------------------------


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _train_mesh(shape: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def _cpu_mm_dtype() -> None:
    """Give ``aten::mm.dtype``/``aten::bmm.dtype`` a CPU kernel in this
    process (the f32 product of the upcast operands), so that the card's
    bf16 branch of ``matmul_f32`` and its DTensor rule run on gloo ranks.
    The CPU build has none."""
    global _MM_LIB
    if "_MM_LIB" in globals():
        return
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("mm.dtype", lambda a, b, out_dtype: torch.mm(
        a.to(out_dtype), b.to(out_dtype)), "CPU")
    lib.impl("bmm.dtype", lambda a, b, out_dtype: torch.bmm(
        a.to(out_dtype), b.to(out_dtype)), "CPU")
    _MM_LIB = lib


def _matmul_f32_checks(mesh, a_np, b_np) -> dict:
    """``_MatmulF32`` (the card's bf16 product) on DTensors of every
    placement pair on the 1-D ``mesh``: {(a placement, b placement):
    (product, grad a, grad b)} as full numpy arrays (f32)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ..models.layers import _MatmulF32

    _cpu_mm_dtype()
    out = {}
    a_full = torch.from_numpy(a_np).to(torch.bfloat16)
    b_full = torch.from_numpy(b_np).to(torch.bfloat16)
    choices = [Replicate()] + [Shard(i) for i in range(a_full.dim())]
    for pa in choices:
        for pb in choices[:1 + b_full.dim()]:
            a = distribute_tensor(a_full, mesh, [pa], src_data_rank=None)
            b = distribute_tensor(b_full, mesh, [pb], src_data_rank=None)
            a.requires_grad_(True)
            b.requires_grad_(True)
            y = _MatmulF32.apply(a, b)
            ga, gb = torch.autograd.grad(y.sum(), (a, b))
            out[(str(pa), str(pb))] = tuple(
                t.detach().full_tensor().float().numpy() for t in (y, ga, gb))
    return out


def mesh_train_checks(rank: int, world: int, cases: list, lr: float,
                      mesh_shape: tuple, save_case=None, ckpt_dir=None,
                      matmul_inputs=None) -> dict:
    """One train step of each case on a ``mesh_shape`` ``("data",
    "model")`` mesh of the ``world`` ranks.

    ``cases``: (arch, rules profile, params, batch), numpy trees (the
    reduced f32 config of ``arch``).  Every rank returns
    ``{case: [paths whose placements the step changed]}`` under
    ``"moved"``; rank 0 also ``{case: {"state", "loss", "grad_norm",
    "step", "placements"}}`` (the new state as full numpy arrays, each
    leaf's placements as strings) under ``"steps"``.  The state of
    ``save_case`` is saved to ``ckpt_dir`` at step 1 (rank 0 writes).
    ``matmul_inputs`` (a list of (a, b) numpy pairs): the
    :func:`_matmul_f32_checks` of each on the mesh's ``"model"``
    sub-mesh, under ``"matmul_f32"``.
    """
    from ..configs import ARCHS, reduced
    from ..launch.mesh import batch_shardings, state_shardings
    from ..models.api import build_model
    from ..models.convert import params_from_numpy
    from ..models.params import set_rules_profile, tree_map
    from ..train import checkpoint
    from ..train.optimizer import make_optimizer
    from ..train.step import make_train_step, state_specs

    mesh = _train_mesh(mesh_shape)
    out: dict = {"moved": {}, "steps": {}}
    try:
        for name, profile, params_np, batch_np in cases:
            set_rules_profile(profile)
            cfg = reduced(ARCHS[name])
            model = build_model(cfg)
            opt = make_optimizer(cfg.optimizer, lr=lr)
            params = params_from_numpy(params_np, "cpu")
            sh = state_shardings(state_specs(model, opt), mesh)
            state = tree_map(lambda x, s: s.place(x),
                             {"params": params, "opt": opt.init(params)}, sh)
            specs = {k: (tuple(v.shape), None) for k, v in batch_np.items()}
            bsh = batch_shardings(specs, mesh)
            batch = {k: bsh[k].place(torch.from_numpy(v))
                     for k, v in batch_np.items()}
            new, metrics = make_train_step(model, opt)(state, batch)
            old = dict(_items(state))
            got = dict(_items(new))
            out["moved"][(name, profile)] = [
                p for p in old if tuple(got[p].placements)
                != tuple(old[p].placements)]
            full = {p: t.full_tensor().numpy() for p, t in got.items()}
            if save_case == (name, profile):
                checkpoint.save(ckpt_dir, 1, new)
            if rank == 0:
                out["steps"][(name, profile)] = dict(
                    state=full, loss=float(metrics["loss"]),
                    grad_norm=float(metrics["grad_norm"]),
                    step=int(metrics["step"]),
                    placements={p: [str(x) for x in t.placements]
                                for p, t in got.items()})
    finally:
        set_rules_profile("tp_fsdp")
    if matmul_inputs is not None:
        res = [_matmul_f32_checks(mesh["model"], a, b)
               for a, b in matmul_inputs]
        if rank == 0:
            out["matmul_f32"] = res
    return out


def elastic_restore_checks(rank: int, world: int, ckpt_dir: str, arch: str,
                           profile: str, mesh_shape: tuple) -> dict:
    """Restore the checkpoint a :func:`mesh_train_checks` case saved onto
    a ``mesh_shape`` mesh of these ranks (``restore(..., shardings=)``)
    and onto the CPU with no mesh (``device="cpu"``).  Rank 0 returns
    both as full numpy arrays by path, and the restored step; every rank
    returns whether each restored leaf has the target placements."""
    from ..configs import ARCHS, reduced
    from ..launch.mesh import state_shardings
    from ..models.api import build_model
    from ..models.params import abstract_params, set_rules_profile, tree_map
    from ..train.checkpoint import restore
    from ..train.optimizer import make_optimizer
    from ..train.step import state_specs

    mesh = _train_mesh(mesh_shape)
    set_rules_profile(profile)
    try:
        cfg = reduced(ARCHS[arch])
        model = build_model(cfg)
        specs = state_specs(model, make_optimizer(cfg.optimizer))
        sh = state_shardings(specs, mesh)
        target = abstract_params(specs)
        on_mesh, step = restore(ckpt_dir, target, shardings=sh)
        plain, step_cpu = restore(ckpt_dir, target, device="cpu")
        placed = tree_map(lambda t, s: tuple(t.placements) == s.placements,
                          on_mesh, sh)
    finally:
        set_rules_profile("tp_fsdp")
    out = {"placed": all(v for _, v in _items(placed)),
           "steps": (step, step_cpu)}
    full = {p: t.full_tensor().numpy() for p, t in _items(on_mesh)}
    if rank == 0:
        out["mesh"] = full
        out["cpu"] = {p: t.numpy() for p, t in _items(plain)}
    return out


def launcher_checks(rank: int, world: int, runs: list) -> list:
    """``launch.train.main(argv)`` for each argv of ``runs`` in turn on
    this group (the launcher uses the group it finds); returns, per run,
    the lines it printed (rank 0) and the loop's last step."""
    import contextlib
    import io

    from ..launch import train

    out = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(list(argv))
        out.append((rc, buf.getvalue().splitlines()))
    return out


def example_checks(rank: int, world: int, path: str, argv: list,
                   record: list | None = None) -> tuple:
    """``main(argv)`` of the example script at ``path`` on this group (the
    script uses the group it finds); returns its exit code and the lines
    it printed.  With ``record`` a list, the result of each of the
    script's ``cpapr_mu`` calls is appended to it."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location("example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if record is not None and hasattr(mod, "cpapr_mu"):
        solve = mod.cpapr_mu

        def recorded(*a, **k):
            res = solve(*a, **k)
            record.append(res)
            return res

        mod.cpapr_mu = recorded
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue().splitlines()
