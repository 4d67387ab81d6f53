"""Multi-rank harness: spawn ``torch.distributed`` ranks on one host.

:func:`run_ranks` starts ``world`` processes (``spawn``), each joining a
process group through a ``file://`` rendezvous, runs one function of
this package on every rank, and returns each rank's result.  A rank that
raises, or a run that outlives ``timeout``, fails the call, and every
rank still running is terminated, so a hang costs the caller its timeout
and nothing more.  The children import this package and ``torch`` only.

:func:`sharded_mesh_checks` and :func:`grid_mesh_checks` are the rank
bodies of the multi-rank tests of the row-sharded and the N-D grid tiers:
the same inputs (numpy, from the caller) through the mesh path on every
rank.
"""
from __future__ import annotations

import os
import pickle
import traceback
import warnings

import numpy as np
import torch

__all__ = ["grid_mesh_checks", "idle", "run_ranks", "sharded_mesh_checks"]


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
                        br: int, rank_r: int, dist_cfg: dict) -> dict:
    """The multi-rank checks of one world size, on one rank.

    ``problems`` maps a name to numpy ``shape``/``indices``/``values``/
    ``lam``/``factors``.  Returns numpy results keyed by case:

      * ``("phi"|"krao", name, mode, combine, local_pi)`` and
        ``("owner_mu", name, mode)``: the sharded entry points over a
        ``("data",)`` mesh of ``world`` ranks;
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
            for combine in PHI_COMBINES:
                for local_pi in (False, True):
                    kw = dict(mesh=mesh, combine=combine)
                    if local_pi:
                        kw.update(pi_gather=pig, factors=kt.factors)
                    out[("phi", name, mode, combine, local_pi)] = _np(
                        phi_sharded(sl, vals_es, pi_es, b, **kw))
                    out[("krao", name, mode, combine, local_pi)] = _np(
                        krao_sharded(sl, vals_es, pi_es, **kw))
            opart = owner_partition(sl)
            b_own, viol = phi_mu_sharded_owner(
                sl, opart, vals_es, pi_es, owner_stack(opart, b, mesh),
                mesh=mesh)
            out[("owner_mu", name, mode)] = (
                _np(owner_unstack(opart, b_own, mesh)), float(viol))
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
    try:
        make_phi_mesh(world + 1, "cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out


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
      * ``("collectives", name, mode)``: the ``(op, group, per-device
        wire bytes)`` of the collectives one fused step
        (``phi_mu_grid_owner``) issued, with ``group`` one of ``"col"``,
        ``"row"`` and ``"world"``;
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
    from . import faults

    a, b_ax = (int(x) for x in grid_shape)
    mesh = D.make_grid_mesh(a, b_ax, "cpu")
    tags = {id(mesh.get_group("col")): "col",
            id(mesh.get_group("row")): "row", id(None): "world"}
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
            log: list = []
            wrapped = {}
            for op in ("_all_gather", "_reduce_scatter", "_all_reduce"):
                wrapped[op] = getattr(D, op)

                def spy(*args, _op=op, **kw):
                    group = args[-1] if _op != "_all_reduce" else args[1]
                    moved = args[1] if _op == "_all_gather" else args[0]
                    n = torch.distributed.get_world_size(group)
                    log.append((_op.strip("_"), tags.get(id(group), "?"),
                                (n - 1) * moved.numel()
                                * moved.element_size()))
                    return wrapped[_op](*args, **kw)

                setattr(D, op, spy)
            try:
                D.phi_mu_grid_owner(g, vals_cs, pi_cs, b_own, mesh=mesh)
            finally:
                for op, fn in wrapped.items():
                    setattr(D, op, fn)
            out[("collectives", name, mode)] = log
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
