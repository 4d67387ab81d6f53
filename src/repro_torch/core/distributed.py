"""Row-sharded multi-device Φ/MTTKRP and distributed CP-APR MU.

Two families, as in the JAX package's ``repro.core.distributed``:

* **The row-sharded tier** (``strategy="sharded"``): a blocked layout cut
  into contiguous row-block shards
  (:class:`repro_torch.core.layout.ShardedBlockedLayout`).  Each shard
  reduces its own slice of the sorted nonzero stream into its own padded
  row window (in the Φ kernel B2 or the MTTKRP kernel B3 on the card, or
  the plain blocked schedule), and one combine per call sums the windows:

    - ``"psum"``: an all-reduce of the whole ``(buf_rows, R)`` window;
      every shard holds the combined window and the MU epilogue runs
      replicated;
    - ``"reduce_scatter"``: a reduce-scatter over row-owner slots
      (:class:`repro_torch.core.layout.OwnerPartition`); each shard keeps
      only its owned O(I_n * R / S) slice, runs the MU/KKT epilogue on it,
      and the updated rows are gathered once per mode update.

  Shard windows overlap only on padding rows, which come back exactly
  zero, so both combines add exact zeros: they are bitwise equal to each
  other and to the one-device emulation in any summation order.

* **The N-D grid tier** (``strategy="grid"``): a row-shard split refined
  over an ``A x B`` device grid (:class:`repro_torch.core.layout.GridLayout`):
  each of the ``A`` row shards' nonzero streams is cut into ``B`` cells,
  each cell reduces a partial shard window (B2 or B3 on the card), and
  per inner iteration the column group all-gathers the B window and
  reduce-scatters the partial windows into each cell's owned
  (sub_rows, R) tile: O(I_n * R / A) wire per device.  There is no
  collective over the row group inside an inner iteration.

* **dist_cpapr_mu**: nonzeros split over the data axes, factor columns
  over ``"model"``; two collectives per inner iteration (the model-axis
  sum of the partial dot products, the data-axis sum of Φ).

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
JAX package's axis names: ``("data",)`` for the sharded tier,
``("row", "col")`` for the grid (:func:`make_grid_mesh`),
``("data", "model")`` or ``("pod", "data", "model")`` for
``dist_cpapr_mu``.  Every rank runs the same call on the same inputs and
keeps only its own shard (its rank in the data group), so the JAX
collectives map one to one: ``psum`` over the data axis is an
``all_reduce`` on the data group, ``psum_scatter(tiled=True)`` a
reduce-scatter into the rank's owner slot, ``pmax`` an ``all_reduce``
with ``MAX``.  Under a mesh an owner-stacked tensor holds only the
rank's own slot, shape ``(1, own_rows, R)``; :func:`owner_unstack`
gathers the slots.  ``mesh=None`` is the single-process emulation: the
same schedule as a loop over the shards on one device, each shard's
window added into one buffer at its row offset.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .layout import (
    GridLayout,
    OwnerPartition,
    ShardedBlockedLayout,
    ShardedPiGather,
    owner_partition,
    pad_rows,
)
from .pi import pi_rows_local
from .resilience import ShardAssignmentError
from .sparse_tensor import KTensor, SparseTensor, random_ktensor, sort_mode

__all__ = [
    "DistCPAPRConfig",
    "PHI_COMBINES",
    "dist_cpapr_mu",
    "grid_scatter_wire_bytes",
    "grid_stack",
    "grid_unstack",
    "krao_grid",
    "krao_sharded",
    "make_grid_mesh",
    "make_phi_mesh",
    "mesh_device_count",
    "owner_scatter_wire_bytes",
    "owner_stack",
    "owner_unstack",
    "phi_grid",
    "phi_grid_owner",
    "phi_mu_grid",
    "phi_mu_grid_owner",
    "phi_mu_sharded",
    "phi_mu_sharded_owner",
    "phi_sharded",
    "phi_sharded_owner",
    "preferred_combine",
    "shard_mode_views",
    "sharded_combine_bytes",
]

# Combine flavours of the sharded Φ/MTTKRP reduction (bitwise equal):
#   "psum"           — all-reduce the full (buf_rows, R) window; every
#                      shard holds the combined window.
#   "reduce_scatter" — reduce-scatter over row-owner slots; each shard
#                      keeps only its owned O(I_n*R/S) slice.
PHI_COMBINES = ("psum", "reduce_scatter")

# the shard-local compute flavours ("pallas" is the JAX package's name of
# the kernel route)
_LOCAL = {"blocked": "blocked", "cuda": "cuda", "pallas": "cuda"}


# ---------------------------------------------------------------------------
# Meshes and collectives
# ---------------------------------------------------------------------------


def mesh_device_count(mesh) -> int:
    """Total ranks in a mesh (product over every axis)."""
    return int(mesh.size())


def make_phi_mesh(n_shards: int, device_type: "str | None" = None):
    """1-D ``("data",)`` mesh over the ``n_shards`` ranks of the process
    group, which must be initialized with world size ``n_shards``.
    ``device_type`` defaults to ``"cuda"`` (NCCL); pass ``"cpu"`` for a
    ``gloo`` group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"n_shards={n_shards} needs an initialized torch.distributed "
            "process group (one rank per shard)")
    world = dist.get_world_size()
    if n_shards != world:
        raise ValueError(
            f"n_shards={n_shards} does not match the process group's world "
            f"size ({world}): exceeds or leaves out available ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", (int(n_shards),),
                            mesh_dim_names=("data",))


def _phi_group(mesh) -> tuple:
    """(process group, this rank's shard index) of a 1-D phi mesh."""
    if mesh.ndim != 1:
        raise ValueError(
            f"the sharded tier takes a 1-D ('data',) mesh, got "
            f"{mesh.ndim} axes {mesh.mesh_dim_names}")
    group = mesh.get_group(0)
    return group, dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    dist.all_reduce(x, op=op if op is not None else dist.ReduceOp.SUM,
                    group=group)
    return x


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # newer torch names it *_single and deprecates the *_tensor spelling
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def sharded_combine_bytes(slayout: ShardedBlockedLayout, rank: int,
                          itemsize: int = 4) -> int:
    """Bytes of the per-device all-reduce operand of the sharded combine."""
    return slayout.combine_bytes(rank, itemsize)


def _validate_phi_mesh(slayout: ShardedBlockedLayout, mesh) -> None:
    if mesh is None:
        return
    n_dev = mesh_device_count(mesh)
    if n_dev != slayout.n_shards:
        raise ValueError(
            f"mesh has {n_dev} devices but the layout has "
            f"{slayout.n_shards} shards"
        )


def _local_strategy(local_strategy: str) -> str:
    try:
        return _LOCAL[local_strategy]
    except KeyError:
        raise ValueError(
            f"unknown local strategy {local_strategy!r}; expected "
            f"'blocked' or 'cuda'") from None


# ---------------------------------------------------------------------------
# One shard's window
# ---------------------------------------------------------------------------


def _shard_window(slayout: ShardedBlockedLayout, eps: float,
                  local_strategy: str, vals_e, pi_e, local_rows, grid_rb,
                  b_win) -> torch.Tensor:
    """One shard's local output window (``n_rb_shard * block_rows``, R).

    ``local_strategy`` ``"cuda"`` runs the Φ kernel B2
    (:func:`repro_torch.kernels.phi.ops.phi_blocked_arrays`) or, with
    ``b_win=None`` (the plain Khatri-Rao sum), the MTTKRP kernel B3;
    ``"blocked"`` runs the plain blocked schedule.  Rows past the shard's
    real row-block count are visited only by padding slots, so they come
    back exactly zero: the invariant both combines rely on.
    """
    br = slayout.block_rows
    if local_strategy == "cuda":
        if b_win is None:
            from ..kernels.mttkrp import ops as mttkrp_ops

            return mttkrp_ops.mttkrp_blocked_arrays(
                grid_rb, vals_e, local_rows, pi_e,
                block_nnz=slayout.block_nnz, block_rows=br,
                n_rows_pad=slayout.win_rows)
        from ..kernels.phi import ops as phi_ops

        return phi_ops.phi_blocked_arrays(
            grid_rb, vals_e, local_rows, pi_e, b_win,
            block_nnz=slayout.block_nnz, block_rows=br, eps=eps)
    from .phi import _phi_blocked_core  # deferred: phi imports us lazily

    return _phi_blocked_core(
        vals_e, pi_e, local_rows, grid_rb, b_win,
        block_nnz=slayout.block_nnz, block_rows=br,
        n_row_blocks=slayout.n_rb_shard, eps=eps)


def _shard_inputs(slayout: ShardedBlockedLayout, vals_es, pi_es,
                  pig: "ShardedPiGather | None", factors, device):
    """``s -> (vals_e, pi_e)`` of shard ``s``.  With ``pig`` each shard
    builds its own Π rows from the factor rows it touches
    (:func:`repro_torch.core.pi.pi_rows_local`) and ``pi_es`` is unused."""
    if pig is None:
        return lambda s: (vals_es[s], pi_es[s])
    valid = slayout.on(device).valid
    touched, lidx = pig.on(device)

    def inputs(s):
        fg = [factors[m][touched[j][s]] for j, m in enumerate(pig.modes)]
        return vals_es[s], pi_rows_local(fg, [li[s] for li in lidx],
                                         valid[s])

    return inputs


def _window_fn(slayout: ShardedBlockedLayout, eps: float,
               local_strategy: str, inputs, b_of, device):
    """``s -> shard s's window``; ``b_of(s)`` is its B window (None for
    the plain reduction)."""
    st = slayout.on(device)

    def window(s):
        vals_e, pi_e = inputs(s)
        return _shard_window(slayout, eps, local_strategy, vals_e, pi_e,
                             st.local_rows[s], st.grid_rb[s], b_of(s))

    return window


def _row0(slayout: ShardedBlockedLayout, s: int) -> int:
    return int(slayout.rb_start[s]) * slayout.block_rows


def _psum_buf(slayout: ShardedBlockedLayout, window, mesh) -> torch.Tensor:
    """Combined (buf_rows, R) window, replicated on every shard.

    Emulated: each shard's window is added into one buffer at its row
    offset (windows overlap only on exact-zero padding rows, so this is
    bitwise the sum of zero-padded partials).  On a mesh: the rank's own
    window in a zero buffer, then one all-reduce over the data group.
    """
    wr = slayout.win_rows
    if mesh is None:
        buf = None
        for s in range(slayout.n_shards):
            win = window(s)
            if buf is None:
                buf = win.new_zeros((slayout.buf_rows, win.shape[1]))
            r0 = _row0(slayout, s)
            buf[r0:r0 + wr] += win
        return buf
    group, s = _phi_group(mesh)
    win = window(s)
    buf = win.new_zeros((slayout.buf_rows, win.shape[1]))
    r0 = _row0(slayout, s)
    buf[r0:r0 + wr] = win
    return _all_reduce(buf, group)


# ---------------------------------------------------------------------------
# Reduce-scatter epilogue over row-owner partitions
# ---------------------------------------------------------------------------


def owner_stack(opart: OwnerPartition, b: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Owner-stacked (S, own_rows, R) form of a full (n_rows, R) block.

    Pads ``b`` to the combine window, slices each owner's padded row
    window and masks rows owned by the *next* owner to zero (they only
    ever multiply padding slots, so Φ from the stacked form is bitwise Φ
    from the full window).  Under a mesh only this rank's slot comes
    back, shape (1, own_rows, R).
    """
    b_buf = pad_rows(b, opart.buf_rows)
    mask = opart.masks_on(b.device)
    if mesh is not None:
        _, s = _phi_group(mesh)
        s0 = int(opart.row_start[s])
        slot = b_buf[s0:s0 + opart.own_rows]
        return torch.where(mask[s][:, None], slot, slot.new_zeros(()))[None]
    slots = torch.stack([b_buf[int(s0):int(s0) + opart.own_rows]
                         for s0 in opart.row_start])
    return torch.where(mask[:, :, None], slots, slots.new_zeros(()))


def owner_unstack(opart: OwnerPartition, stacked: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Reassemble the full (n_rows, R) block from owner-stacked slices.

    The once-per-mode-update gather of the reduce-scatter epilogue: under
    a mesh ``stacked`` is this rank's (1, own_rows, R) slot and the slots
    are all-gathered over the data group first.  When every owner slot is
    its full padded width the slots tile the window and the reassembly is
    one reshape.
    """
    r = stacked.shape[-1]
    if mesh is not None:
        group, _ = _phi_group(mesh)
        full = stacked.new_empty((opart.n_shards * opart.own_rows, r))
        _all_gather(full, stacked.reshape(opart.own_rows, r).contiguous(),
                    group)
        stacked = full.reshape(opart.n_shards, opart.own_rows, r)
    if np.all(np.asarray(opart.row_count) == opart.own_rows):
        return stacked.reshape(opart.n_shards * opart.own_rows, r)[
            : opart.n_rows]
    out = stacked.new_zeros((opart.buf_rows, r))
    for s in range(opart.n_shards):
        cnt = int(opart.row_count[s])
        s0 = int(opart.row_start[s])
        out[s0:s0 + cnt] = stacked[s, :cnt]
    return out[: opart.n_rows]


def owner_scatter_wire_bytes(opart: OwnerPartition, rank: int,
                             itemsize: int = 4) -> float:
    """Per-device ring wire bytes of the reduce-scatter combine:
    ``(S-1) * own_rows * R`` elements (about half the all-reduce's)."""
    if opart.n_shards <= 1:
        return 0.0
    return float(
        (opart.n_shards - 1) * opart.own_rows * rank * itemsize
    )


def preferred_combine(slayout: ShardedBlockedLayout, rank: int,
                      itemsize: int = 4) -> str:
    """Wire-cheaper combine flavour for this layout's shard split.

    The reduce-scatter's owner slots are padded to the widest owner, so
    its ring wire is ``(S-1) * own_rows * R`` against the all-reduce's
    ``2 (S-1)/S * buf_rows * R``; a heavily block-skewed split can pad the
    slots past the all-reduce.  Ties go to reduce-scatter.
    """
    s = slayout.n_shards
    if s <= 1:
        return "reduce_scatter"
    opart = owner_partition(slayout)
    rs_wire = owner_scatter_wire_bytes(opart, rank, itemsize)
    psum_wire = 2.0 * (s - 1) / s * slayout.combine_bytes(rank, itemsize)
    return "reduce_scatter" if rs_wire <= psum_wire else "psum"


def _validate_owner(slayout: ShardedBlockedLayout, opart: OwnerPartition):
    """An owner partition built from one shard assignment must never run
    against another: its slices would silently cover the wrong rows."""
    if opart.n_shards != slayout.n_shards:
        raise ValueError(
            f"owner partition has {opart.n_shards} shards but the layout "
            f"has {slayout.n_shards}"
        )
    if opart.rb_start != tuple(int(x) for x in slayout.rb_start):
        raise ShardAssignmentError(
            "owner partition was built from a different shard assignment "
            f"(rb_start {opart.rb_start} vs "
            f"{tuple(int(x) for x in slayout.rb_start)}); rebuild it with "
            "owner_partition() after rebalancing"
        )


def _validate_pig(slayout: ShardedBlockedLayout, pig: ShardedPiGather):
    """A gather built from one shard assignment must never run against
    another: its index maps would silently point at the wrong rows."""
    if pig.rb_start != tuple(int(x) for x in slayout.rb_start):
        raise ShardAssignmentError(
            "pi_gather was built from a different shard assignment "
            f"(rb_start {pig.rb_start} vs "
            f"{tuple(int(x) for x in slayout.rb_start)}); rebuild it with "
            "build_shard_pi_gather after rebalancing"
        )


def _resolve_combine(combine: str) -> str:
    if combine not in PHI_COMBINES:
        raise ValueError(
            f"unknown combine {combine!r}; expected one of {PHI_COMBINES}"
        )
    return combine


def _resolve_owner(slayout: ShardedBlockedLayout,
                   owner: "OwnerPartition | None") -> OwnerPartition:
    if owner is None:
        return owner_partition(slayout)
    _validate_owner(slayout, owner)
    return owner


def _owner_combined(slayout: ShardedBlockedLayout, opart: OwnerPartition,
                    window, b_own, tol: float, mesh, fused: bool):
    """Reduce-scatter combine core: owner-stacked results, no replication.

    Each shard's window *is* its contribution to its own owner slot, so
    the combine is one reduce-scatter of the (S * own_rows, R) owner-slot
    operand: the rank writes its masked window at its slot and receives
    its owned slice.  Emulated, the masked windows are stacked.

    ``fused=False`` returns the owner-stacked combined window;
    ``fused=True`` runs the owner-local MU step and returns
    ``(b_own', viol)`` (the KKT max meets in an all-reduce with MAX).
    """
    if mesh is None:
        wins = [window(s) for s in range(slayout.n_shards)]
        stacked = torch.stack(wins)
        mask = opart.masks_on(stacked.device)
        owned = torch.where(mask[:, :, None], stacked, stacked.new_zeros(()))
        if not fused:
            return owned
        viol = torch.max(torch.abs(torch.minimum(b_own, 1.0 - owned)))
        return torch.where(viol > tol, b_own * owned, b_own), viol
    group, s = _phi_group(mesh)
    win = window(s)
    mask = opart.masks_on(win.device)
    win = torch.where(mask[s][:, None], win, win.new_zeros(()))
    own = opart.own_rows
    op = win.new_zeros((opart.n_shards * own, win.shape[1]))
    op[s * own:(s + 1) * own] = win
    owned = torch.empty_like(win)
    _reduce_scatter(owned, op, group)
    owned = owned[None]
    if not fused:
        return owned
    viol = torch.max(torch.abs(torch.minimum(b_own, 1.0 - owned)))
    viol = _all_reduce(viol.clone(), group, dist.ReduceOp.MAX)
    return torch.where(viol > tol, b_own * owned, b_own), viol


def _local_slot(opart: OwnerPartition, b_own: torch.Tensor, mesh):
    """Under a mesh, this rank's (1, own_rows, R) slot of ``b_own`` (given
    either as the full stack or as the slot itself)."""
    if mesh is None or b_own.shape[0] == 1:
        return b_own
    _, s = _phi_group(mesh)
    return b_own[s:s + 1]


def _owner_window(slayout, opart, eps, local_strategy, vals_es, pi_es,
                  pig, factors, b_own, mesh, plain):
    device = vals_es.device
    inputs = _shard_inputs(slayout, vals_es, pi_es, pig, factors, device)
    if plain:
        b_of = lambda s: None  # noqa: E731
    elif mesh is None:
        b_of = lambda s: b_own[s]  # noqa: E731
    else:
        b_of = lambda s: b_own[0]  # noqa: E731  (this rank's own slot)
    return _window_fn(slayout, eps, local_strategy, inputs, b_of, device)


def _check_pig(slayout, pig, factors):
    if pig is not None:
        _validate_pig(slayout, pig)
        if factors is None:
            raise ValueError("pi_gather needs the full factors tuple")


# ---------------------------------------------------------------------------
# Public sharded entry points
# ---------------------------------------------------------------------------


def phi_sharded(slayout: ShardedBlockedLayout, vals_es, pi_es, b,
                eps: float = 1e-10, mesh=None,
                local_strategy: str = "blocked",
                pi_gather: "ShardedPiGather | None" = None, factors=None,
                combine: str = "psum",
                owner: "OwnerPartition | None" = None) -> torch.Tensor:
    """Φ^(n) over row-block shards: (n_rows, R).

    Inputs from :func:`repro_torch.core.phi.expand_to_shards`, or, with
    ``pi_gather``/``factors``, shard-locally computed Π rows (``pi_es``
    unused; ``vals_es`` from ``expand_vals_to_shards``).
    ``combine="reduce_scatter"`` scatters the combine over row-owner
    slots (the full result is reassembled here); ``owner`` pins the owner
    partition, which must match the layout's shard assignment.
    """
    _validate_phi_mesh(slayout, mesh)
    if _resolve_combine(combine) == "reduce_scatter":
        opart = _resolve_owner(slayout, owner)
        stacked = phi_sharded_owner(
            slayout, opart, vals_es, pi_es, owner_stack(opart, b, mesh),
            eps=eps, mesh=mesh, local_strategy=local_strategy,
            pi_gather=pi_gather, factors=factors)
        return owner_unstack(opart, stacked, mesh)
    return _phi_buf(slayout, vals_es, pi_es, b, eps, mesh, local_strategy,
                    pi_gather, factors)[: slayout.n_rows]


def krao_sharded(slayout: ShardedBlockedLayout, vals_es, kr_es, mesh=None,
                 local_strategy: str = "blocked",
                 pi_gather: "ShardedPiGather | None" = None, factors=None,
                 combine: str = "psum",
                 owner: "OwnerPartition | None" = None) -> torch.Tensor:
    """Sharded plain Khatri-Rao reduction (MTTKRP) with one combine: the
    machinery of :func:`phi_sharded` without the model weighting (B3 per
    shard on the card).  With ``pi_gather``/``factors`` the Khatri-Rao
    rows are computed shard-locally and ``kr_es`` is unused."""
    _validate_phi_mesh(slayout, mesh)
    local_strategy = _local_strategy(local_strategy)
    _check_pig(slayout, pi_gather, factors)
    if _resolve_combine(combine) == "reduce_scatter":
        opart = _resolve_owner(slayout, owner)
        window = _owner_window(slayout, opart, 0.0, local_strategy, vals_es,
                               kr_es, pi_gather, factors, None, mesh, True)
        stacked = _owner_combined(slayout, opart, window, None, 0.0, mesh,
                                  False)
        return owner_unstack(opart, stacked, mesh)
    inputs = _shard_inputs(slayout, vals_es, kr_es, pi_gather, factors,
                           vals_es.device)
    window = _window_fn(slayout, 0.0, local_strategy, inputs,
                        lambda s: None, vals_es.device)
    return _psum_buf(slayout, window, mesh)[: slayout.n_rows]


def phi_mu_sharded(slayout: ShardedBlockedLayout, vals_es, pi_es, b,
                   eps: float = 1e-10, tol: float = 1e-4, mesh=None,
                   local_strategy: str = "blocked",
                   pi_gather: "ShardedPiGather | None" = None, factors=None,
                   combine: str = "psum",
                   owner: "OwnerPartition | None" = None) -> tuple:
    """Fused sharded MU step ``(B', viol)``, psum or reduce-scatter combine.

    ``"psum"``: all-reduce the full window, replicated epilogue.
    ``"reduce_scatter"``: owner-sliced combine and owner-local epilogue,
    the full B' reassembled here (the solver's inner loop keeps the
    owner-stacked carry instead, :func:`phi_mu_sharded_owner`).  The
    combine buffer's padding rows hold B = Φ = 0: they add nothing to the
    KKT max or to ``B * Φ``.
    """
    from .phi import _mu_epilogue  # deferred: phi imports us lazily

    _validate_phi_mesh(slayout, mesh)
    if _resolve_combine(combine) == "reduce_scatter":
        opart = _resolve_owner(slayout, owner)
        b_own, viol = phi_mu_sharded_owner(
            slayout, opart, vals_es, pi_es, owner_stack(opart, b, mesh),
            eps=eps, tol=tol, mesh=mesh, local_strategy=local_strategy,
            pi_gather=pi_gather, factors=factors)
        return owner_unstack(opart, b_own, mesh), viol
    phi_buf = _phi_buf(slayout, vals_es, pi_es, b, eps, mesh,
                       local_strategy, pi_gather, factors)
    b_new, viol = _mu_epilogue(pad_rows(b, slayout.buf_rows), phi_buf, tol)
    return b_new[: slayout.n_rows], viol


def _phi_buf(slayout, vals_es, pi_es, b, eps, mesh, local_strategy,
             pi_gather, factors) -> torch.Tensor:
    """The combined (buf_rows, R) Φ window of the psum path."""
    local_strategy = _local_strategy(local_strategy)
    _check_pig(slayout, pi_gather, factors)
    inputs = _shard_inputs(slayout, vals_es, pi_es, pi_gather, factors,
                           b.device)
    b_buf = pad_rows(b, slayout.buf_rows)
    wr = slayout.win_rows
    window = _window_fn(slayout, float(eps), local_strategy, inputs,
                        lambda s: b_buf[_row0(slayout, s):
                                        _row0(slayout, s) + wr], b.device)
    return _psum_buf(slayout, window, mesh)


def phi_sharded_owner(slayout: ShardedBlockedLayout, opart: OwnerPartition,
                      vals_es, pi_es, b_own, eps: float = 1e-10, mesh=None,
                      local_strategy: str = "blocked",
                      pi_gather: "ShardedPiGather | None" = None,
                      factors=None) -> torch.Tensor:
    """Owner-stacked combined Φ (reduce-scatter combine, no reassembly).
    ``b_own`` is the owner-stacked B (:func:`owner_stack`); the solver's
    scooch step consumes this form directly."""
    _validate_phi_mesh(slayout, mesh)
    opart = _resolve_owner(slayout, opart)
    _check_pig(slayout, pi_gather, factors)
    b_own = _local_slot(opart, b_own, mesh)
    window = _owner_window(slayout, opart, float(eps),
                           _local_strategy(local_strategy), vals_es, pi_es,
                           pi_gather, factors, b_own, mesh, False)
    return _owner_combined(slayout, opart, window, b_own, 0.0, mesh, False)


def phi_mu_sharded_owner(slayout: ShardedBlockedLayout,
                         opart: OwnerPartition, vals_es, pi_es, b_own,
                         eps: float = 1e-10, tol: float = 1e-4, mesh=None,
                         local_strategy: str = "blocked",
                         pi_gather: "ShardedPiGather | None" = None,
                         factors=None) -> tuple:
    """Owner-partitioned fused MU step: ``(b_own', viol)``, no gather.

    The loop-carry form of the reduce-scatter epilogue: one reduce-scatter
    over owner slots per call, the MU/KKT epilogue on owned rows only.
    The solver carries ``b_own`` across inner iterations and reassembles
    the factor once per mode update with :func:`owner_unstack`.
    """
    _validate_phi_mesh(slayout, mesh)
    opart = _resolve_owner(slayout, opart)
    _check_pig(slayout, pi_gather, factors)
    b_own = _local_slot(opart, b_own, mesh)
    window = _owner_window(slayout, opart, float(eps),
                           _local_strategy(local_strategy), vals_es, pi_es,
                           pi_gather, factors, b_own, mesh, False)
    return _owner_combined(slayout, opart, window, b_own, float(tol), mesh,
                           True)


# ---------------------------------------------------------------------------
# N-D grid combine: all-gather + reduce-scatter over the column axis
# ---------------------------------------------------------------------------


def make_grid_mesh(grid_a: int, grid_b: int,
                   device_type: "str | None" = None):
    """2-D ``("row", "col")`` mesh over the ``A*B`` ranks of the process
    group, which must be initialized with world size ``A*B``.  Rank ``r``
    holds grid cell ``r = s*B + c``, the row-major flat order of every
    ``(A*B, ...)`` cell array.  ``device_type`` defaults to ``"cuda"``
    (NCCL); pass ``"cpu"`` for a ``gloo`` group."""
    a, b = int(grid_a), int(grid_b)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"grid {a}x{b} needs an initialized torch.distributed process "
            "group (one rank per grid cell)")
    world = dist.get_world_size()
    if a * b != world:
        raise ValueError(
            f"grid {a}x{b} needs {a * b} ranks, the process group has "
            f"{world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", (a, b),
                            mesh_dim_names=("row", "col"))


def _validate_grid_mesh(glayout: GridLayout, mesh) -> None:
    if mesh is None:
        return
    names = tuple(mesh.mesh_dim_names or ())
    if names != ("row", "col"):
        raise ValueError(
            f"grid mesh must have axes ('row', 'col'), got {names}")
    shape = (int(mesh.size(0)), int(mesh.size(1)))
    if shape != (glayout.grid_a, glayout.grid_b):
        raise ValueError(
            f"mesh shape {shape} does not match the layout's grid "
            f"{(glayout.grid_a, glayout.grid_b)}")
    if mesh_device_count(mesh) != dist.get_world_size():
        raise ValueError(
            f"the grid mesh covers {mesh_device_count(mesh)} of the process "
            f"group's {dist.get_world_size()} ranks; its KKT max needs all")


def _grid_cell(glayout: GridLayout, mesh) -> tuple:
    """(column group, row group, this rank's flat cell index) on a grid
    mesh."""
    s = mesh.get_local_rank("row")
    c = mesh.get_local_rank("col")
    return (mesh.get_group("col"), mesh.get_group("row"),
            s * glayout.grid_b + c)


def grid_stack(glayout: GridLayout, b: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """Grid-stacked (A*B, sub_rows, R) form of a full (n_rows, R) block.

    Cell ``(s, c)`` owns rows ``[row_start[s] + c*sub_rows, +sub_rows)``
    of the combine window; rows past its shard's real count are masked to
    zero (they only ever multiply padding slots), as :func:`owner_stack`
    masks them.  Under a mesh only this rank's cell comes back, shape
    (1, sub_rows, R).
    """
    opart = owner_partition(glayout.slayout)
    b_buf = pad_rows(b, glayout.stack_rows)
    mask = glayout.masks_on(b.device)[0]
    sub = glayout.sub_rows
    if mesh is not None:
        _, _, f = _grid_cell(glayout, mesh)
        s, c = divmod(f, glayout.grid_b)
        r0 = int(opart.row_start[s]) + c * sub
        cell = b_buf[r0:r0 + sub]
        return torch.where(mask[f][:, None], cell, cell.new_zeros(()))[None]
    slots = torch.stack([b_buf[int(s0):int(s0) + glayout.own_rows_pad]
                         for s0 in opart.row_start])
    cells = slots.reshape(glayout.n_shards, sub, b.shape[-1])
    return torch.where(mask[:, :, None], cells, cells.new_zeros(()))


def grid_unstack(glayout: GridLayout, stacked: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Reassemble the full (n_rows, R) block from grid-stacked slices.

    The once-per-mode-update factor gather of the grid epilogue: under a
    mesh ``stacked`` is this rank's (1, sub_rows, R) cell, gathered over
    the column group into its shard's window and then over the row group
    into the whole block.
    """
    opart = owner_partition(glayout.slayout)
    r = stacked.shape[-1]
    pad = glayout.own_rows_pad
    if mesh is not None:
        col_group, row_group, _ = _grid_cell(glayout, mesh)
        window = stacked.new_empty((pad, r))
        _all_gather(window, stacked.reshape(glayout.sub_rows, r).contiguous(),
                    col_group)
        stacked = stacked.new_empty((glayout.grid_a * pad, r))
        _all_gather(stacked, window, row_group)
    shards = stacked.reshape(glayout.grid_a, pad, r)
    if pad == opart.own_rows and np.all(np.asarray(opart.row_count)
                                        == opart.own_rows):
        return shards.reshape(glayout.grid_a * pad, r)[: opart.n_rows]
    out = stacked.new_zeros((glayout.stack_rows, r))
    for s in range(glayout.grid_a):
        cnt = int(opart.row_count[s])
        s0 = int(opart.row_start[s])
        out[s0:s0 + cnt] = shards[s, :cnt]
    return out[: opart.n_rows]


def grid_scatter_wire_bytes(glayout: GridLayout, rank: int,
                            itemsize: int = 4) -> float:
    """Per-device ring wire bytes of one grid combine iteration: the
    all-gather of the (own_rows_pad, R) B window plus the reduce-scatter
    of the combined window over the column axis, ``2 (B-1) * sub_rows *
    R`` elements: O(I_n * R / A) instead of the 1-D O(I_n * R)."""
    if glayout.grid_b <= 1:
        return 0.0
    return float(
        2 * (glayout.grid_b - 1) * glayout.sub_rows * rank * itemsize)


def _grid_combined(glayout: GridLayout, vals_cs, pi_cs, b_own, eps: float,
                   tol: float, mesh, local_strategy: str, fused: bool,
                   plain: bool):
    """Grid combine core: column all-gather + reduce-scatter.

    Each cell reduces its slice of its shard's nonzero stream into a
    *partial* shard window (B2, or B3 for ``plain``, on the card); the
    column reduce-scatter sums the ``B`` partials and hands each cell its
    owned (sub_rows, R) tile.  The B window is rebuilt from the column's
    carry tiles by an all-gather.  No row-axis collective exists: shard
    windows never overlap on real rows.

    ``fused=False`` returns the grid-stacked combined window; ``plain``
    drops the model weighting (MTTKRP, ``b_own`` None).  ``fused=True``
    runs the owner-local MU step and returns ``(b_own', viol)``, the KKT
    max met in one all-reduce with MAX over the whole mesh.  Without a
    mesh the same schedule runs on one device, summing each column's
    partials in cell order: bitwise the ring reduce-scatter at B <= 2
    (two addends commute), equal up to summation order beyond.  Under a
    mesh ``b_own`` and the result are this rank's (1, sub_rows, R) cell;
    ``vals_cs``/``pi_cs`` hold every cell, and the rank reads its own.
    """
    slayout = glayout.slayout
    bdim, sub = glayout.grid_b, glayout.sub_rows
    pad = glayout.own_rows_pad
    own_rows = owner_partition(slayout).own_rows
    device = vals_cs.device
    st = glayout.on(device)
    smask = glayout.masks_on(device)[1]

    def window(f, b_win):
        win = _shard_window(slayout, eps, local_strategy, vals_cs[f],
                            pi_cs[f], st.local_rows[f], st.grid_rb[f], b_win)
        return pad_rows(torch.where(smask[f][:, None], win,
                                    win.new_zeros(())), pad)

    if mesh is None:
        parts = []
        for s in range(glayout.grid_a):
            b_win = None if plain else \
                b_own[s * bdim:(s + 1) * bdim].reshape(pad, -1)[:own_rows]
            win = None
            for c in range(bdim):
                w = window(s * bdim + c, b_win)
                win = w if win is None else win + w
            parts.append(win.reshape(bdim, sub, -1))
        stacked = torch.cat(parts)
        if not fused:
            return stacked
        viol = torch.max(torch.abs(torch.minimum(b_own, 1.0 - stacked)))
        return torch.where(viol > tol, b_own * stacked, b_own), viol

    col_group, _, f = _grid_cell(glayout, mesh)
    b_c = None
    b_win = None
    if not plain:
        b_c = b_own if b_own.shape[0] == 1 else b_own[f:f + 1]
        b_full = b_c.new_empty((pad, b_c.shape[-1]))
        _all_gather(b_full, b_c[0].contiguous(), col_group)
        b_win = b_full[:own_rows]
    win = window(f, b_win)
    owned = win.new_empty((sub, win.shape[1]))
    _reduce_scatter(owned, win.contiguous(), col_group)
    owned = owned[None]
    if not fused:
        return owned
    viol = torch.max(torch.abs(torch.minimum(b_c, 1.0 - owned)))
    viol = _all_reduce(viol.clone(), None, dist.ReduceOp.MAX)
    return torch.where(viol > tol, b_c * owned, b_c), viol


def phi_grid(glayout: GridLayout, vals_cs, pi_cs, b, eps: float = 1e-10,
             mesh=None, local_strategy: str = "blocked") -> torch.Tensor:
    """Φ^(n) over an ``A x B`` nonzero grid: (n_rows, R).  Inputs from
    :func:`repro_torch.core.phi.expand_to_grid`; the combine is the column
    all-gather + reduce-scatter pair, and the full result is reassembled
    here."""
    _validate_grid_mesh(glayout, mesh)
    stacked = _grid_combined(glayout, vals_cs, pi_cs,
                             grid_stack(glayout, b, mesh), float(eps), 0.0,
                             mesh, _local_strategy(local_strategy), False,
                             False)
    return grid_unstack(glayout, stacked, mesh)


def krao_grid(glayout: GridLayout, vals_cs, kr_cs, mesh=None,
              local_strategy: str = "blocked") -> torch.Tensor:
    """Grid-partitioned plain Khatri-Rao reduction (MTTKRP): the cells of
    :func:`phi_grid` without the model weighting (B3 once per cell on the
    card), so the all-gather drops out and only the column reduce-scatter
    remains."""
    _validate_grid_mesh(glayout, mesh)
    stacked = _grid_combined(glayout, vals_cs, kr_cs, None, 0.0, 0.0, mesh,
                             _local_strategy(local_strategy), False, True)
    return grid_unstack(glayout, stacked, mesh)


def phi_mu_grid(glayout: GridLayout, vals_cs, pi_cs, b, eps: float = 1e-10,
                tol: float = 1e-4, mesh=None,
                local_strategy: str = "blocked") -> tuple:
    """Fused grid MU step ``(B', viol)`` on the full factor.  The masked
    rows hold B = Φ = 0: they add nothing to the KKT max or to ``B * Φ``.
    The solver's inner loop keeps the grid-stacked carry instead
    (:func:`phi_mu_grid_owner`)."""
    _validate_grid_mesh(glayout, mesh)
    b_own, viol = _grid_combined(glayout, vals_cs, pi_cs,
                                 grid_stack(glayout, b, mesh), float(eps),
                                 float(tol), mesh,
                                 _local_strategy(local_strategy), True, False)
    return grid_unstack(glayout, b_own, mesh), viol


def phi_grid_owner(glayout: GridLayout, vals_cs, pi_cs, b_own,
                   eps: float = 1e-10, mesh=None,
                   local_strategy: str = "blocked") -> torch.Tensor:
    """Grid-stacked combined Φ (A*B, sub_rows, R), not reassembled;
    ``b_own`` is the grid-stacked B (:func:`grid_stack`).  The solver's
    scooch step consumes this form."""
    _validate_grid_mesh(glayout, mesh)
    return _grid_combined(glayout, vals_cs, pi_cs, b_own, float(eps), 0.0,
                          mesh, _local_strategy(local_strategy), False, False)


def phi_mu_grid_owner(glayout: GridLayout, vals_cs, pi_cs, b_own,
                      eps: float = 1e-10, tol: float = 1e-4, mesh=None,
                      local_strategy: str = "blocked") -> tuple:
    """Grid-partitioned fused MU step ``(b_own', viol)``, no gather: the
    loop-carry form of the grid epilogue.  The solver carries the
    grid-stacked tiles across inner iterations and reassembles the factor
    once per mode update with :func:`grid_unstack`."""
    _validate_grid_mesh(glayout, mesh)
    return _grid_combined(glayout, vals_cs, pi_cs, b_own, float(eps),
                          float(tol), mesh, _local_strategy(local_strategy),
                          True, False)


# ---------------------------------------------------------------------------
# Distributed CP-APR MU (nonzeros over data, factor columns over model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistCPAPRConfig:
    rank: int
    max_outer: int = 10
    max_inner: int = 5
    tol: float = 1e-4
    eps: float = 1e-10
    kappa: float = 1e-2
    kappa_tol: float = 1e-10


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def _axis_size(mesh, name: str) -> int:
    names = _axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def _data_index(mesh) -> tuple:
    """(this rank's linear index over the data axes, their total size)."""
    idx, size = 0, 1
    for a in _data_axes(mesh):
        n = _axis_size(mesh, a)
        idx = idx * n + mesh.get_local_rank(a)
        size *= n
    return idx, size


def shard_mode_views(t: SparseTensor, mesh) -> list:
    """Per-mode sorted views padded to the data-axes size.

    Padding slots have value 0 and row I_n (reduced into a dump row that
    is sliced off), so they contribute nothing.  ``mesh=None`` is one
    device.
    """
    n_shards = _data_index(mesh)[1] if mesh is not None else 1
    dev = t.device
    out = []
    for n in range(t.ndim):
        mv = sort_mode(t, n)
        nnz = mv.nnz
        pad = (-nnz) % n_shards
        rows = torch.cat([mv.rows.to(torch.int64),
                          torch.full((pad,), t.shape[n], dtype=torch.int64,
                                     device=dev)])
        idx = torch.cat([mv.sorted_idx.to(torch.int64),
                         torch.zeros((pad, t.ndim), dtype=torch.int64,
                                     device=dev)])
        vals = torch.cat([mv.sorted_vals, mv.sorted_vals.new_zeros((pad,))])
        out.append({"rows": rows, "idx": idx, "vals": vals,
                    "n_rows": t.shape[n]})
    return out


def _mode_update_dist(mesh, cfg: DistCPAPRConfig, n: int, n_rows: int,
                      n_modes: int):
    """The per-mode MU solve on this rank's nonzero slice and factor
    columns: ``(rows, idx, vals, factors, lam) -> (A_n', lam', viol,
    n_inner)``.  Two collectives per inner iteration: the model-axis sum
    of the partial dot products and the data-axes sum of Φ (each a no-op
    without a mesh)."""
    model_group = (mesh.get_group("model")
                   if "model" in _axis_names(mesh) else None)
    data_groups = [mesh.get_group(a) for a in _data_axes(mesh)] \
        if mesh is not None else []

    def psum_model(x):
        return _all_reduce(x, model_group) if model_group is not None else x

    def psum_data(x):
        for g in data_groups:
            x = _all_reduce(x, g)
        return x

    def pmax_all(x):
        if model_group is not None:
            x = _all_reduce(x, model_group, dist.ReduceOp.MAX)
        for g in data_groups:
            x = _all_reduce(x, g, dist.ReduceOp.MAX)
        return x

    def update(rows, idx, vals, factors, lam):
        a_n = factors[n]
        pi = torch.ones((idx.shape[0], a_n.shape[1]), dtype=a_n.dtype,
                        device=a_n.device)
        for m in range(n_modes):
            if m != n:
                pi = pi * factors[m][idx[:, m]]
        rows_c = torch.clamp_max(rows, n_rows - 1)

        def phi_of(b):
            s = psum_model(torch.sum(b[rows_c] * pi, dim=1))  # full-R dot
            w = torch.where(vals > 0, vals / torch.clamp_min(s, cfg.eps),
                            vals.new_zeros(()))
            phi = torch.zeros((n_rows + 1, pi.shape[1]), dtype=pi.dtype,
                              device=pi.device)  # +1 dump row for padding
            phi.index_add_(0, rows, w[:, None] * pi)
            return psum_data(phi[:n_rows].contiguous())

        phi0 = phi_of(a_n * lam[None, :])
        s_fix = torch.where((a_n < cfg.kappa_tol) & (phi0 > 1.0),
                            torch.full_like(a_n, cfg.kappa),
                            torch.zeros_like(a_n))
        b = (a_n + s_fix) * lam[None, :]
        i, viol = 0, math.inf
        while i < cfg.max_inner and viol > cfg.tol:
            phi = phi_of(b)
            v = pmax_all(torch.max(torch.abs(torch.minimum(b, 1.0 - phi))))
            viol = float(v)  # host sync: decides the next iteration
            if viol > cfg.tol:
                b = b * phi
            i += 1
        lam_new = torch.sum(b, dim=0)  # this rank's columns
        a_new = b / torch.clamp_min(lam_new, cfg.eps)
        return a_new, lam_new, viol, i

    return update


def _validate_dist_mesh(t: SparseTensor, rank: int, mesh):
    """Validate shardability; fall back to one device with a warning.

    A model axis that does not divide the rank, or more data shards than
    nonzeros, falls back: the returned mesh is then ``None`` and every
    rank runs the whole solve on its own device, without collectives.
    """
    problems = []
    model = _axis_size(mesh, "model")
    if model > 1 and rank % model:
        problems.append(f"rank={rank} not divisible by model axis ({model})")
    n_data = _data_index(mesh)[1]
    if n_data > max(1, t.nnz):
        problems.append(f"{n_data} data shards exceed nnz={t.nnz}")
    if problems:
        warnings.warn(
            "dist_cpapr_mu: " + "; ".join(problems) +
            "; falling back to a single-device mesh",
            stacklevel=3,
        )
        return None
    return mesh


def dist_cpapr_mu(t: SparseTensor, rank: int, mesh, seed: "int | None" = None,
                  init: "KTensor | None" = None,
                  config: "DistCPAPRConfig | None" = None,
                  device="cuda") -> tuple:
    """Distributed CP-APR MU over a ``("data", "model")`` or ``("pod",
    "data", "model")`` :class:`DeviceMesh`.  Returns ``(KTensor,
    kkt_history)``, the KTensor whole on every rank.

    Every rank calls it with the same ``t`` and ``init`` and keeps its
    slice of the nonzero stream (its index over the data axes) and its
    columns of the factors (its index on ``"model"``).
    """
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = config or DistCPAPRConfig(rank=rank)
    mesh = _validate_dist_mesh(t, rank, mesh)
    t = t.to(dev)
    n_modes = t.ndim
    if init is None:
        init = random_ktensor(t.shape, rank, seed=0 if seed is None else seed,
                              device=dev)
    kt = init.to(dev).normalize()

    views = shard_mode_views(t, mesh)
    d_idx, n_data = _data_index(mesh) if mesh is not None else (0, 1)
    model = _axis_size(mesh, "model")
    m_idx = mesh.get_local_rank("model") if model > 1 else 0
    r_loc = rank // model
    cols = slice(m_idx * r_loc, (m_idx + 1) * r_loc)
    factors = [f[:, cols].contiguous() for f in kt.factors]
    lam = kt.lam[cols].contiguous()
    local = []
    for v in views:
        per = v["rows"].shape[0] // n_data
        sl = slice(d_idx * per, (d_idx + 1) * per)
        local.append((v["rows"][sl], v["idx"][sl], v["vals"][sl]))

    updates = [_mode_update_dist(mesh, cfg, n, t.shape[n], n_modes)
               for n in range(n_modes)]
    kkt_hist = []
    for _ in range(cfg.max_outer):
        worst = 0.0
        for n in range(n_modes):
            rows, idx, vals = local[n]
            a_new, lam, viol, _ = updates[n](rows, idx, vals, factors, lam)
            factors[n] = a_new
            worst = max(worst, viol)
        kkt_hist.append(worst)
        if worst <= cfg.tol:
            break
    if model > 1:
        group = mesh.get_group("model")
        factors = [_gather_columns(f, model, group) for f in factors]
        lam = _gather_columns(lam[None, :], model, group)[0]
    return KTensor(lam=lam, factors=tuple(factors)), kkt_hist


def _gather_columns(x: torch.Tensor, model: int, group) -> torch.Tensor:
    """(I, R/model) column blocks of the model group -> (I, R)."""
    full = x.new_empty((model * x.shape[1], x.shape[0]))
    _all_gather(full, x.T.contiguous(), group)
    return full.T.contiguous()
