"""Φ^(n) kernel: the CP-APR MU hot spot (paper Fig. 2).

    Φ^(n) = (X_(n) (/) max(B Π, eps)) Π^T        (Alg. 2)

computed one nonzero at a time (never materializing X_(n) or Π):

    s_j   = <B[i_j, :], pi[j, :]>          # model value at nonzero j
    w_j   = x_j / max(s_j, eps)
    Φ[i_j, :] += w_j * pi[j, :]            # reduction by row -> conflicts

Strategies:

  * ``scatter``  — ``index_add_`` on the nonzeros in any order: the
    paper's GPU Alg. 3 (atomic per nonzero).
  * ``segment``  — ``index_add_`` on the sorted stream: the paper's CPU
    Alg. 4 ordering.
  * ``blocked``  — a plain torch emulation of the blocked schedule: per
    grid step partial windows, combined over the steps of a row block.
  * ``cuda``     — the blocked schedule in the hand-written Hopper kernels
    (:mod:`repro_torch.kernels.phi`).  ``"pallas"`` is read as an alias,
    so stored policies of the JAX package carry over.  On CPU tensors the
    kernel wrapper computes its plain version.
  * ``dense``    — the matrix-free tier for near-dense modes: the mode's
    densified (K, I, J) tensor (:mod:`repro_torch.core.dense`) is
    contracted against factor tiles in the dense kernels
    (:mod:`repro_torch.kernels.dense`), never building Π.
  * ``sharded``  — contiguous row-block shards of the blocked schedule
    (a :class:`repro_torch.core.layout.ShardedBlockedLayout`), each
    reduced by ``local_strategy`` (``blocked``, or ``cuda``: the kernels
    B2/B3 once per shard) and summed by one combine (``combine="psum"``
    or ``"reduce_scatter"``): over a ``torch.distributed`` mesh
    (``mesh=``), else emulated on one device
    (:mod:`repro_torch.core.distributed`).  With ``pi_gather``/``factors``
    each shard builds its own Π rows from the factor rows it touches.
  * ``grid``     — the row shards refined over an ``A x B`` device grid
    (a :class:`repro_torch.core.layout.GridLayout`): each shard's nonzero
    stream is cut into ``B`` cells, each cell reduced by
    ``local_strategy`` (B2/B3 once per cell for ``cuda``), and the cells
    meet in the column all-gather + reduce-scatter pair
    (:func:`repro_torch.core.distributed.phi_grid`).  A grid the mode
    cannot honour warns and runs ``local_strategy`` unsharded.

:func:`krao_reduce_rows` is the same reduction without the model divide
(MTTKRP, CP-ALS's hot spot) through the same strategies; its ``cuda``
route is the MTTKRP kernel (:mod:`repro_torch.kernels.mttkrp`).

PPA perturbations (paper Sec. 3.3), via ``perturb`` (plain strategies
only; wrong on purpose, for benchmarks):

  * ``no_conflict``   — drop the keyed reduction (uniform-segment sum).
  * ``perfect_reuse`` — clamp every gather index to row 0.

:func:`phi_mu_step` is the fused inner step — Φ, the KKT check and
``B <- B*Φ`` (applied only while viol > tol) — for every strategy.
``vals_e``/``pi_e`` accept pre-expanded layout tensors.

:func:`bind_mode` is where a mode's kernel family is decided: once, from
the strategy, the layout's type and the effective combine.  It returns
the mode's :class:`ModeOps` (its hoisted inputs, Φ, fused step, MTTKRP
and the carry's stack/unstack), which both solvers run and the three
public entries above call after resolving their per-call layout.
"""
from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import check_on_device, resolve_device
from . import distributed
from .dense import DenseModeData, build_dense_mode, dense_kr_factors
from .layout import (
    BlockedLayout,
    GridLayout,
    ShardedBlockedLayout,
    build_blocked_layout,
    build_grid_layout,
    choose_grid_shape,
    mode_run_stats,
    owner_partition,
    pad_rows,
    shard_blocked_layout,
)
from .pi import pi_rows
from .policy import default_policy, heuristic_policy
from .sparse_tensor import ModeView

__all__ = [
    "ALL_PHI_STRATEGIES",
    "PHI_STRATEGIES",
    "ModeOps",
    "bind_mode",
    "canonical_strategy",
    "effective_mode_combine",
    "expand_to_grid",
    "expand_to_layout",
    "expand_to_shards",
    "expand_vals_to_shards",
    "krao_reduce_rows",
    "phi_flops_words",
    "phi_from_rows",
    "phi_mode",
    "phi_mu_step",
    "resolve_combine",
]

PHI_STRATEGIES = ("scatter", "segment", "blocked", "cuda", "dense")
# "sharded": the blocked schedule over row-block shards with one combine;
# "grid": the same over an (A x B) device grid.  Both run over a mesh or
# emulated on one device (core/distributed.py).
ALL_PHI_STRATEGIES = PHI_STRATEGIES + ("sharded", "grid")
_ALIASES = {"pallas": "cuda"}


def canonical_strategy(strategy: str) -> str:
    """Map an alias (``"pallas"``) to the port's strategy name and reject
    unknown ones."""
    s = _ALIASES.get(strategy, strategy)
    if s not in ALL_PHI_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    return s


# ---------------------------------------------------------------------------
# Roofline operation counts (paper Eqs. 3-8)
# ---------------------------------------------------------------------------


def phi_flops_words(nnz: int, rank: int, variant: str = "gpu", v: int = 32) -> tuple:
    """(W FLOPs, Q words) for Φ^(n), per paper Eqs. 3-4 / 6-7.

    ``variant='gpu'``: W = nnz(4R+2), Q = nnz(5R+2)   -> I = 0.125 @ R->inf
    ``variant='cpu'``: W = nnz(4R+R/V+3), Q = nnz(6R+2R/V+3) -> I ~ 0.27
    """
    if variant == "gpu":
        return nnz * (4 * rank + 2), nnz * (5 * rank + 2)
    if variant == "cpu":
        w = nnz * (4 * rank + rank / v + 3)
        q = nnz * (6 * rank + 2 * rank / v + 3)
        return w, q
    raise ValueError(variant)


# ---------------------------------------------------------------------------
# Plain strategies
# ---------------------------------------------------------------------------


def _uniform_segment_sum(contrib: torch.Tensor, n_rows: int) -> torch.Tensor:
    """PPA 'no_conflict': keep the FLOPs/stream, drop the keyed reduce."""
    nnz, r = contrib.shape
    group = max(1, -(-nnz // n_rows))  # ceil
    pad = group * n_rows - nnz
    c = torch.cat([contrib, contrib.new_zeros((pad, r))])
    return c.reshape(n_rows, group, r).sum(dim=1)


def _index_add_rows(rows, contrib, n_rows: int, strategy: str,
                    rows_dtype: torch.dtype) -> torch.Tensor:
    """``out[rows[j]] += contrib[j]`` in the result dtype of the JAX
    package's strategy: ``scatter`` adds into a buffer of the gathered
    rows' dtype (``jnp.zeros(.., pi.dtype).at[rows].add``, so mixed bf16
    rows and f32 values give bf16), ``segment`` keeps the contributions'
    promoted dtype (``segment_sum``: f32 there)."""
    dt = rows_dtype if strategy == "scatter" else contrib.dtype
    out = torch.zeros((n_rows, contrib.shape[1]), dtype=dt,
                      device=contrib.device)
    return out.index_add_(0, rows, contrib.to(dt))


def _phi_unblocked(rows, vals, pi, b, n_rows: int, eps: float,
                   perturb: str | None = None,
                   strategy: str = "segment") -> torch.Tensor:
    """``scatter`` and ``segment``: one ``index_add_`` over the stream
    (the stream's order and, on mixed dtypes, the result dtype are the
    only differences between the two)."""
    if perturb == "perfect_reuse":
        rows = torch.zeros_like(rows)
    s = torch.sum(b[rows] * pi, dim=1)
    w = vals / torch.clamp_min(s, eps)
    contrib = w[:, None] * pi
    if perturb == "no_conflict":
        return _uniform_segment_sum(contrib, n_rows)
    return _index_add_rows(rows, contrib, n_rows, strategy, pi.dtype)


def _krao_unblocked(rows, vals, kr, n_rows: int,
                    strategy: str = "segment") -> torch.Tensor:
    """Plain Khatri-Rao reduction ``out[i] += x_j * kr_j`` (unblocked):
    ``scatter`` and ``segment`` of :func:`krao_reduce_rows`.  ``index_add_``
    is correct in any row order, so unsorted COO needs no special case."""
    return _index_add_rows(rows, vals[:, None] * kr, n_rows, strategy,
                           kr.dtype)


def _phi_blocked_core(vals, pi, local_rows, grid_rb, b_win, *,
                      block_nnz: int, block_rows: int, n_row_blocks: int,
                      eps: float, perturb: str | None = None) -> torch.Tensor:
    """Plain emulation of the blocked schedule: tensors in, padded window
    out.  Each grid step reduces its ``block_nnz`` nonzeros into a
    (block_rows, R) partial window; the partials of the steps of one row
    block are then summed (the TPU kernel's output-block revisit).

      vals:       (n_grid*block_nnz,)   layout-expanded values
      pi:         (n_grid*block_nnz, R) layout-expanded Π rows
      local_rows: (n_grid*block_nnz,)   row within the step's row block
      grid_rb:    (n_grid,)             row block per grid step
      b_win:      (n_row_blocks*block_rows, R) zero-padded B window, or
                  None for the plain weighting ``out[i] += x_j * pi_j``:
                  the MTTKRP reduction, on the same schedule (no model
                  divide, no B gather; padding slots carry x = 0)
    """
    bn, br = block_nnz, block_rows
    g = vals.shape[0] // bn
    r = pi.shape[1]
    lrow = local_rows.long()
    rb = grid_rb.long()
    if perturb == "perfect_reuse":
        lrow = torch.zeros_like(lrow)
        rb = torch.zeros_like(rb)
    if b_win is None:
        w = vals
    else:
        rows = torch.repeat_interleave(rb, bn) * br + lrow
        s = torch.sum(b_win[rows] * pi, dim=1)
        w = torch.where(vals > 0, vals / torch.clamp_min(s, eps),
                        torch.zeros_like(vals))
    contrib = (w[:, None] * pi).reshape(g, bn, r)
    if perturb == "no_conflict":  # uniform write, no keyed reduce
        partial = contrib[:, :br, :]
        if partial.shape[1] < br:
            partial = torch.cat(
                [partial, partial.new_zeros((g, br - partial.shape[1], r))],
                dim=1)
    else:
        step_rows = (torch.arange(g, device=vals.device)[:, None] * br
                     + lrow.reshape(g, bn)).reshape(-1)
        partial = torch.zeros((g * br, r), dtype=contrib.dtype,
                              device=pi.device)
        partial = partial.index_add_(0, step_rows, contrib.reshape(-1, r))
        partial = partial.reshape(g, br, r)
    # the contributions' promoted dtype, as the JAX package's einsum and
    # segment_sum keep it (f32 for bf16 rows with f32 values or B)
    phi = torch.zeros((n_row_blocks, br, r), dtype=contrib.dtype,
                      device=pi.device)
    phi.index_add_(0, rb, partial)  # cross-step combine
    return phi.reshape(n_row_blocks * br, r)


def _phi_blocked_padded(layout: BlockedLayout, vals_e, pi_e, b, eps,
                        perturb=None) -> torch.Tensor:
    lt = layout.on(b.device)
    return _phi_blocked_core(
        vals_e, pi_e, lt.local_rows, lt.grid_rb,
        pad_rows(b, layout.n_rows_pad),
        block_nnz=layout.block_nnz, block_rows=layout.block_rows,
        n_row_blocks=layout.n_row_blocks, eps=eps, perturb=perturb,
    )


# ---------------------------------------------------------------------------
# Layout expansion and resolution
# ---------------------------------------------------------------------------


def expand_to_layout(layout: BlockedLayout, vals, pi) -> tuple:
    """Expand sorted per-nonzero tensors into the padded layout order."""
    lt = layout.on(pi.device)
    n_slots = lt.gather.shape[0]
    if vals.shape[0] == 0:  # gathering from a 0-row operand is ill-formed
        return (vals.new_zeros((n_slots,)),
                pi.new_zeros((n_slots, pi.shape[1])))
    vals_e = torch.where(lt.valid, vals[lt.gather], vals.new_zeros(()))
    pi_e = torch.where(lt.valid[:, None], pi[lt.gather], pi.new_zeros(()))
    return vals_e, pi_e


def expand_to_shards(slayout: ShardedBlockedLayout, vals, pi) -> tuple:
    """Expand sorted per-nonzero tensors into per-shard padded layout
    order: ``vals_e`` (S, n_grid_shard*block_nnz) and ``pi_e`` (S,
    n_grid_shard*block_nnz, R), the leading axis the shard."""
    st = slayout.on(pi.device)
    if vals.shape[0] == 0:  # gathering from a 0-row operand is ill-formed
        return (vals.new_zeros(st.gather.shape),
                pi.new_zeros(st.gather.shape + (pi.shape[1],)))
    vals_e = torch.where(st.valid, vals[st.gather], vals.new_zeros(()))
    pi_e = torch.where(st.valid[..., None], pi[st.gather], pi.new_zeros(()))
    return vals_e, pi_e


def expand_to_grid(glayout: GridLayout, vals, pi) -> tuple:
    """Expand sorted per-nonzero tensors into per-cell padded layout
    order: ``vals_e`` (A*B, n_grid_cell*block_nnz) and ``pi_e`` (A*B,
    n_grid_cell*block_nnz, R), the leading axis the flat cell (cell
    ``(s, c)`` at ``s*B + c``, row-major over the ``("row", "col")``
    mesh)."""
    return expand_to_shards(glayout, vals, pi)


def expand_vals_to_shards(slayout: ShardedBlockedLayout, vals) -> torch.Tensor:
    """The values half of :func:`expand_to_shards`, for the shard-local Π
    path, where no (S, slot, R) expanded Π is ever built."""
    st = slayout.on(vals.device)
    if vals.shape[0] == 0:
        return vals.new_zeros(st.gather.shape)
    return torch.where(st.valid, vals[st.gather], vals.new_zeros(()))


def _resolve_layout(rows, n_rows, layout, vals, pi, vals_e, pi_e):
    """Default layout + expansion for the blocked/cuda strategies.

    Without a layout the blocking comes from the heuristic's CPU branch
    for CPU tensors (as the JAX package does on its CPU backend) and
    from :func:`default_policy` (256 x 256) on the card, not from the
    heuristic's ``cuda`` branch: timed as one CUDA-graph burst, every
    blocking of the uber tensor's modes lies within 9% of the best, so
    the fixed default costs nothing measurable and keeps a CUDA tensor's
    layout independent of its statistics.  Pre-expanded ``vals_e``/``pi_e``
    pass through untouched so the solver's inner loop never re-gathers.
    """
    if layout is None:
        if pi.device.type == "cpu":
            rows_np = rows.detach().cpu().numpy()
            pol = heuristic_policy(
                int(rows_np.shape[0]), n_rows, int(pi.shape[1]),
                platform="cpu", stats=mode_run_stats(rows_np, n_rows),
            )
        else:
            pol = default_policy(int(pi.shape[1]))
        layout = build_blocked_layout(
            rows, n_rows, block_nnz=pol.block_nnz, block_rows=pol.block_rows
        )
        vals_e = pi_e = None  # any pre-expansion matched a different layout
    if vals_e is None or pi_e is None:
        vals_e, pi_e = expand_to_layout(layout, vals, pi)
    return layout, vals_e, pi_e


def _default_shard_count(mesh, device: torch.device) -> int:
    """Shards of a sharded call without a layout: the mesh's size, else
    every card of this process on the card and 1 on the CPU (where the
    JAX package counts ``jax.device_count()``)."""
    if mesh is not None:
        return distributed.mesh_device_count(mesh)
    if device.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def _sharded_block_rows(n_rows: int, n_shards: int) -> int:
    """Default block_rows sized so >= ~4 row blocks land on every shard."""
    target = max(8, n_rows // max(1, 4 * n_shards))
    return int(2 ** np.clip(np.floor(np.log2(target)), 3, 8))


def _resolve_sharded(rows, n_rows, layout, mesh, vals, pi, vals_e, pi_e):
    """Sharded layout + expansion, with the single-device fallback.

    Returns ``(layout, vals_e, pi_e)``: the :class:`ShardedBlockedLayout`,
    or, when the shard count cannot be honoured (fewer row blocks than
    shards), a warning and the *base* :class:`BlockedLayout` with ``None``
    expansions; callers then run the unsharded path on it.
    """
    if layout is not None:
        _check_layout("sharded", layout)
    if layout is None:
        n_shards = _default_shard_count(mesh, pi.device)
        base = build_blocked_layout(
            rows, n_rows, block_nnz=256,
            block_rows=_sharded_block_rows(n_rows, n_shards))
        if n_shards > base.n_row_blocks:
            warnings.warn(
                f"sharded Phi: {n_shards} shards requested but layout has "
                f"only {base.n_row_blocks} row blocks; falling back to the "
                "single-device blocked path",
                stacklevel=3,
            )
            return base, None, None
        layout = shard_blocked_layout(base, n_shards)
        vals_e = pi_e = None  # any pre-expansion matched a different layout
    if vals_e is None or pi_e is None:
        vals_e, pi_e = expand_to_shards(layout, vals, pi)
    return layout, vals_e, pi_e


def _resolve_grid(rows, n_rows, layout, mesh, vals, pi, vals_e, pi_e,
                  rank: int):
    """Grid layout + expansion, with the single-device fallback.

    Returns ``(layout, vals_e, pi_e)``: the :class:`GridLayout`, or, when
    the grid cannot be honoured (fewer row blocks than the row axis, or
    fewer grid steps than the column axis), a warning and the *base*
    :class:`BlockedLayout` with ``None`` expansions; callers then run the
    unsharded path on it, as for :func:`_resolve_sharded`.  Without a
    layout the shape is the mesh's, else :func:`choose_grid_shape`'s for
    the default shard count.
    """
    if layout is not None:
        _check_layout("grid", layout)
    if layout is None:
        if mesh is not None:
            shape = (int(mesh.size(0)), int(mesh.size(1)))
        else:
            n_shards = _default_shard_count(None, pi.device)
            shape = choose_grid_shape(
                n_rows, _sharded_block_rows(n_rows, n_shards), rank,
                n_shards)
        base = build_blocked_layout(
            rows, n_rows, block_nnz=256,
            block_rows=_sharded_block_rows(n_rows, shape[0]))
        try:
            layout = build_grid_layout(base, shape)
        except ValueError as e:
            warnings.warn(
                f"grid Phi: {e}; falling back to the single-device "
                "blocked path",
                stacklevel=4,
            )
            return base, None, None
        vals_e = pi_e = None  # any pre-expansion matched a different layout
    if vals_e is None or pi_e is None:
        vals_e, pi_e = expand_to_grid(layout, vals, pi)
    return layout, vals_e, pi_e


# the layout each layout-driven strategy runs on, and the function that
# builds it
_LAYOUTS = {
    "blocked": (BlockedLayout, "build_blocked_layout"),
    "cuda": (BlockedLayout, "build_blocked_layout"),
    "sharded": (ShardedBlockedLayout, "shard_blocked_layout"),
    "grid": (GridLayout, "build_grid_layout"),
}


def _check_layout(strategy: str, layout) -> None:
    want, build = _LAYOUTS[strategy]
    if not isinstance(layout, want):
        raise TypeError(
            f"strategy={strategy!r} needs a {want.__name__} "
            f"(got {type(layout).__name__}); use {build}()"
        )


def _check_family_args(strategy: str, pi_gather, perturb) -> None:
    """The perturbations run on the plain strategies only, and the grid
    builds no shard-local Π."""
    if perturb is not None and strategy not in ("scatter", "segment",
                                                "blocked"):
        raise ValueError(f"perturb is not supported for strategy={strategy!r}")
    if pi_gather is not None and strategy == "grid":
        raise ValueError(
            "pi_gather is not supported for strategy='grid'; use "
            "strategy='sharded' for the shard-local Pi path"
        )


def _check_combine(strategy: str, combine: str) -> None:
    """Validate the combine flavour; only the multi-device strategies
    combine (the grid's one combine is a reduce-scatter, so it takes
    ``"reduce_scatter"`` as a no-op alias)."""
    if combine == "psum":
        return
    if combine not in distributed.PHI_COMBINES:
        raise ValueError(
            f"unknown combine {combine!r}; expected one of "
            f"{distributed.PHI_COMBINES}"
        )
    if strategy not in ("sharded", "grid"):
        raise ValueError(
            f"combine={combine!r} only applies to strategy='sharded' "
            f"(got strategy={strategy!r})"
        )


def _require_pig_layout(layout, pi_gather) -> None:
    """Validate the shard-local-Π gather against its layout."""
    if not isinstance(layout, ShardedBlockedLayout):
        raise TypeError(
            "pi_gather needs an explicit ShardedBlockedLayout (the one the "
            f"gather maps were built from); got {type(layout).__name__}"
        )
    if pi_gather.n_shards != layout.n_shards:
        raise ValueError(
            f"pi_gather has {pi_gather.n_shards} shards but the layout has "
            f"{layout.n_shards}"
        )
    distributed._validate_pig(layout, pi_gather)


def _require_dense(dense) -> None:
    if not isinstance(dense, DenseModeData):
        raise ValueError(
            "strategy='dense' needs dense= (a DenseModeData; build one "
            "with repro_torch.core.dense.build_dense_mode)")


def _dense_operands(dense, factors, b=None) -> tuple:
    """Kernel operands ``(x, c, a)`` for the dense tier.

    ``dense`` is a :class:`repro_torch.core.dense.DenseModeData`,
    ``factors`` the full factor tuple.  The element tier follows ``b``
    when given (the MU path), else the ``c`` factor: ``x`` is stored f32
    and cast here, so bf16 factors drive the bf16 kernels without a second
    densified copy.
    """
    _require_dense(dense)
    if factors is None:
        raise ValueError("strategy='dense' needs the full factors tuple")
    c, a = dense_kr_factors(dense, factors)
    dt = b.dtype if b is not None else c.dtype
    return dense.x.to(dt), c.to(dt).contiguous(), a.to(dt)


def _dense_tensors(dense, factors) -> list:
    """The tensors behind ``dense=``/``factors=``, for the device check."""
    return ([] if dense is None else [dense.x]) + list(factors or ())


def resolve_combine(combine: str, strategy: str) -> str:
    """Resolve a (possibly ``"auto"``) combine flavour for one mode.

    ``"auto"`` means reduce-scatter whenever the mode runs sharded;
    non-sharded modes always resolve to ``"psum"`` (nothing to combine).
    The grid family has exactly one combine, the reduce-scatter, so
    ``"grid"`` resolves to ``"reduce_scatter"`` and rejects ``"psum"``.
    """
    if strategy == "grid":
        if combine not in ("auto", "reduce_scatter"):
            raise ValueError(
                f"combine {combine!r} is not supported for strategy='grid'"
                " (the grid combine is always the column reduce-scatter)"
            )
        return "reduce_scatter"
    if strategy != "sharded":
        return "psum"
    if combine == "auto":
        return "reduce_scatter"
    if combine not in distributed.PHI_COMBINES:
        raise ValueError(
            f"unknown combine {combine!r}; expected 'auto' or one of "
            f"{distributed.PHI_COMBINES}"
        )
    return combine


def effective_mode_combine(combine: str, strategy: str, layout, rank: int,
                           *, itemsize: int = 4) -> str:
    """Per-mode combine after the wire-aware ``"auto"`` demotion.

    ``"auto"`` prefers the reduce-scatter epilogue but consults
    :func:`repro_torch.core.distributed.preferred_combine` on the mode's
    sharded layout: a heavily block-skewed split pads the owner slots past
    the all-reduce's wire, and ``"auto"`` then keeps the all-reduce.  An
    explicit ``"reduce_scatter"`` is never demoted.  ``itemsize`` is the
    factor element width in bytes.
    """
    eff = resolve_combine(combine, strategy)
    if isinstance(layout, GridLayout):
        # the 1-D or N-D pick happened when the layout was resolved
        # (choose_grid_shape); a grid has exactly one combine
        return "reduce_scatter"
    if (combine == "auto" and eff == "reduce_scatter"
            and isinstance(layout, ShardedBlockedLayout)):
        eff = distributed.preferred_combine(layout, rank, itemsize=itemsize)
    return eff


# ---------------------------------------------------------------------------
# One mode's operators, bound once
# ---------------------------------------------------------------------------


def _same(x):
    return x


@dataclasses.dataclass(frozen=True)
class ModeOps:
    """One mode's Φ, MU and MTTKRP operators, bound by :func:`bind_mode`.

    ``inputs(factors)`` gives the operands hoisted once per mode update:
    ``(pi, vals_e, pi_e, factors)`` for the sparse families (None in each
    slot the family does not read: ``cuda`` forms only the slot-ordered
    ``vals_e`` and ``pi_e``, in one kernel, and builds no ``pi``;
    ``factors`` for the shard-local Π gather), the kernel operands
    ``(x, c, a)`` for ``dense``.
    ``phi(operands, b)`` is Φ and ``step(operands, b)`` the fused inner MU
    step ``(b', viol)``, both on the family's carry, which ``stack(a)``
    makes from a full (I_n, R) block and ``unstack(b)`` turns back: the
    block itself, or its owner- or grid-stacked slices.
    ``reduce(operands)`` is the MTTKRP, a full (I_n, R) block.
    """

    inputs: Callable
    phi: Callable
    step: Callable
    reduce: Callable
    stack: Callable = _same
    unstack: Callable = _same


def bind_mode(
    strategy: str,
    layout,
    rows: torch.Tensor,
    vals: torch.Tensor,
    n_rows: int,
    *,
    idx: torch.Tensor | None = None,
    mode: int = 0,
    eps: float = 1e-10,
    tol: float = 1e-4,
    mesh=None,
    local_strategy: str = "blocked",
    pi_gather=None,
    combine: str = "psum",
    rank: int = 0,
    perturb: str | None = None,
    device="cuda",
) -> ModeOps:
    """Decide one mode's kernel family once and bind its operators.

    The family follows from the strategy, the type of ``layout`` (the
    mode's resolved layout, its :class:`DenseModeData` for ``dense``,
    unused by ``scatter``/``segment``) and, for a sharded layout,
    :func:`effective_mode_combine` of ``combine`` (``rank`` is read only
    for ``"auto"``).  ``inputs`` gathers Π from the sorted coordinates
    ``idx`` of ``mode`` (``cuda``: straight into slot order with the
    values, in one kernel).  Every check that does not depend on B runs
    here, once: the device, the strategy's name, the layout's type, the
    shard-local Π gather, the mesh, the dense data and ``perturb``.  The
    bound callables run what the public entries run on the same operands.
    """
    dev = resolve_device(device)
    strategy = canonical_strategy(strategy)
    check_on_device("bind_mode", dev, rows, vals, idx,
                    *(_dense_tensors(layout, None)
                      if isinstance(layout, DenseModeData) else ()))
    _check_family_args(strategy, pi_gather, perturb)
    eps = float(eps)

    def gathered(expand):
        def inputs(factors):
            pi = pi_rows(idx, factors, mode)
            return (pi, *expand(layout, vals, pi), None)
        return inputs

    if strategy in ("scatter", "segment"):
        return ModeOps(
            inputs=lambda f: (pi_rows(idx, f, mode), None, None, None),
            phi=lambda o, b: _phi_unblocked(rows, vals, o[0], b, n_rows, eps,
                                            perturb, strategy),
            step=lambda o, b: _mu_epilogue(
                b, _phi_unblocked(rows, vals, o[0], b, n_rows, eps,
                                  strategy=strategy), tol),
            reduce=lambda o: _krao_unblocked(rows, vals, o[0], n_rows,
                                             strategy))
    if strategy == "dense":
        _require_dense(layout)
        from ..kernels.dense import ops as dense_ops

        def dense_step(o, b):
            mu, viol = dense_ops.phi_mu_dense(*o, b, eps=eps)
            return torch.where(viol > tol, mu, b), viol

        return ModeOps(
            inputs=lambda f: _dense_operands(layout, f, f[mode]),
            phi=lambda o, b: dense_ops.phi_dense(*o, b, eps=eps),
            step=dense_step, reduce=lambda o: dense_ops.mttkrp_dense(*o))
    if strategy == "sharded" and pi_gather is not None:
        _require_pig_layout(layout, pi_gather)
    _check_layout(strategy, layout)
    if strategy == "blocked":
        def blocked_step(o, b):
            phi_pad = _phi_blocked_padded(layout, o[1], o[2], b, eps)
            b_new_pad, viol = _mu_epilogue(pad_rows(b, layout.n_rows_pad),
                                           phi_pad, tol)
            return b_new_pad[:n_rows], viol

        def blocked_reduce(o):
            lt = layout.on(o[2].device)
            return _phi_blocked_core(
                o[1], o[2], lt.local_rows, lt.grid_rb, None,
                block_nnz=layout.block_nnz, block_rows=layout.block_rows,
                n_row_blocks=layout.n_row_blocks, eps=0.0)[:n_rows]

        return ModeOps(
            inputs=gathered(expand_to_layout),
            phi=lambda o, b: _phi_blocked_padded(layout, o[1], o[2], b, eps,
                                                 perturb)[:n_rows],
            step=blocked_step, reduce=blocked_reduce)
    if strategy == "cuda":
        from ..kernels.mttkrp import ops as mttkrp_ops
        from ..kernels.phi import ops as phi_ops
        from ..kernels.pi import ops as pi_ops

        def cuda_step(o, b):
            mu_pad, viol = phi_ops.phi_mu_blocked(layout, o[1], o[2], b, eps)
            return torch.where(viol > tol, mu_pad[:n_rows], b), viol

        return ModeOps(
            inputs=lambda f: (None, *pi_ops.pi_gather(layout, idx, vals, f,
                                                      mode), None),
            phi=lambda o, b: phi_ops.phi_blocked(layout, o[1], o[2], b,
                                                 eps)[:n_rows],
            step=cuda_step,
            reduce=lambda o: mttkrp_ops.mttkrp_blocked(layout, o[1],
                                                       o[2])[:n_rows])
    kw = dict(mesh=mesh, local_strategy=local_strategy)
    if strategy == "grid":
        distributed._validate_grid_mesh(layout, mesh)
        return ModeOps(
            inputs=gathered(expand_to_grid),
            phi=lambda o, b: distributed.phi_grid_owner(
                layout, o[1], o[2], b, eps=eps, **kw),
            step=lambda o, b: distributed.phi_mu_grid_owner(
                layout, o[1], o[2], b, eps=eps, tol=tol, **kw),
            reduce=lambda o: distributed.krao_grid(layout, o[1], o[2], **kw),
            stack=partial(distributed.grid_stack, layout, mesh=mesh),
            unstack=partial(distributed.grid_unstack, layout, mesh=mesh))
    distributed._validate_phi_mesh(layout, mesh)
    if pi_gather is None:
        inputs = gathered(expand_to_shards)
    else:
        def inputs(factors):
            return None, expand_vals_to_shards(layout, vals), None, factors
    kw["pi_gather"] = pi_gather
    combine = effective_mode_combine(combine, "sharded", layout, rank,
                                     itemsize=vals.element_size())
    if combine == "psum":
        on = (layout,)
        phi_fn, step_fn = distributed.phi_sharded, distributed.phi_mu_sharded
        stack = unstack = _same
    else:  # the owner-stacked carry of the reduce-scatter epilogue
        opart = owner_partition(layout)
        on = (layout, opart)
        phi_fn = distributed.phi_sharded_owner
        step_fn = distributed.phi_mu_sharded_owner
        stack = partial(distributed.owner_stack, opart, mesh=mesh)
        unstack = partial(distributed.owner_unstack, opart, mesh=mesh)
    return ModeOps(
        inputs=inputs,
        phi=lambda o, b: phi_fn(*on, o[1], o[2], b, eps=eps, factors=o[3],
                                **kw),
        step=lambda o, b: step_fn(*on, o[1], o[2], b, eps=eps, tol=tol,
                                  factors=o[3], **kw),
        reduce=lambda o: distributed.krao_sharded(
            layout, o[1], o[2], factors=o[3], combine=combine, **kw),
        stack=stack, unstack=unstack)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _bind_entry(where: str, rows, vals, pi, b, n_rows, strategy, layout,
                vals_e, pi_e, mesh, local_strategy, pi_gather, factors,
                combine, dense, device, *, eps=1e-10, tol=1e-4,
                perturb=None) -> tuple:
    """``(ModeOps, operands)`` of one call of the public entry ``where``:
    its checks, the per-call default layout (or the warned single-device
    fallback of a shard count or grid the mode cannot honour, which runs
    ``local_strategy`` on the base layout), the layout expansion unless
    it comes pre-expanded, then :func:`bind_mode`."""
    dev = resolve_device(device)
    check_on_device(where, dev, rows, vals, pi, b, vals_e, pi_e,
                    *_dense_tensors(dense, factors))
    strategy = canonical_strategy(strategy)
    _check_combine(strategy, combine)
    _check_family_args(strategy, pi_gather, perturb)
    if strategy == "sharded" and pi_gather is not None:
        _require_pig_layout(layout, pi_gather)
        if factors is None:
            raise ValueError("pi_gather needs the full factors tuple")
        if vals_e is None:
            vals_e = expand_vals_to_shards(layout, vals)
        pi_e = None
    elif strategy == "sharded":
        layout, vals_e, pi_e = _resolve_sharded(rows, n_rows, layout, mesh,
                                                vals, pi, vals_e, pi_e)
    elif strategy == "grid":
        layout, vals_e, pi_e = _resolve_grid(rows, n_rows, layout, mesh,
                                             vals, pi, vals_e, pi_e,
                                             int(pi.shape[-1]))
    if strategy in ("sharded", "grid") and isinstance(layout, BlockedLayout):
        strategy = canonical_strategy(local_strategy)
    if strategy in ("blocked", "cuda"):
        layout, vals_e, pi_e = _resolve_layout(rows, n_rows, layout, vals, pi,
                                               vals_e, pi_e)
    ops = bind_mode(strategy, dense if strategy == "dense" else layout, rows,
                    vals, n_rows, eps=eps, tol=tol, mesh=mesh,
                    local_strategy=local_strategy, pi_gather=pi_gather,
                    combine=combine, perturb=perturb, device=dev)
    if strategy == "dense":
        return ops, _dense_operands(dense, factors, b)
    return ops, (pi, vals_e, pi_e, factors)


def phi_from_rows(
    rows: torch.Tensor,
    vals: torch.Tensor,
    pi: torch.Tensor,
    b: torch.Tensor,
    n_rows: int,
    eps: float = 1e-10,
    strategy: str = "segment",
    layout: BlockedLayout | None = None,
    perturb: str | None = None,
    vals_e: torch.Tensor | None = None,
    pi_e: torch.Tensor | None = None,
    mesh=None,
    local_strategy: str = "blocked",
    pi_gather=None,
    factors=None,
    combine: str = "psum",
    dense=None,
    device="cuda",
) -> torch.Tensor:
    """Φ^(n) from pre-gathered Π rows.  ``rows`` sorted unless 'scatter'.

    For ``blocked``/``cuda``, optional ``vals_e``/``pi_e`` are the
    layout-expanded tensors (see :func:`expand_to_layout`); pass them to
    skip per-call re-expansion.  For ``dense``, ``dense`` (a
    :class:`repro_torch.core.dense.DenseModeData`) and the full
    ``factors`` tuple replace the sorted stream: ``rows``/``vals``/``pi``
    may be None.  For ``sharded``, ``layout`` is a
    :class:`ShardedBlockedLayout` (else one is built, or, with fewer row
    blocks than shards, the call warns and runs ``local_strategy``
    unsharded), ``vals_e``/``pi_e`` come from :func:`expand_to_shards`,
    ``mesh`` places the shards on the ranks of a ``torch.distributed``
    mesh (else they are emulated on one device) and ``combine`` picks
    the combine; with ``pi_gather`` and the full ``factors`` each shard
    builds its own Π rows and ``pi``/``pi_e`` may be None.  For ``grid``,
    ``layout`` is a :class:`GridLayout` (else one is built, of the mesh's
    shape or :func:`choose_grid_shape`'s), ``vals_e``/``pi_e`` come from
    :func:`expand_to_grid` and ``mesh`` is a ``("row", "col")`` mesh
    (:func:`repro_torch.core.distributed.make_grid_mesh`).  Every tensor
    must lie on ``device``.
    """
    ops, operands = _bind_entry(
        "phi_from_rows", rows, vals, pi, b, n_rows, strategy, layout, vals_e,
        pi_e, mesh, local_strategy, pi_gather, factors, combine, dense,
        device, eps=eps, perturb=perturb)
    return ops.unstack(ops.phi(operands, ops.stack(b)))


def _mu_epilogue(b: torch.Tensor, phi: torch.Tensor, tol: float) -> tuple:
    """Shared unblocked epilogue: KKT violation + conditional MU update.

    ``B`` is left untouched on the iteration that detects convergence
    (viol <= tol), matching Chi & Kolda's check-before-update semantics.
    """
    viol = torch.max(torch.abs(torch.minimum(b, 1.0 - phi)))
    return torch.where(viol > tol, b * phi, b), viol


def phi_mu_step(
    rows: torch.Tensor,
    vals: torch.Tensor,
    pi: torch.Tensor,
    b: torch.Tensor,
    n_rows: int,
    eps: float = 1e-10,
    tol: float = 1e-4,
    strategy: str = "segment",
    layout: BlockedLayout | None = None,
    vals_e: torch.Tensor | None = None,
    pi_e: torch.Tensor | None = None,
    mesh=None,
    local_strategy: str = "blocked",
    pi_gather=None,
    factors=None,
    combine: str = "psum",
    dense=None,
    device="cuda",
) -> tuple:
    """One fused CP-APR inner MU step: ``(B', viol)``.

    Computes Φ^(n), the KKT violation ``max |min(B, 1 - Φ)|`` and the
    multiplicative update ``B' = B * Φ`` (applied only while
    ``viol > tol``).  ``viol`` stays a 0-d tensor on the device.  For
    ``cuda`` and ``dense`` the update runs in the fused kernels; the
    padded region of B and Φ is zero, so it adds nothing to the violation
    or to ``B*Φ``.  ``dense``/``factors`` and the sharded arguments as in
    :func:`phi_from_rows`; for ``sharded`` the shards' Φ windows meet in
    one combine and the epilogue runs on the combined window (``psum``)
    or on each owner's rows (``reduce_scatter``), bitwise equal; for
    ``grid`` the epilogue runs on each cell's owned tile.
    """
    ops, operands = _bind_entry(
        "phi_mu_step", rows, vals, pi, b, n_rows, strategy, layout, vals_e,
        pi_e, mesh, local_strategy, pi_gather, factors, combine, dense,
        device, eps=eps, tol=tol)
    b_new, viol = ops.step(operands, ops.stack(b))
    return ops.unstack(b_new), viol


def krao_reduce_rows(
    rows: torch.Tensor,
    vals: torch.Tensor,
    kr: torch.Tensor,
    n_rows: int,
    strategy: str = "segment",
    layout: BlockedLayout | None = None,
    vals_e: torch.Tensor | None = None,
    kr_e: torch.Tensor | None = None,
    mesh=None,
    local_strategy: str = "blocked",
    pi_gather=None,
    factors=None,
    sorted_rows: bool = True,
    combine: str = "psum",
    dense=None,
    device="cuda",
) -> torch.Tensor:
    """Shared segmented Khatri-Rao reduction: ``out[i] = sum x_j * kr_j``.

    The MTTKRP kernel family (CP-ALS's bottleneck, paper Exp. 8) is the Φ
    reduction without the model divide, through the same strategies:

      * ``scatter``/``segment`` — ``index_add_`` (``rows`` in any order);
      * ``blocked`` — the blocked schedule's plain emulation, through
        :func:`_phi_blocked_core` with plain weights;
      * ``cuda`` (alias ``"pallas"``) — the MTTKRP kernel
        (:mod:`repro_torch.kernels.mttkrp`);
      * ``dense`` — the dense MTTKRP kernel on ``dense=`` (a
        :class:`repro_torch.core.dense.DenseModeData`) and ``factors``;
        ``rows``/``vals``/``kr`` may be None;
      * ``sharded`` — row-block shards and one combine, as in
        :func:`phi_from_rows` (the MTTKRP kernel once per shard for
        ``local_strategy="cuda"``); with ``pi_gather``/``factors`` each
        shard builds its Khatri-Rao rows and ``kr``/``kr_e`` may be None;
      * ``grid`` — an ``A x B`` device grid, as in :func:`phi_from_rows`
        (the MTTKRP kernel once per cell for ``local_strategy="cuda"``).

    ``rows`` must be sorted for ``blocked`` and ``cuda``.  ``sorted_rows``
    is the JAX package's promise to its ``segment_sum``; ``index_add_``
    needs none, so the port's result does not depend on it.
    ``vals_e``/``kr_e`` are pre-expanded layout tensors (hoisted by the
    solver), as in :func:`phi_from_rows`.  Non-negativity is not assumed:
    a negative value counts like any other.
    """
    ops, operands = _bind_entry(
        "krao_reduce_rows", rows, vals, kr, None, n_rows, strategy, layout,
        vals_e, kr_e, mesh, local_strategy, pi_gather, factors, combine,
        dense, device)
    return ops.reduce(operands)


def phi_mode(
    mv: ModeView,
    factors: Sequence[torch.Tensor],
    b: torch.Tensor,
    eps: float = 1e-10,
    strategy: str = "segment",
    layout: BlockedLayout | None = None,
    perturb: str | None = None,
    device="cuda",
) -> torch.Tensor:
    """Full Φ^(n) for a mode view: Π gather-product then reduction.

    For ``strategy="dense"`` the mode is densified on the fly (shape from
    the factor row counts) and no Π is built: fine for one-shot calls;
    the solver builds its :class:`DenseModeData` once per mode instead.
    """
    if canonical_strategy(strategy) == "dense":
        if perturb is not None:
            raise ValueError("perturb is not supported for strategy='dense'")
        shape = tuple(int(f.shape[0]) for f in factors)
        dn = build_dense_mode(mv.sorted_idx, mv.sorted_vals, shape, mv.mode,
                              device=resolve_device(device))
        return phi_from_rows(None, None, None, b, mv.n_rows, eps=eps,
                             strategy="dense", device=device, dense=dn,
                             factors=tuple(factors))
    idx = mv.sorted_idx
    if perturb == "perfect_reuse":
        idx = torch.zeros_like(idx)
    pi = pi_rows(idx, factors, mv.mode)
    return phi_from_rows(mv.rows, mv.sorted_vals, pi, b, n_rows=mv.n_rows,
                         eps=eps, strategy=strategy, layout=layout,
                         perturb=perturb, device=device)
