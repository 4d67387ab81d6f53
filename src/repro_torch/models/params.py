"""Parameter trees: :class:`ParamSpec` leaves in nested dicts.

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, logical axes, dtype, init rule) under the JAX package's tree
names and shapes.  The same tree drives :func:`init_params` (real
tensors on a device), :func:`abstract_params` (meta-device tensors, no
memory) and :func:`count_params`.  The logical axes are kept for the
mesh rules of the training slice; on one device nothing reads them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device

__all__ = [
    "DEFAULT_RULES",
    "NamedSharding",
    "ParamSpec",
    "RULE_PROFILES",
    "ZERO3_RULES",
    "abstract_params",
    "active_rules",
    "cast_specs",
    "contiguous_strides",
    "count_params",
    "empty_caches",
    "for_compute",
    "init_params",
    "logical_constraint",
    "mesh_axis_sizes",
    "param_shardings",
    "placements_for",
    "set_rules_profile",
    "spec_for_axes",
    "tree_leaves",
    "tree_map",
    "use_mesh",
    "weights_for_compute",
]

# f32 elements drawn at a time by init_params: a large leaf is filled a
# slice of rows at a time, so no whole tree (or leaf) exists in f32
_INIT_SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name per dim (None = replicated dim)
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for 'normal'

    def struct(self) -> torch.Tensor:
        """A meta tensor of this shape and dtype (no storage): the port's
        ``jax.ShapeDtypeStruct``."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


# logical axis -> mesh axis (or tuple).  'fsdp' is resolved by mesh axes
# present: ('pod','data') on the multi-pod mesh, ('data',) on single-pod.
DEFAULT_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "kv_seq": "model",  # decode-cache seq dim: flash-decoding-style split
    "mlp": "model",
    "experts": "model",
    "embed": "fsdp",
    "layers": None,
    "conv": None,
    "state": None,
    "batch": "fsdp",
    "seq": None,
}

# ZeRO-3 profile: the batch is data-parallel over every mesh axis and each
# weight's first shardable dim is FSDP-sharded over ('data', 'model'),
# for small dense models that 16-way TP leaves collective-bound.
ZERO3_RULES = {
    "vocab": ("data", "model"),
    "heads": ("data", "model"),
    "kv": ("data", "model"),
    "kv_seq": None,
    "mlp": ("data", "model"),
    "experts": ("data", "model"),
    "embed": ("data", "model"),
    "layers": None,
    "conv": None,
    "state": None,
    "batch": ("data", "model"),
    "seq": None,
}

RULE_PROFILES = {"tp_fsdp": DEFAULT_RULES, "zero3": ZERO3_RULES}

_ACTIVE_RULES = [DEFAULT_RULES]


def set_rules_profile(name_or_rules):
    """Select the active logical-axis rules (the default of
    :func:`spec_for_axes`, :func:`param_shardings`,
    :func:`logical_constraint` and the batch rule).  Returns the rules."""
    rules = (RULE_PROFILES[name_or_rules]
             if isinstance(name_or_rules, str) else name_or_rules)
    _ACTIVE_RULES[0] = rules
    return rules


def active_rules():
    return _ACTIVE_RULES[0]


# When two dims of one tensor want the same mesh axis (a KV cache whose
# 'kv' heads and 'kv_seq' positions both map to 'model'), the lower-priority
# dim replicates: kv wins over kv_seq.  Under zero3 the first shardable
# weight dim wins ('embed' before 'heads').
_AXIS_PRIORITY = {"kv_seq": 1}


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of any
    object with the JAX mesh's ``axis_names`` and ``shape[name]``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(k) for n, k in zip(names, mesh.shape)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def _resolve(axis_name, mesh, rules: dict):
    rule = rules.get(axis_name)
    if rule is None:
        return None
    names = tuple(mesh_axis_sizes(mesh))
    if rule == "fsdp":
        return tuple(a for a in ("pod", "data") if a in names) or None
    if rule == "all":
        return names
    if isinstance(rule, tuple):
        out = tuple(a for a in rule if a in names)
        return out or None
    return rule if rule in names else None


def spec_for_axes(axes: tuple, shape: tuple, mesh, rules=None) -> tuple:
    """Per-dim mesh axes of a tensor with logical ``axes`` and ``shape``:
    ``None`` (replicated), an axis name or a tuple of names, the JAX
    package's ``PartitionSpec`` entries.

    Replicates non-divisible dims; resolves same-axis conflicts between two
    dims of one tensor by ``_AXIS_PRIORITY`` (lower number wins).
    """
    rules = rules or active_rules()
    sizes = mesh_axis_sizes(mesh)
    cand = []
    for dim, ax in zip(shape, axes):
        r = _resolve(ax, mesh, rules) if ax else None
        if r is None:
            cand.append(None)
            continue
        names = (r,) if isinstance(r, str) else tuple(r)
        size = 1
        for nm in names:
            size *= sizes[nm]
        cand.append(r if dim % size == 0 else None)
    order = sorted(range(len(cand)),
                   key=lambda i: _AXIS_PRIORITY.get(axes[i] or "", 0))
    parts = [None] * len(cand)
    used: set = set()
    for i in order:
        r = cand[i]
        if r is None:
            continue
        names = (r,) if isinstance(r, str) else tuple(r)
        if any(nm in used for nm in names):
            continue  # lower-priority dim replicates
        parts[i] = r
        used.update(names)
    return tuple(parts)


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of a per-dim ``spec`` on ``mesh``: ``Shard(i)``
    on each mesh dim that tensor dim ``i`` names, ``Replicate()`` on the
    others.  A dim split over several mesh axes is split in mesh-dim
    order, major first, as JAX splits ``P(("pod", "data"))``."""
    out = []
    for name in mesh_axis_sizes(mesh):
        dim = next((i for i, r in enumerate(spec) if r is not None and
                    name in ((r,) if isinstance(r, str) else r)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: its per-dim ``spec`` and the DTensor
    ``placements`` that implement it."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def place(self, x: torch.Tensor) -> DTensor:
        """``x`` (the same full tensor on every rank) as a DTensor with
        these placements; each rank keeps its own chunk, nothing is
        sent."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def abstract_params(tree):
    """ParamSpec tree -> tree of meta-device tensors (shapes and dtypes,
    no storage)."""
    return tree_map(lambda s: s.struct(), tree)


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / (fan_in ** 0.5)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    rows = out.view(-1, spec.shape[-1]) if out.dim() else out.view(1, 1)
    step = max(1, _INIT_SLICE_ELEMS // rows.shape[1])
    for i in range(0, rows.shape[0], step):
        j = min(i + step, rows.shape[0])
        draw = torch.randn((j - i, rows.shape[1]), generator=gen,
                           dtype=torch.float32, device=dev)
        rows[i:j] = (draw * std).to(spec.dtype)
    return out


@torch.no_grad()
def init_params(tree, seed: int = 0, device="cuda"):
    """ParamSpec tree -> tensor tree on ``device``.

    The JAX package's rule, leaf by leaf: zeros, ones, or an f32 normal
    times ``scale / sqrt(fan_in)`` (fan_in: the second-to-last dim) cast
    to the spec's dtype.  The draws come from one ``torch.Generator`` on
    the device seeded with ``seed``; they do not reproduce JAX's PRNG.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen, dev), tree)


def empty_caches(tree, device) -> dict:
    """Cache spec tree -> zero tensors on ``device``, every ``kv_pos``
    leaf at -1 (all ring slots empty).  While a mesh is active
    (:func:`use_mesh`) each leaf is a DTensor on it with the active rules'
    placements, each rank holding only its own chunk."""
    mesh = _ambient_mesh()

    def leaf(k, v):
        fill = -1 if k == "kv_pos" else 0
        if mesh is None:
            return torch.full(v.shape, fill, dtype=v.dtype, device=device)
        from torch.distributed.tensor import full

        return full(v.shape, fill, dtype=v.dtype, device_mesh=mesh,
                    placements=placements_for(
                        spec_for_axes(v.axes, v.shape, mesh), mesh))

    return {k: empty_caches(v, device) if isinstance(v, dict) else leaf(k, v)
            for k, v in tree.items()}


def cast_specs(tree, dtype):
    """Replace the default bf16 weight dtype (f32 norms and int specs are
    untouched): the reduced configs run in f32."""
    def f(s):
        if s.dtype == torch.bfloat16:
            return dataclasses.replace(s, dtype=dtype)
        return s

    return tree_map(f, tree)


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides, computed without allocating one)."""
    out, step = [], 1
    for d in reversed(tuple(shape)):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def param_shardings(tree, mesh, rules=None):
    """ParamSpec tree -> :class:`NamedSharding` tree."""
    return tree_map(
        lambda s: NamedSharding(mesh, spec_for_axes(s.axes, s.shape, mesh,
                                                    rules)), tree)


_AMBIENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of :func:`logical_constraint` for
    the body (the JAX package's ``with mesh:``)."""
    token = _AMBIENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT_MESH.reset(token)


def _ambient_mesh():
    return _AMBIENT_MESH.get()


def for_compute(w):
    """A weight in the layout it is used in: the mesh axes that split the
    batch (the active rules' ``batch`` axes) gathered, the others kept, so
    FSDP shards are all-gathered and tensor-parallel splits stay (the
    layout XLA's partitioner gives the reference's weights).  ``w`` itself
    with no mesh active or for a plain tensor (or None)."""
    m = _ambient_mesh()
    if m is None or not isinstance(w, DTensor):
        return w
    batch = _resolve("batch", m, active_rules()) or ()
    batch = (batch,) if isinstance(batch, str) else tuple(batch)
    placements = tuple(Replicate() if name in batch else pl for name, pl in
                       zip(mesh_axis_sizes(m), w.placements))
    if tuple(w.placements) == placements:
        return w
    return w.redistribute(m, placements)


def weights_for_compute(tree):
    """:func:`for_compute` over a tree of weights (one layer's)."""
    return tree_map(for_compute, tree)


def logical_constraint(x, axes: tuple):
    """Pin ``x`` to the layout its logical ``axes`` name under the active
    rules: a ``redistribute`` of a DTensor while a mesh is active
    (:func:`use_mesh`), ``x`` itself otherwise.

    Pinning activations at layer boundaries keeps every intermediate
    (attention scores, MoE buffers, CE chunks) sharded by batch, as the
    reference's ``with_sharding_constraint`` does.
    """
    m = _ambient_mesh()
    if m is None or not isinstance(x, DTensor):
        return x
    spec = spec_for_axes(axes, x.shape, m, rules=active_rules())
    placements = placements_for(spec, m)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(m, placements)


def count_params(tree) -> int:
    """Total elements of a ParamSpec (or tensor) tree."""
    total = 0
    for s in tree_leaves(tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
