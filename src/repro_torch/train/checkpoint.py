"""Fault-tolerant checkpointing in the JAX package's format (npz, atomic
rename).

  * leaves are saved as full host arrays keyed by their "/"-joined tree
    path (dict keys sorted at every level, as ``jax.tree_util`` orders
    them), so either package restores the other's f32 checkpoints;
  * a bf16 leaf is written as that package writes it: two bytes per
    element under the npy descr ``'<V2'``, byte for byte.  It is read
    back through an int16 view as ``torch.bfloat16``, as
    ``models/convert.py`` carries bf16 across; the JAX package's own
    ``restore`` cannot read such a leaf (numpy gives it back as void);
  * writes are atomic: a temp file in the directory, then ``os.replace``;
    the ``LATEST`` JSON is written last, so a crash mid-write never
    corrupts the restore point;
  * ``Checkpointer`` keeps a rolling window of ``keep`` checkpoints;
  * mesh-independent: a tree of DTensors is written as its full arrays
    (every rank gathers each leaf, rank 0 writes, the others wait), so a
    checkpoint written on one mesh restores onto any mesh
    (``restore(..., shardings=)``: the elastic re-mesh) or onto one
    device (``device=``).
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import resolve_device

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_SEP = "/"
_BF16_DESCR = "<V2"  # what numpy records for the JAX package's bf16 arrays


def _items(tree, prefix=()):
    """(path, leaf) pairs of nested dicts, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _write_npy(f, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": tuple(t.shape)})
        f.write(t.view(torch.int16).numpy().tobytes())
    else:
        np.lib.format.write_array(f, t.numpy(), allow_pickle=False)


def _full(leaf) -> torch.Tensor:
    """A leaf's full value (a DTensor's gathered on every rank)."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _savez(f, tree) -> None:
    """``np.savez``'s container (stored zip, one ``<key>.npy`` member per
    leaf) with bf16 leaves written as the JAX package writes them."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, leaf in _items(tree):
            with z.open(key + ".npy", "w", force_zip64=True) as m:
                _write_npy(m, _full(leaf))


def _sharded(tree) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in _items(tree))


def _to_tensor(arr: np.ndarray, like: torch.Tensor, key: str,
               dev: torch.device) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"target {tuple(like.shape)}")
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"{key}: a {arr.dtype} leaf restores only into "
                             f"a bfloat16 target, not {like.dtype}")
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write ``tree`` (nested dicts of tensors) at ``step``.

    A tree with DTensor leaves is a collective: every rank of the default
    process group calls it, each leaf is gathered leaf by leaf, rank 0
    writes, and every rank returns once the file and ``LATEST`` are in
    place."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if _sharded(tree):
        try:
            if dist.get_rank() == 0:
                _save_file(ckpt_dir, path, step, tree, extra)
            else:
                for _, leaf in _items(tree):
                    _full(leaf)
        finally:
            dist.barrier()
        return path
    _save_file(ckpt_dir, path, step, tree, extra)
    return path


def _save_file(ckpt_dir: str, path: str, step: int, tree,
               extra: dict | None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _savez(f, tree)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    meta = {"step": step}
    if extra:
        meta.update(extra)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(json.load(f)["step"])


def restore(ckpt_dir: str, tree_like, step: int | None = None,
            shardings=None, device="cuda"):
    """(tree, step): the checkpoint at ``step`` (default: the latest) on
    the structure of ``tree_like`` (tensors giving shapes and dtypes,
    e.g. meta tensors from ``abstract_params(state_specs(...))``), every
    leaf placed on ``device``; or, with ``shardings`` (a tree of
    ``NamedSharding``, ``launch.mesh.state_shardings``), placed on its
    mesh as a DTensor (the elastic re-mesh: any mesh, any rank count;
    every rank reads the file and keeps its own chunks)."""
    if shardings is not None:
        tree, step = restore(ckpt_dir, tree_like, step, device="cpu")

        def place(t, sh):
            return sh.place(t.to(sh.mesh.device_type))

        return _map2(place, tree, shardings), step
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _to_tensor(flat[key], tree, key, dev)

    return build(tree_like), step


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


class Checkpointer:
    """Rolling checkpoint manager with a retention window."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep

    def save(self, step: int, tree, extra: dict | None = None):
        save(self.dir, step, tree, extra)
        if not _sharded(tree) or dist.get_rank() == 0:
            self._gc()

    def restore(self, tree_like, shardings=None, step=None, device="cuda"):
        return restore(self.dir, tree_like, step=step, shardings=shardings,
                       device=device)

    def latest_step(self):
        return latest_step(self.dir)

    def _gc(self):
        if not os.path.isdir(self.dir):
            return
        ckpts = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("step_") and f.endswith(".npz")
        )
        for f in ckpts[: -self.keep]:
            os.unlink(os.path.join(self.dir, f))
