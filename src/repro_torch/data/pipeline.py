"""Deterministic synthetic token pipeline (stateless in ``step``).

``make_batch(step)`` is a pure function of (seed, step), so a resumed run
replays exactly the batches it would have seen.  The draws come from
numpy's ``SeedSequence([seed, step, 0xD47A])`` in the JAX package's order
(its batch names in ``input_specs`` order; tokens uniform in [0, vocab),
embeddings ``standard_normal * 0.02`` in f32 cast to the spec's dtype), so
the batches are that package's, bit for bit, on ``device``.  With
``shardings`` ({name: ``NamedSharding``}, ``launch.mesh.batch_shardings``)
each leaf is placed on the mesh as a DTensor: every rank draws the same
batch and keeps its own rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ArchConfig, ShapeConfig
from ..device import resolve_device

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    shardings: dict | None = None  # name -> NamedSharding (optional)
    device: str = "cuda"

    def __post_init__(self):
        self._dev = resolve_device(self.device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xD47A]))

    def batch_shapes(self) -> dict:
        """{name: (shape, dtype)} of a batch."""
        from ..models.api import build_model

        return build_model(self.cfg).input_specs(self.shape)

    def make_batch(self, step: int) -> dict:
        rng = self._rng(step)
        out = {}
        for name, (shape, dtype) in self.batch_shapes().items():
            if dtype == torch.int32:
                arr = rng.integers(0, self.cfg.vocab, size=shape,
                                   dtype=np.int32)
            else:
                arr = (rng.standard_normal(shape) * 0.02).astype(np.float32)
            x = torch.from_numpy(arr).to(self._dev, dtype=dtype)
            if self.shardings and name in self.shardings:
                x = self.shardings[name].place(x)
            out[name] = x
        return out
