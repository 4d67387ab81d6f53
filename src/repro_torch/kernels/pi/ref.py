"""Plain version of the Π-rows kernel (``csrc/pi.cu``): the Khatri-Rao rows
of the other modes gathered per sorted nonzero
(:func:`repro_torch.core.pi.pi_rows`), then expanded with the values into
the blocked layout's slot order
(:func:`repro_torch.core.phi.expand_to_layout`)."""
from __future__ import annotations

from typing import Sequence

import torch

from ...core.layout import BlockedLayout
from ...core.phi import expand_to_layout
from ...core.pi import pi_rows

__all__ = ["pi_gather_ref"]


def pi_gather_ref(layout: BlockedLayout, idx: torch.Tensor,
                  vals: torch.Tensor, factors: Sequence[torch.Tensor],
                  n: int) -> tuple:
    """``(vals_e, pi_e)``: (n_grid*block_nnz,) values and (n_grid*block_nnz,
    R) Π^(n) rows in slot order, padding slots 0."""
    return expand_to_layout(layout, vals, pi_rows(idx, factors, n))
