"""A FROSTT-shaped sparse count tensor drawn on the device from a seed.

The generative model CP-APR assumes, as the port's ``data/tensors.py``
draws it on the host: a planted rank-R Kruskal model (factor entries
uniform in [0.1, 1), columns summing to one, weights uniform in
[0.5, 2)); ``nnz`` candidate nonzeros, each from a component drawn in
proportion to its weight and one row per mode drawn from that
component's column; values Poisson(1) + 1; duplicate coordinates merged
by summing their values, so the stored tensor holds a little fewer.

Everything is drawn by one ``torch.Generator`` on ``device`` in a few
large calls, so the same seed gives the same tensor on one device, and
nell2's 77M nonzeros take well under a second on an H100.
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["draw_start", "make", "stream_seed"]


def stream_seed(label: str, seed: int) -> int:
    """The generator seed of stream ``label`` for run seed ``seed``: a crc32
    of the label mixed into the seed, kept to 64 bits."""
    return (zlib.crc32(label.encode()) ^ int(seed)) & 0xFFFF_FFFF_FFFF_FFFF


def _generator(label: str, seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(label, seed))
    return g


def _ktensor(g, dims, rank: int, device) -> tuple:
    """(lam, factors) in float64: factors uniform in [0.1, 1) with unit
    column sums, lam uniform in [0.5, 2)."""
    factors = []
    for d in dims:
        f = torch.rand((int(d), rank), generator=g, device=device,
                       dtype=torch.float64) * 0.9 + 0.1
        factors.append(f / f.sum(dim=0, keepdim=True))
    lam = torch.rand(rank, generator=g, device=device,
                     dtype=torch.float64) * 1.5 + 0.5
    return lam, factors


def _rows(g, f: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
    """One row per sample of column ``comp`` of ``f`` (unit column sums), by
    inverse CDF: the columns' CDFs are laid end to end, column r shifted by
    r, so one ``searchsorted`` serves every component."""
    n_rows, rank = f.shape
    cdf = torch.cumsum(f, dim=0).T + torch.arange(
        rank, device=f.device, dtype=f.dtype)[:, None]
    u = torch.rand(comp.shape[0], generator=g, device=f.device,
                   dtype=f.dtype) + comp.to(f.dtype)
    pos = torch.searchsorted(cdf.reshape(-1).contiguous(), u)
    return (pos - comp * n_rows).clamp_(0, n_rows - 1)


def make(config: dict, seed: int, device) -> tuple:
    """``(indices (nnz, N) int64, values (nnz,) float32, info)`` of the
    configuration's tensor for ``seed`` on ``device``; ``info`` holds the
    nnz drawn and stored."""
    dims = [int(d) for d in config["dims"]]
    nnz, rank = int(config["nnz"]), int(config["planted_rank"])
    g = _generator(config["name"], seed, device)
    lam, factors = _ktensor(g, dims, rank, device)
    comp = torch.searchsorted(torch.cumsum(lam / lam.sum(), 0),
                              torch.rand(nnz, generator=g, device=device,
                                         dtype=torch.float64))
    comp.clamp_(0, rank - 1)
    lin = torch.zeros(nnz, dtype=torch.int64, device=device)
    for d, f in zip(dims, factors):
        lin.mul_(d).add_(_rows(g, f, comp))
    del comp
    vals = torch.poisson(torch.ones(nnz, device=device), generator=g) + 1.0
    uniq, inv = torch.unique(lin, sorted=True, return_inverse=True)
    del lin
    values = torch.zeros(uniq.shape[0], device=device,
                         dtype=torch.float32).index_add_(0, inv, vals)
    del inv, vals
    indices = torch.empty((uniq.shape[0], len(dims)), dtype=torch.int64,
                          device=device)
    for n in range(len(dims) - 1, -1, -1):
        indices[:, n] = uniq % dims[n]
        uniq = uniq // dims[n]
    return indices, values, {"nnz_drawn": nnz,
                             "nnz_stored": int(values.shape[0])}


def draw_start(dims, rank: int, seed: int, device) -> tuple:
    """The solve's starting model for ``seed``: ``(lam, factors)`` in float32,
    drawn as the planted model is, from a stream of its own."""
    g = _generator("start", seed, device)
    lam, factors = _ktensor(g, [int(d) for d in dims], int(rank), device)
    return lam.float(), [f.float() for f in factors]
