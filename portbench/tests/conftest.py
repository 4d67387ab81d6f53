"""Shared pieces of the harness's CPU tests: the repository's root and
``src/`` on the path, and cells of the benchmark cut to a size the CPU
can run (dims divided by ``k``, nonzeros by ``k**2``)."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def shrunk(name: str, k: int, **traffic):
    """Cell ``name`` with its tensor cut by ``k`` and ``traffic`` changed."""
    from portbench import harness

    cell = harness.load_cell(name)
    config = dict(cell.config,
                  dims=[max(int(d) // k, 2) for d in cell.config["dims"]],
                  nnz=int(cell.config["nnz"]) // (k * k))
    return dataclasses.replace(cell, config=config,
                               traffic=dict(cell.traffic, **traffic))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card); "
                    "see portbench/README.md")
    return torch.device("cuda", 0)
