"""Decompose a FROSTT-shaped tensor on the PyTorch port: the platform's
heuristic policy, CP-APR MU, and distributed CP-APR over every rank of
the process group.

  PYTHONPATH=src python examples/decompose_frostt_torch.py --tensor uber
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples/decompose_frostt_torch.py --distributed
"""
import argparse

import torch.distributed as dist

from repro_torch.core import CPAPRConfig, cpapr_mu
from repro_torch.core.distributed import DistCPAPRConfig, dist_cpapr_mu
from repro_torch.core.policy import heuristic_policy
from repro_torch.data.tensors import TENSOR_NAMES, make_tensor
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.train import process_group


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber", choices=TENSOR_NAMES)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--distributed", action="store_true",
                    help="run distributed CP-APR when the process group "
                         "(torchrun's, else this one process) has more "
                         "than one rank")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if not args.distributed:
        return _run(args, dev, distributed=False)
    with process_group(dev) as dev:
        return _run(args, dev, distributed=dist.get_world_size() > 1)


def _run(args, dev, distributed: bool) -> int:
    say = (print if not dist.is_initialized() or dist.get_rank() == 0
           else (lambda *a, **k: None))
    t, _ = make_tensor(args.tensor, scale=args.scale, rank=args.rank,
                       device=dev)
    say(f"{args.tensor}: {t.shape}, nnz={t.nnz}")

    # the platform the tensor lives on, as the reference's lives on JAX's
    # default backend
    pol = heuristic_policy(t.nnz, t.shape[0], args.rank, platform=dev.type)
    say(f"heuristic policy for this platform: {pol.label()}")

    if distributed:
        mesh = make_smoke_mesh(dev.type)
        say(f"distributed CP-APR on mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        _, hist = dist_cpapr_mu(
            t, args.rank, mesh,
            config=DistCPAPRConfig(rank=args.rank, max_outer=5), device=dev)
        say("KKT history:", [f"{h:.4f}" for h in hist])
    else:
        res = cpapr_mu(t, args.rank,
                       config=CPAPRConfig(rank=args.rank, max_outer=5,
                                          strategy=pol.strategy),
                       device=dev)
        say("KKT history:", [f"{h:.4f}" for h in res.kkt_history])
        say("loglik:", [f"{x:.0f}" for x in res.loglik_history])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
