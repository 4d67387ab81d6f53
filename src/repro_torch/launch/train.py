"""End-to-end training driver on a ``("data", "model")`` mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --device cpu            # the reduced f32 config, on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch olmo-1b --device cpu     # a 2 x 2 mesh of gloo ranks
  # stop it mid-run and run the same command again: it resumes from the
  # latest checkpoint in --ckpt-dir

Builds the model (``--full``: the published config in bf16; else its
``reduced`` f32 form) and its optimizer (``cfg.optimizer``), draws the
weights from ``--seed`` and the batches from the deterministic
``TokenPipeline``, and runs ``--steps`` steps of ``--batch`` sequences of
``--seq`` tokens through ``TrainLoop``: a checkpoint every
``--ckpt-every`` steps and at the end, resume, the straggler watchdog and
SIGTERM-safe exit.

The mesh is ``make_smoke_mesh`` over every rank of the process group: the
group it finds, else the one ``torchrun`` describes in the environment,
else a group of this one process (NCCL on the card, gloo with
``--device cpu``), which it destroys on exit.  The state and each batch
are DTensors with the active rules' placements (``state_shardings``,
``batch_shardings``).  Rank 0 prints the JAX package's ``[train]`` lines.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from ..config import ShapeConfig
from ..configs import get_arch, reduced
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..models.api import build_model
from ..models.params import abstract_params, count_params, tree_map
from ..train.compression import CompressionConfig
from ..train.loop import TrainLoop, TrainLoopConfig
from ..train.optimizer import make_optimizer
from ..train.step import init_state, make_train_step, state_specs
from .mesh import batch_shardings, make_smoke_mesh, state_shardings

__all__ = ["main"]


@contextlib.contextmanager
def process_group(dev: torch.device):
    """The default process group for the body, and this rank's device: the
    group already open, else ``torchrun``'s (``env://``), else a group of
    this one process on an in-memory store.  A group it opened is
    destroyed on exit."""
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    opened = not dist.is_initialized()
    if opened and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif opened:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield dev
    finally:
        if opened:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) arch config")
    ap.add_argument("--compress", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    with process_group(resolve_device(args.device)) as dev:
        return _run(args, dev)


def _run(args, dev: torch.device) -> int:
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh = make_smoke_mesh(dev.type)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    comp = CompressionConfig(args.compress)

    sspecs = state_specs(model, opt, comp)
    s_sh = state_shardings(sspecs, mesh)
    in_sh = batch_shardings(model.input_specs(shape), mesh)
    pipeline = TokenPipeline(cfg, shape, seed=args.seed, device=dev,
                             shardings=in_sh)
    loop = TrainLoop(
        make_train_step(model, opt, compression=comp), pipeline.make_batch,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir),
        device=dev, state_shardings=s_sh,
    )

    def fresh():
        state = init_state(model, opt, args.seed, comp, device=dev)
        return tree_map(lambda x, sh: sh.place(x), state, s_sh)

    state, start = loop.resume_or_init(fresh, target=abstract_params(sspecs))
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    n_params = count_params(model.param_specs())
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
        f"mesh={mesh_shape} start_step={start}")
    state, step = loop.run(
        state, start,
        on_metrics=lambda r: say(
            f"[train] step {r['step']:5d} loss {r['loss']:.4f} "
            f"gnorm {r['grad_norm']:.3f} {r['seconds']*1e3:.0f}ms"))
    say(f"[train] done at step {step}; stragglers={len(loop.straggler_events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
