"""End-to-end training driver on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --device cpu            # the reduced f32 config, on the CPU
  # stop it mid-run and run the same command again: it resumes from the
  # latest checkpoint in --ckpt-dir

Builds the model (``--full``: the published config in bf16; else its
``reduced`` f32 form) and its optimizer (``cfg.optimizer``), draws the
weights from ``--seed`` and the batches from the deterministic
``TokenPipeline``, and runs ``--steps`` steps of ``--batch`` sequences of
``--seq`` tokens through ``TrainLoop``: a checkpoint every
``--ckpt-every`` steps and at the end, resume, the straggler watchdog and
SIGTERM-safe exit.  It prints the JAX package's ``[train]`` lines, with
the device where that package prints its mesh (a mesh is not ported
yet).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..config import ShapeConfig
from ..configs import get_arch, reduced
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..models.api import build_model
from ..models.params import abstract_params, count_params
from ..train.compression import CompressionConfig
from ..train.loop import TrainLoop, TrainLoopConfig
from ..train.optimizer import make_optimizer
from ..train.step import init_state, make_train_step, state_specs

__all__ = ["main"]


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

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    comp = CompressionConfig(args.compress)
    pipeline = TokenPipeline(cfg, shape, seed=args.seed, device=dev)
    loop = TrainLoop(
        make_train_step(model, opt, compression=comp), pipeline.make_batch,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir),
        device=dev,
    )
    state, start = loop.resume_or_init(
        lambda: init_state(model, opt, args.seed, comp, device=dev),
        target=abstract_params(state_specs(model, opt, comp)))
    n_params = count_params(model.param_specs())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={dev} start_step={start}")
    state, step = loop.run(
        state, start,
        on_metrics=lambda r: print(
            f"[train] step {r['step']:5d} loss {r['loss']:.4f} "
            f"gnorm {r['grad_norm']:.3f} {r['seconds']*1e3:.0f}ms"))
    print(f"[train] done at step {step}; stragglers={len(loop.straggler_events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
