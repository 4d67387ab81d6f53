"""LM training on one device: optimizers (:mod:`.optimizer`), error-
feedback gradient compression (:mod:`.compression`), the train step
(:mod:`.step`), checkpoints in the JAX package's format
(:mod:`.checkpoint`) and the fault-tolerant loop (:mod:`.loop`)."""
from .checkpoint import Checkpointer, latest_step, restore, save
from .compression import (
    CompressionConfig,
    compress_grads,
    init_residual,
    wire_fraction,
)
from .loop import TrainLoop, TrainLoopConfig
from .optimizer import (
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    opt_state_specs,
)
from .step import (
    init_state,
    make_prefill,
    make_serve_step,
    make_train_step,
    state_specs,
)

__all__ = [
    "Checkpointer",
    "CompressionConfig",
    "Optimizer",
    "TrainLoop",
    "TrainLoopConfig",
    "adafactor",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "compress_grads",
    "global_norm",
    "init_residual",
    "init_state",
    "latest_step",
    "make_optimizer",
    "make_prefill",
    "make_serve_step",
    "make_train_step",
    "opt_state_specs",
    "restore",
    "save",
    "state_specs",
    "wire_fraction",
]
