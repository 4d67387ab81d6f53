"""Fault-tolerant training loop, on one device or a mesh.

  * checkpoint every ``ckpt_every`` steps (atomic, rolling window), at the
    end, and on SIGTERM/SIGINT (the current step finishes, is saved, and
    the loop returns);
  * resume from the latest checkpoint: the data pipeline is stateless in
    ``step``, so the replay is exact;
  * ``device=`` says where a restored state is placed, or
    ``state_shardings=`` (a ``NamedSharding`` tree) the mesh layout it is
    placed in: the elastic re-mesh, a checkpoint of any mesh restored
    onto this one;
  * straggler watchdog: each step's wall time against the rolling median
    of the last ``straggler_window`` steps, from the sixth step on; a step
    slower than ``straggler_factor`` times it is logged as an event.

Each step waits for its loss with a host read, so the step times are the
device's and not the launch queue's.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable

import numpy as np

from ..device import resolve_device
from ..models.params import tree_map
from .checkpoint import Checkpointer

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 20


class TrainLoop:
    def __init__(self, train_step: Callable, make_batch: Callable,
                 cfg: TrainLoopConfig, state_shardings=None, device="cuda"):
        self.train_step = train_step
        self.make_batch = make_batch
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state_shardings = state_shardings
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.step_times: list = []
        self.straggler_events: list = []
        self.history: list = []
        self._stop = False

    # -- fault-tolerance plumbing -------------------------------------------
    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._stop = True  # finish the current step, checkpoint, exit

        self._old = {
            s: signal.signal(s, handler) for s in (signal.SIGTERM, signal.SIGINT)
        }

    def _restore_signal_handlers(self):
        for s, h in getattr(self, "_old", {}).items():
            signal.signal(s, h)

    def resume_or_init(self, init_state_fn: Callable, target=None):
        """(state, start_step): restored onto ``self.device`` (or placed
        with ``self.state_shardings``) if a checkpoint exists, else
        ``init_state_fn()``.  ``target`` is the
        state's structure as tensors (meta tensors from
        ``abstract_params(state_specs(...))`` cost no memory); without it
        ``init_state_fn`` runs once to give it."""
        last = self.ckpt.latest_step()
        if last is None:
            return init_state_fn(), 0
        if target is None:
            target = tree_map(lambda t: t.to("meta"), init_state_fn())
        return self.ckpt.restore(target, device=self.device,
                                 shardings=self.state_shardings)

    # -- straggler watchdog ---------------------------------------------------
    def _watch(self, step: int, dt: float):
        w = self.cfg.straggler_window
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-w:]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(
                    {"step": step, "seconds": dt, "median": med}
                )
        self.step_times.append(dt)

    # -- main loop -------------------------------------------------------------
    def run(self, state, start_step: int = 0, on_metrics: Callable | None = None):
        self._install_signal_handlers()
        step = start_step
        try:
            while step < self.cfg.total_steps and not self._stop:
                batch = self.make_batch(step)
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                step += 1
                self._watch(step, dt)
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "seconds": dt}
                self.history.append(rec)
                if on_metrics:
                    on_metrics(rec)
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state, extra={"wall": time.time()})
            # final / preemption checkpoint
            self.ckpt.save(step, state, extra={"wall": time.time(),
                                               "preempted": self._stop})
        finally:
            self._restore_signal_handlers()
        return state, step
