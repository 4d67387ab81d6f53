"""Named host spans inside the CP-APR and CP-ALS solves, on the profiler's
own clock.

``with span(NAME):`` records one host event named ``NAME`` while
``torch.profiler`` runs (a ``--trace 1`` run of the benchmark under
``portbench/``, or an operator profiling a solve) and nothing otherwise:
with no profiler running it costs one check of the profiler's state and
a shared null context, well under a microsecond.  There is no switch.

The event is a plain operator event (``_RecordFunctionFast``), not a
user annotation: ``torch.profiler.record_function`` records the latter,
which the CUDA profiler mirrors onto the device's timeline, and costs
~13 µs per span even with no profiler running.  So a span adds no
device-side event, and the kernels launched inside it hang under it in
the profiler's event tree.

The spans are flat: none is opened inside another, so each is an
outermost host event and every idle gap of the device falls to one span
or to none.  Each count of :data:`SWEEP_SYNC` is one host read of a
device value in the sweep, so the number of such events is the solve's
host-sync counter.  The CP-ALS solve's spans (:data:`ALS_SPANS`) are a
set of their own, with :data:`ALS_ITER_SYNC` its host-sync counter: no
name is shared between the two solves.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ALS_ITER_FIT", "ALS_ITER_INPUTS", "ALS_ITER_MTTKRP",
           "ALS_ITER_SOLVE", "ALS_ITER_SYNC", "ALS_PREP_LAYOUT",
           "ALS_PREP_SORT", "ALS_PREP_VALIDATE", "ALS_SPANS", "PREP_LAYOUT",
           "PREP_SORT", "PREP_VALIDATE", "SPANS", "SWEEP_GUARD",
           "SWEEP_INPUTS", "SWEEP_LOGLIK", "SWEEP_RENORM", "SWEEP_SCOOCH",
           "SWEEP_STEP", "SWEEP_SYNC", "span"]

# the preparation, in cpapr_mu before its first sweep
PREP_VALIDATE = "cpapr.prep.validate"  # read by validate_s
PREP_SORT = "cpapr.prep.sort"  # read by sort_s
PREP_LAYOUT = "cpapr.prep.layout"  # read by layout_s
# the sweep: its mode updates and the sweep's end
SWEEP_INPUTS = "cpapr.sweep.inputs"  # read by sweep_idle_ms
SWEEP_SCOOCH = "cpapr.sweep.scooch"  # read by sweep_idle_ms
SWEEP_STEP = "cpapr.sweep.step"  # read by sweep_idle_ms
SWEEP_SYNC = "cpapr.sweep.sync"  # read by host_syncs and sweep_idle_ms
SWEEP_RENORM = "cpapr.sweep.renorm"  # read by sweep_idle_ms
SWEEP_GUARD = "cpapr.sweep.guard"  # read by sweep_idle_ms
SWEEP_LOGLIK = "cpapr.sweep.loglik"  # read by sweep_idle_ms

SPANS = (PREP_VALIDATE, PREP_SORT, PREP_LAYOUT, SWEEP_INPUTS, SWEEP_SCOOCH,
         SWEEP_STEP, SWEEP_SYNC, SWEEP_RENORM, SWEEP_GUARD, SWEEP_LOGLIK)

# cp_als: its preparation, before the first iteration
ALS_PREP_VALIDATE = "cpals.prep.validate"  # read by als_prep_s
ALS_PREP_SORT = "cpals.prep.sort"  # read by als_prep_s
ALS_PREP_LAYOUT = "cpals.prep.layout"  # read by als_prep_s
# an iteration: each mode's update, then the fit
ALS_ITER_INPUTS = "cpals.iter.inputs"  # read by als_idle_ms
ALS_ITER_MTTKRP = "cpals.iter.mttkrp"  # read by als_idle_ms
ALS_ITER_SOLVE = "cpals.iter.solve"  # read by als_idle_ms
ALS_ITER_SYNC = "cpals.iter.sync"  # read by als_host_syncs and als_idle_ms
ALS_ITER_FIT = "cpals.iter.fit"  # read by als_idle_ms

ALS_SPANS = (ALS_PREP_VALIDATE, ALS_PREP_SORT, ALS_PREP_LAYOUT,
             ALS_ITER_INPUTS, ALS_ITER_MTTKRP, ALS_ITER_SOLVE, ALS_ITER_SYNC,
             ALS_ITER_FIT)

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager that records a host event ``name`` while the
    profiler runs; the shared null context otherwise."""
    if _profiler_enabled():
        return _record(name)
    return _OFF
