"""Test-only helpers of the port: the fault-injection harness
(:mod:`repro_torch.testing.faults`).  Imports neither jax nor the JAX
package, so the on-card tests can use it."""
from . import faults  # noqa: F401

__all__ = ["faults"]
