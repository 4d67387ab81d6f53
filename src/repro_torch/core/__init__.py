"""CP-APR on sparse count tensors, in PyTorch: the solver and its substrate."""
from .layout import BlockedLayout, ModeStats, build_blocked_layout, mode_run_stats
from .policy import PhiPolicy, default_policy, heuristic_policy
from .sparse_tensor import (
    KTensor,
    ModeView,
    SparseTensor,
    dense_from_coo,
    ktensor_full,
    model_values_at,
    random_ktensor,
    random_poisson_tensor,
    sort_mode,
)
from .pi import pi_rows
from .phi import expand_to_layout, phi_from_rows, phi_mode, phi_mu_step
from .cpapr import (
    CPAPRConfig,
    CPAPRResult,
    cpapr_mu,
    kkt_violation,
    poisson_loglik,
)
from .convert import ktensor_from_numpy, policy_from_dict, sparse_tensor_from_numpy

__all__ = [
    "BlockedLayout",
    "CPAPRConfig",
    "CPAPRResult",
    "KTensor",
    "ModeStats",
    "ModeView",
    "PhiPolicy",
    "SparseTensor",
    "build_blocked_layout",
    "cpapr_mu",
    "default_policy",
    "dense_from_coo",
    "expand_to_layout",
    "heuristic_policy",
    "kkt_violation",
    "ktensor_from_numpy",
    "ktensor_full",
    "mode_run_stats",
    "model_values_at",
    "phi_from_rows",
    "phi_mode",
    "phi_mu_step",
    "pi_rows",
    "poisson_loglik",
    "policy_from_dict",
    "random_ktensor",
    "random_poisson_tensor",
    "sort_mode",
    "sparse_tensor_from_numpy",
]
