"""CP-APR and CP-ALS on sparse count tensors, in PyTorch: the solvers and
their substrate."""
from .layout import BlockedLayout, ModeStats, build_blocked_layout, mode_run_stats
from .policy import (
    SEARCH_ERRORS,
    PhiPolicy,
    default_policy,
    grid_search,
    heuristic_policy,
    model_ambiguous_prefix,
    model_top_k,
    policy_grid,
    probe_error_is_retryable,
)
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
from .dense import (
    DENSE_MAX_ELEMS,
    DenseModeData,
    build_dense_mode,
    dense_kr_factors,
)
from .phi import (
    expand_to_layout,
    krao_reduce_rows,
    phi_from_rows,
    phi_mode,
    phi_mu_step,
)
from .cpapr import (
    CPAPRConfig,
    CPAPRResult,
    cpapr_mu,
    kkt_violation,
    poisson_loglik,
)
from .cpals import cp_als, fit_score, mttkrp, mttkrp_mode
from .convert import (
    dense_mode_from_numpy,
    ktensor_from_numpy,
    policy_from_dict,
    sparse_tensor_from_numpy,
)

__all__ = [
    "BlockedLayout",
    "CPAPRConfig",
    "CPAPRResult",
    "DENSE_MAX_ELEMS",
    "DenseModeData",
    "KTensor",
    "ModeStats",
    "ModeView",
    "PhiPolicy",
    "SEARCH_ERRORS",
    "SparseTensor",
    "build_blocked_layout",
    "build_dense_mode",
    "cp_als",
    "cpapr_mu",
    "default_policy",
    "dense_from_coo",
    "dense_kr_factors",
    "dense_mode_from_numpy",
    "expand_to_layout",
    "fit_score",
    "grid_search",
    "heuristic_policy",
    "kkt_violation",
    "krao_reduce_rows",
    "ktensor_from_numpy",
    "ktensor_full",
    "mode_run_stats",
    "model_ambiguous_prefix",
    "model_top_k",
    "model_values_at",
    "mttkrp",
    "mttkrp_mode",
    "phi_from_rows",
    "phi_mode",
    "phi_mu_step",
    "pi_rows",
    "poisson_loglik",
    "policy_grid",
    "policy_from_dict",
    "probe_error_is_retryable",
    "random_ktensor",
    "random_poisson_tensor",
    "sort_mode",
    "sparse_tensor_from_numpy",
]
