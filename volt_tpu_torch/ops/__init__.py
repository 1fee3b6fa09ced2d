"""Numerical primitives of the port: plain tensor functions, plus the
wrappers of the hand-written CUDA kernels (``ewma``, the Kalman MLL)."""

from .bidiag import (
    affine_scan,
    bidiag_chol_from_tridiag,
    bidiag_solve_lower,
    bidiag_solve_upper,
    min_precision,
    takahashi_band,
    tridiag_q_kl_bm_prior,
)
from .brownian import (
    future_grid_ok,
    min_kernel_eigenvalues,
    min_kernel_project,
    min_kernel_spectrum,
    nan_poison,
)
from .constraints import GreaterThan, Interval, Positive, inv_softplus, softplus
from .ewma import ewma, ewma_weights
from .quadrature import expected_value, gauss_hermite_nodes
from .tridiag import (
    brownian_noise_filter,
    brownian_noise_mll_kalman,
    tridiag_ldl_pivots,
)
from .volint import cumtrapz_weights, vol_integral

__all__ = [
    "affine_scan",
    "bidiag_chol_from_tridiag",
    "bidiag_solve_lower",
    "bidiag_solve_upper",
    "min_precision",
    "takahashi_band",
    "tridiag_q_kl_bm_prior",
    "future_grid_ok",
    "min_kernel_eigenvalues",
    "min_kernel_project",
    "min_kernel_spectrum",
    "nan_poison",
    "GreaterThan",
    "Interval",
    "Positive",
    "inv_softplus",
    "softplus",
    "ewma",
    "ewma_weights",
    "expected_value",
    "gauss_hermite_nodes",
    "brownian_noise_filter",
    "brownian_noise_mll_kalman",
    "tridiag_ldl_pivots",
    "cumtrapz_weights",
    "vol_integral",
]
