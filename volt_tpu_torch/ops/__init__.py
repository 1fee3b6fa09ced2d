"""Numerical primitives of the port: plain tensor functions, plus the
wrappers of the hand-written CUDA kernels (``ewma``, the Kalman MLL,
``volt_covariance``, ``gh_expected_log_prob``)."""

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
from .chol import (
    add_jitter,
    cholesky_solve,
    psd_safe_cholesky,
    solve_lower_triangular,
    solve_upper_triangular,
    tril_inverse_quad,
)
from .constraints import GreaterThan, Interval, Positive, inv_softplus, softplus
from .ewma import ewma, ewma_weights, window_append, window_init, window_value
from .fbm import fbm_cholesky, fbm_increment_cov, fbm_noise_cholesky
from .gh_ell import gh_expected_log_prob
from .mvn import conditional, mvn_kl, mvn_log_prob, mvn_log_prob_chol, sample_mvn
from .quadrature import DEFAULT_NUM_LOCS, expected_value, gauss_hermite_nodes
from .tridiag import (
    brownian_noise_filter,
    brownian_noise_mll,
    brownian_noise_mll_kalman,
    tridiag_ldl_pivots,
    tridiag_solve,
)
from .volint import (brownian_cholesky, cumtrapz_weights,
                     min_index_covariance, vol_integral)
from .volt_cov import volt_covariance

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
    "add_jitter",
    "cholesky_solve",
    "psd_safe_cholesky",
    "solve_lower_triangular",
    "solve_upper_triangular",
    "tril_inverse_quad",
    "GreaterThan",
    "Interval",
    "Positive",
    "inv_softplus",
    "softplus",
    "ewma",
    "ewma_weights",
    "window_append",
    "window_init",
    "window_value",
    "fbm_cholesky",
    "fbm_increment_cov",
    "fbm_noise_cholesky",
    "gh_expected_log_prob",
    "conditional",
    "mvn_kl",
    "mvn_log_prob",
    "mvn_log_prob_chol",
    "sample_mvn",
    "DEFAULT_NUM_LOCS",
    "expected_value",
    "gauss_hermite_nodes",
    "brownian_noise_filter",
    "brownian_noise_mll",
    "brownian_noise_mll_kalman",
    "tridiag_ldl_pivots",
    "tridiag_solve",
    "brownian_cholesky",
    "cumtrapz_weights",
    "min_index_covariance",
    "vol_integral",
    "volt_covariance",
]
