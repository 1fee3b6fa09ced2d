from .exact import (FixedCovCache, exact_mll, exact_mll_fixed_cov,
                    make_fixed_cov_cache, posterior)
from .kronecker import (kron_kl, kron_kl_bm_prior, kron_kl_bm_prior_tridiag,
                        kron_mvn_log_prob, kron_mvn_log_prob_blockdiag,
                        kron_mvn_log_prob_blockdiag_lowrank, kron_posterior)
from .natural import ngvi_tridiag_fit, tridiag_matvec
from .variational import (VariationalState, elbo_at_inducing,
                          elbo_at_inducing_whitened, exp_laplace_inv_hessian,
                          laplace_initialize, running_std_latent_init,
                          variational_predict, variational_predict_whitened)

__all__ = ["exact_mll", "posterior", "FixedCovCache", "make_fixed_cov_cache",
           "exact_mll_fixed_cov", "ngvi_tridiag_fit", "tridiag_matvec",
           "VariationalState", "elbo_at_inducing", "elbo_at_inducing_whitened",
           "variational_predict", "variational_predict_whitened",
           "laplace_initialize", "exp_laplace_inv_hessian",
           "running_std_latent_init", "kron_mvn_log_prob",
           "kron_mvn_log_prob_blockdiag",
           "kron_mvn_log_prob_blockdiag_lowrank", "kron_kl_bm_prior",
           "kron_kl_bm_prior_tridiag", "kron_kl", "kron_posterior"]
