from .exact import exact_mll, posterior
from .natural import ngvi_tridiag_fit, tridiag_matvec
from .variational import exp_laplace_inv_hessian, running_std_latent_init

__all__ = ["exact_mll", "posterior", "ngvi_tridiag_fit", "tridiag_matvec",
           "exp_laplace_inv_hessian", "running_std_latent_init"]
