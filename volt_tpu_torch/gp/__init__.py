from .variational import exp_laplace_inv_hessian, running_std_latent_init

__all__ = ["exp_laplace_inv_hessian", "running_std_latent_init"]
