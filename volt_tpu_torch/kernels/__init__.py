from .kernels import BMKernel, VolatilityKernel

__all__ = ["BMKernel", "VolatilityKernel"]
