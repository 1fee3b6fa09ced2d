from .kernels import BMKernel, FBMKernel, IndexKernel, VolatilityKernel

__all__ = ["BMKernel", "FBMKernel", "VolatilityKernel", "IndexKernel"]
