from .kernels import BMKernel, IndexKernel, VolatilityKernel
