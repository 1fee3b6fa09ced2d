from .kernels import (BMKernel, FBMKernel, IndexKernel, MaternKernel,
                      OUKernel, RBFKernel, ScaleKernel, SpectralMixtureKernel,
                      VolatilityKernel)

__all__ = ["BMKernel", "FBMKernel", "OUKernel", "VolatilityKernel",
           "MaternKernel", "RBFKernel", "ScaleKernel", "SpectralMixtureKernel",
           "IndexKernel"]
