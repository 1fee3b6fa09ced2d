from .likelihoods import (GaussianLikelihood, MultitaskGaussianLikelihood,
                          VolatilityGaussianLikelihood)

__all__ = ["GaussianLikelihood", "MultitaskGaussianLikelihood",
           "VolatilityGaussianLikelihood"]
