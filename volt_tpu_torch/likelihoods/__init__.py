from .likelihoods import GaussianLikelihood, VolatilityGaussianLikelihood

__all__ = ["GaussianLikelihood", "VolatilityGaussianLikelihood"]
