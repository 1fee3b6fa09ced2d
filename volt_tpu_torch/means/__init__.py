from .means import ConstantMean, EWMAMean

__all__ = ["ConstantMean", "EWMAMean"]
