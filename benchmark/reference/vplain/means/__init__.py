from .means import ConstantMean, EWMAMean
