from .means import (ConstantMean, DEWMAMean, EWMAMean, HEWMAMean, LinearMean,
                    LogLinearMean, MeanRevertingEMAMean, MulIdentityMean,
                    TEWMAMean)

__all__ = ["ConstantMean", "LinearMean", "LogLinearMean", "MulIdentityMean",
           "EWMAMean", "HEWMAMean", "DEWMAMean", "TEWMAMean",
           "MeanRevertingEMAMean"]
