from .bmgp import BMGP, BMGPState
from .gpcv import GPCVModel
from .volt import VoltGP, VoltState, make_mean

__all__ = ["BMGP", "BMGPState", "GPCVModel", "VoltGP", "VoltState",
           "make_mean"]
