from .bmgp import BMGP, BMGPState
from .gpcv import GPCVModel, GPCVState
from .volt import VoltGP, VoltState, make_mean
from .volt_api import Volt

__all__ = ["BMGP", "BMGPState", "GPCVModel", "GPCVState", "Volt", "VoltGP",
           "VoltState", "make_mean"]
