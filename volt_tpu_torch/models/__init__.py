from .bmgp import BMGP, BMGPState
from .gpcv import GPCVModel, GPCVState
from .multitask import MultitaskBMGP, MultitaskBMGPState, MultitaskVariationalGP
from .volt import VoltGP, VoltState, make_mean
from .volt_api import Volt

# reference-name aliases (voltron/models/__init__.py:1-6)
VoltronGP = VoltGP
VoltMagpie = VoltGP
SingleTaskVariationalGP = GPCVModel

__all__ = ["BMGP", "BMGPState", "GPCVModel", "GPCVState", "Volt", "VoltGP",
           "VoltState", "make_mean", "MultitaskBMGP", "MultitaskBMGPState",
           "MultitaskVariationalGP", "VoltronGP", "VoltMagpie",
           "SingleTaskVariationalGP"]
