from .basic import SMGP, BasicGP, BasicGPState, MaternGP
from .bmgp import BMGP, BMGPState
from .gpcv import GPCVModel, GPCVState
from .lstm import LSTMModel, train_lstm
from .multitask import MultitaskBMGP, MultitaskBMGPState, MultitaskVariationalGP
from .volt import VoltGP, VoltState, make_mean
from .volt_api import Volt

# reference-name aliases (voltron/models/__init__.py:1-6)
VoltronGP = VoltGP
VoltMagpie = VoltGP
SingleTaskVariationalGP = GPCVModel
LSTM = LSTMModel

__all__ = ["BMGP", "BMGPState", "GPCVModel", "GPCVState", "Volt", "VoltGP",
           "VoltState", "make_mean", "BasicGP", "BasicGPState", "MaternGP",
           "SMGP", "MultitaskBMGP", "MultitaskBMGPState",
           "MultitaskVariationalGP", "LSTMModel", "train_lstm", "VoltronGP",
           "VoltMagpie", "SingleTaskVariationalGP", "LSTM"]
