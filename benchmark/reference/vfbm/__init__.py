"""A frozen copy of the plain FBM path of ``volt_tpu_torch`` that the
FBM cell drives: ``fit_forecast_batch`` with ``kernel="fbm"`` (the dense
GPCV family against the FBM prior, the dense FBM vol MLL, the dense
posterior vol sampler) and ``warm_start`` with the dense root's shift.  It
imports nothing of the program and no JAX.

The FBM modules are the program's own, trimmed to what the cell runs; the
data fit, the means, the rollout, Adam and the parameter trees are
``reference.vplain``'s, imported unchanged.
"""
