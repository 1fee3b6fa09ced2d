"""A frozen copy of the plain paths of ``volt_tpu_torch`` that the cells
drive: ``fit_forecast_batch`` and ``fit_forecast_multitask`` with their
stages, and the warm starts.  It imports nothing of the program.

Where the program launches a CUDA kernel, the copy runs the kernel's
plain version: K1 as a ``conv1d``, K2 as the plain min-index expansion,
K3 as the Gauss-Hermite node sum, and S1's Kalman MLL in its equivalent
scan form (``ops.tridiag.brownian_noise_mll``).  The modules are the
program's own, trimmed to what these entries use, so that a later change
to the program is held to what it computed when the benchmark was made.
"""
