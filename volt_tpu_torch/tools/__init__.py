"""The tools: the forecast-quality harnesses that make every table of
``EVALUATION.md`` and the timing harnesses, on the port (one module per
script of the JAX package's ``tools/``): ``python -m volt_tpu_torch.tools.<name>`` with the
JAX script's flags and ``--device`` (default ``cuda``; ``--device cpu``
off the card).  Each module's ``main(argv)`` takes the command line as a
list and returns what it printed.

``eval_compare`` (Volt against the Matérn, spectral-mixture and LSTM
baselines), ``eval_options`` (option values against an oracle),
``eval_multitask`` (what the Kronecker coupling buys), ``wind_sweep``,
``robustness_sweep``, ``eval_integral_rule``, ``sparse_quality`` and
``gpcv_convergence``.  ``jax_reference.json`` holds the JAX package's
metrics at the settings ``chip_smoke.py``'s ``evaluation`` phase runs,
with the band each must lie in (made by ``tests/torch_eval_reference.py``).

The timing tools, each printing its first call beside its warm best:
``ablate_stages`` (the stage split), ``bench_refit`` and
``bench_refit_multitask`` (the warm refit of live serving),
``bench_multitask`` (the Kronecker chain per T), ``bench_scaling`` and
``scaling_study`` (the n-scaling), ``bench_fbm`` (the FBM path's cost per
n), ``bench_voltcov`` (kernel K2 against its plain twin) and
``bench_compile`` (the time to first forecast in a fresh process that
builds the kernels).
"""
