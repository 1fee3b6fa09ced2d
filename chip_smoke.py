#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``volt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root::

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 off for matmuls and cuDNN (the plain EWMA is a cuDNN
   convolution, and the dense path's Cholesky solves and products must
   stay float32);
2. build: compile the hand-written kernels from ``volt_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. kernels against their plain PyTorch versions on the card, float32, at
   the shapes their paths give them, timed with CUDA events: each kernel
   per call through its wrapper (``ms``: 20 back-to-back calls) and on
   the device alone (``device_ms``: launches captured in a CUDA graph
   and replayed, cycling through copies of the inputs that together hold
   twice the 50 MB L2, so that each launch reads from HBM as ``bound_ms``
   assumes); the plain versions and the library call per call, the
   library call also on the device alone (the plain Kalman loop: one call
   per run):
   K1 (EWMA filter, a recurrence run in float64: max abs error <= 1e-6
   max|y| from a float64 run of the plain conv1d and <= 1e-5 max|y| from
   the float32 run, at the shapes and k of ``EWMA_CHECKED``; timed at
   (64, 999) with k=300, 100 and 25, at (500, 999) with k=300 and at the
   multitask path's (505, 999) with k=25, cuDNN's conv1d beside it); S1
   (Kalman MLL forward and adjoint, a chunked scan computed in float64
   inside, at the shapes of ``KALMAN_SHAPES``, up to (16, 16000) and
   (1, 25000), by
   ``ops.tridiag.kalman_agreement``: every tensor from a float64 run of
   the plain loop (the plain loops run on the CPU, in worker processes
   started before K1's check, on the card's inputs), value and final
   state at rtol 1e-5, gradients at rtol 1e-4, atol 1e-6 of the largest,
   since d/dv differences neighbouring
   d/d(delta); the float32 loop's own distance from it printed beside,
   and the largest share of the tolerance S1 used); K2 (dense
   Volt covariance: exact, it copies values of the integral; its gradient
   rtol 1e-5); K3 (GH-75 expected log-likelihood, the fused path: one
   forward keeping the gradient's node sums, an elementwise backward; at
   (64, 999), (500, 999) and (3, 37) on inputs in both clamp regions:
   forward rtol 1e-5 with atol 1e-6 for sums that cancel to near zero;
   gradients as S1's, d/dvar plus the float32 error bound of its 75-term
   node sum, which cancels to a value proportional to sd:
   ``ops.gh_ell.var_grad_resolution``; timed at (64, 999) and (500, 999),
   forward, backward and the two together, and the forward at each node
   split); G1 (the tridiagonal GPCV ELBO and its gradient in one launch,
   float64 inside: against the plain composition in float64 on the same
   float32 values at (64, 999), (505, 999) and (3, 37), each within 1e-5
   of its largest value; timed at (64, 999) and (505, 999), with and
   without the gradient, the plain composition's forward and backward
   beside); G2 (the BM vol GP's spectral MLL and its gradient in one
   launch, float64 inside: against the plain composition in float64 on
   the same float32 values at (505, 999), (64, 999) and (3, 37), each
   within 1e-5 of its largest value; timed at (505, 999) and (64, 999) as
   G1); G3 (the multitask model's joint tridiagonal GPCV ELBO and its
   gradient in one call, float64 inside: against the plain composition in
   float64 on the same float32 values at (n, T, r) = (999, 505, 1),
   (64, 8, 2) and (3, 2, 1), each within 1e-5 of its largest value; timed
   at (999, 505, 1) as G1); G4 (the multitask vol GP's Woodbury MLL and
   its gradient in one call, float64 inside, its T x T coupling float32:
   against the plain composition in float64 on the same float32 values at
   (N, T, r) = (999, 505, 1) with c < 0, the MLL within 1e-6 of its value
   and each gradient within 1e-4 of its largest entry; timed there, the
   plain composition's forward and backward beside);
4. the main path at full width: ``fit_forecast_batch`` on 64 SABR series
   of 999 returns with the ``PipelineConfig`` defaults (300/300/300 Adam
   steps, EWMA k=300, 1000 paths x 100 steps, quantile fan), then once
   with ``output="samples"``.  Checks: finite outputs of the right shape,
   every ``ok``, a fan non-decreasing across levels, the recovered vol
   within an order of magnitude of the true SABR vol, and K1 and S1
   launched during the run (launch counts reset just before it);
5. the reference API on one SABR asset (1000 prices, H=100):
   ``Volt(mean="ewma", k=300).Train()`` with its defaults (400 NGVI, 1000
   vol, 400 data iterations) and ``Forecast(nsample=1000)``: shape and
   finite values; the dense MLL (K2) against the Kalman MLL (S1) of the
   same state, rel 1e-4, and the fixed-covariance MLL (K2, then ``eigh``)
   against the dense one, rel 1e-3; ``rollouts_dense`` (K2 every step)
   against the Markov rollout on the same vol paths and normals, S=64,
   H=10, atol 5e-4 per path; K1, S1 and K2 launched;
6. ``fixed_cov``: the 64 states that phase 4 fitted (its vol paths and
   data-model parameters on its series): ``VoltGP.make_cov_cache`` (K2,
   ``(64, 999, 999)`` float32, 255.7 MB, then a batched float32 ``eigh``,
   MAGMA's on the card) and ``mll_fixed_cov`` with its gradient in the
   data model's parameters, held to the Kalman MLL of the same states (S1
   forward and adjoint): values rel 1e-3, gradients rtol 5.4e-2 with atol
   1e-5 of the largest (``FIXED_COV_*_RTOL``: the JAX package's 1e-3, or
   for the gradient three times the JAX package's own float32 distance
   from float64 on these states, which misses 1e-3: its float32 ``eigh``
   sets the error); S1 also against the same form with its ``eigh`` in
   float64, rel 1e-5 (gradients with atol 1e-7 of the largest); each
   lane's share of each tolerance printed, with the times of K2,
   ``make_cov_cache`` and each MLL with its gradient; K2 and S1 launched;
7. GPCV with the GH-75 term (K3) on 64 SABR series of 999 returns:
   ``learn_gpcv(ell_method="quadrature")`` by 300 Adam steps and by 30
   NGVI iterations, each predicted scale against the closed-form fit of
   the same input (the two ELL forms differ below float32 resolution, but
   Adam's normalised step m / sqrt(v) turns that into parameter moves of up
   to lr where a gradient is near zero: rtol 2e-2 after 300 Adam steps;
   NGVI's Newton-like steps keep rtol 2e-4, on a grid that starts one step
   in: at x = 0 the BM prior's variance is zero, and d/dvar of the GH term
   there is below float32 resolution, which NGVI's curvature step takes
   as it is); K3 forward and backward launched;
8. ``gpcv_full``: ``fit_forecast_batch`` with ``gpcv_q="full"`` (the dense
   variational root, ``(64, 999, 999)``) on phase 4's series, quantiles,
   the other defaults.  Checks: every ``ok``, a finite fan non-decreasing
   across levels, the vol band; prints the stage seconds and the median
   relative difference of its vol from phase 4's tridiagonal fit;
9. ``gpcv_cv``: ``learn_gpcv(param="cv")`` on the same series, 30 NGVI
   iterations, then 300 Adam steps.  Checks: every series finite, the vol
   band; prints the difference from the exp fit of each;
10. ``gpcv_sparse``: ``learn_gpcv_sparse`` on one SABR series of n=16000
   with 256 inducing points and its default 1000 Adam steps.  Checks: a
   finite scale, the vol band, the returned model's
   ``predicted_scale()`` equal to the returned scale (rtol 1e-6);
11. ``option_pricing``: ``price_options_batch`` at the BASELINE
   configuration: 500 SABR series, n=999, 10000 paths of H=100 steps
   (``output="samples"``), 21 strikes from 0.8x to 1.2x the median last
   price, expiries at steps (4, 20, 62, 99), the realised prices from each
   series' own continuation.  Checks: values finite, >= 0 and not rising
   with the strike (rel 1e-5); finite forwards; percentiles in [0, 1];
   every ``ok``; K1 and S1 launched.  Prints the stage seconds, the
   payoff grid's, rollout path-steps per second, the peak memory,
   ``calibration(percentiles)`` and the mean CRPS over 64 assets;
12. ``fbm_path``: ``fit_forecast_batch(PipelineConfig(kernel="fbm"))`` on
   phase 4's series with the defaults (quantiles) but 100 Adam steps a
   stage (the defaults' 300 cut to make room for the evaluation phase),
   which resolve to the
   dense GPCV family, the dense FBM vol MLL through the increment-domain
   factor and the dense vol sampler.  Checks: every ``ok``, a finite fan
   non-decreasing across levels, finite Hurst parameters (printed), the
   vol band, K1 and S1 launched; prints the stage seconds and the peak
   memory;
13. ``multitask``: ``fit_forecast_multitask`` at
   ``tools/bench_refit_multitask.py``'s defaults (505 SABR series, 999
   returns, H=100, 100 paths, 300 steps a stage, quantiles), cold, then a
   warm refit from ``warm_start_multitask(aux, shift=1)`` with 30 steps a
   stage on the window slid by one tick.  Checks each time: every ``ok``,
   the fan, K1 and S1 launched; the warm vol paths within a median 0.1
   (relative) of the cold fit's on the shared ticks; prints the stage
   seconds and the peak memory;
14. ``long_main_path``: ``fit_forecast_batch`` with the defaults at B=16,
   n=16000 on the simulation's own step (the vol stage's projection is the
   FFT).  Checks: finite paths, every ``ok``, the vol band, K1 and S1
   launched;
15. ``baselines``: the baseline GPs, the LSTM and the paper's experiment
   drivers at the published backtest widths, their steps cut (the
   published depth in brackets) to make room for the evaluation phase,
   each item timed with its launch counts and peak memory:
   ``generate_basic_predictions`` on the ``AAA`` fixture (520 closes read
   from its CSV, 2 windows of ntrain=400, 200 Adam steps (600), 1000 paths
   of H=100) with a spectral mixture of 15 and EWMA k=400 (the
   autoregressive ``nonvol_rollouts``) and with a scaled Matérn and the
   log-linear mean (the joint posterior); ``basic_wind_rollouts`` (RBF,
   EWMA k=200, 200 steps (500), 200 paths) and ``wind_volt_window``
   (constant mean, and EWMA k=400; 1000 paths, theta 0.01) on a
   ``wind_windows`` window; the LSTM at ``lstm_generator.py``'s widths,
   50 epochs (200), on two ``AAA`` windows; ``run_multitask_wind`` on 4
   synthetic stations (H=126, k=400, 100 GPCV and 100 vol steps (200,
   400)); ``forecast_generator.main`` over the fixtures (``--kernel volt
   --ntimes 2 --save --train_iters 100`` (300)).  The items run at PyTorch's
   default precision, as their CLIs do (cuDNN's LSTM may use TF32; every
   other phase and check runs with TF32 off).  Checks: shapes and finite
   samples, the files under the JAX package's names, K1 launched in the
   EWMA items and S1 in the constant-mean Volt fit, every K1 and S1
   launch of the items at a shape that phase 1 holds against the plain
   version, and the card's ``nonvol_rollouts`` against
   ``nonvol_rollouts_dense`` on the same normals (S=64, H=10, atol 5e-4
   per path);
16. ``mesh``: the scale-out layer (``run_mesh``): the main path (100 Adam
   steps a stage, from 300) in a world of one process over NCCL against
   the unsharded call; a world of two processes on the card (gloo) with
   the main path on a (2, 1) mesh and ``price_options_batch`` at 500 x 10k
   x 100 on a (1, 2) mesh, each against the unsharded call; a checkpoint
   round trip; a profiler trace that names K1's and S1's kernels;
   ``graft_entry.entry()``; the ``live_serving`` and ``option_pricing``
   examples at their defaults but ``--iters 100`` (300); every K1 and S1
   launch at a shape that phase 3 checks;
17. ``evaluation``: the forecast-quality tools of
   ``volt_tpu_torch/tools`` at the evaluation's widths (ntrain 252 for
   the price universes, 400 for the wind one, H=20, S=256 (1024 for
   options), 300 Adam steps a stage, 400 for the basic GPs, an LSTM of
   hidden 64 for 40 epochs) with the windows cut: ``eval_compare``'s volt
   lane on GBM, SABR and WINDGUST at W=32, its Matérn, spectral-mixture
   and LSTM lanes on GBM at W=4, ``eval_options`` on GBM (volt and
   ``oracle-mc``) at W=16, ``eval_multitask`` at W=1, T=4.  Every metric
   within its band of the JAX package's value with key 0
   (``volt_tpu_torch/tools/jax_reference.json``: max(3 x the spread over
   eight further keys, a floor)), every volt window ``ok``, K1 and S1
   launched at shapes that phase 3 checks; each item's seconds and the
   phase's peak memory printed;
18. agreement on a small input: the card's run equals the CPU run (the
   plain versions, which the repository's tests hold against the JAX
   package): the main path within the pipeline parity tolerances; the
   dense family's Laplace init on ``S = R R^T`` (1e-3 of its largest
   entry; cuSOLVER's and LAPACK's jitter ladders may part at the edge of
   float32) and its pipeline; a cv fit (rtol 1e-3);
   ``price_options_batch`` (values rtol 2e-3, atol 1e-3 of the largest
   strike; percentiles within 2 / S); the FBM pipeline (rtol 1e-2, the
   dense family's); the multitask pipeline (losses and vols rtol 1e-3,
   the fan 2e-3 / 1e-3); the FFT projection at n=16000 against a float64
   CPU run (2e-6 of max|out|); the basic GP's MLL and gradient (rtol 1e-4),
   ``nonvol_rollouts`` (atol 1e-4 of max|y|), the LSTM forward (1e-5 with
   TF32 off; 1e-2 at PyTorch's default, where cuDNN may use TF32) and
   two LSTM training epochs (losses rtol 1e-4, TF32 off).
19. ``timing``: the timing tools of ``volt_tpu_torch/tools`` through
   their ``main`` at their published widths, the depth cut
   (``TIMING_ITEMS``): ``ablate_stages`` (64 x 1000, 5 Adam steps a stage),
   ``bench_refit`` (64 x 1000, 20 steps, the warm refit 2),
   ``bench_refit_multitask`` (T=505, n=999, 10 and 2), ``bench_multitask``
   (T=1 and 64 at n=999, 5 steps), ``bench_scaling`` (one asset at n=400
   and 25000, 5 steps), ``scaling_study`` (B=16 at ntrain 400 and 8000, 5
   steps), ``bench_fbm`` (8 x 1000, 5 steps), ``bench_voltcov`` (K2
   against its twin at (64, 999)) and ``bench_compile`` (64 x 1000, 5
   steps, one repeat, in a fresh child process on a copy of the package
   without its build), each tool's lines printed with the card.
   Checks: every ``ok`` and finite number the tools return, K2
   bit-identical to its twin, ``bench_refit``'s ``vol_rel_err_mean`` under
   1.0 (the JAX tool's bound in ``tests/test_tools.py``), ``bench_compile``'s
   child ran and built the kernels (``build_s`` > 0), K1, S1 and K2
   launched, every K1 and S1 launch at a shape that phase 3 checks.

Every phase prints its times with the card's name and power limit.  The
vol band: recovered vol / true SABR vol, the median over series, inside
(0.3, 3.5).  Launch counts are reset before each of phases 4-14 (and each
item of phases 15 to 17 and 19) and read
after it; a kernel's ``launches`` is the count from the phase that drives
its path, and ``launches_by_path`` its counts in the quantiles call of
phase 4, in ``Volt().Train()`` alone (S1 must launch in both), in
``fixed_cov``, in
``price_options_batch``, in ``fbm_path``, in the cold ``multitask`` fit,
in ``long_main_path``, summed over the items of ``baselines``, and in
``mesh``'s sharded calls (the world of one, both ranks of the world of
two) and summed over the items of ``evaluation`` and of ``timing``.  The
second-to-last line is a JSON object with each kernel's launches, error, times, bound
(``bound_ms``: the largest of its bytes over 3.35 TB/s, its operations
over the H100's peak for their type and its special functions over the
SFU's rate; ``bound_by`` says whether bytes or operations) and the
time of one library call computing the same function where there is one
(``library_ms``, else null); the last is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.

Two trees of the port against each other on one card::

    python3 chip_smoke.py --ab PARENT_DIR --phase kernel_times \\
        --phase main_path --phase main_path

runs the named phases (``PHASES``: ``kernel_times``, ``kalman_times``,
``main_path``, ``fixed_cov`` (which runs the main path first when this
process has not), ``gpcv_full``, ``gpcv_cv``, ``gpcv_sparse``,
``option_pricing``, ``fbm_path``, ``multitask``, ``long_main_path``,
``baselines``, ``mesh``, ``evaluation``, ``timing``,
``gpcv_elbo_times`` (G1, in a tree that has it), ``bm_vol_mll_times``
(G2, likewise), ``mt_gpcv_elbo_times``
(G3, likewise), ``mt_vol_mll_times`` (G4, likewise); a phase named twice
runs twice, the first cold) in
four fresh processes, in the trees parent, this one, this one, parent,
each with its own package and kernels and this file's phases and
timers.  It prints one JSON line per process and writes the
four to ``--out`` (default ``chiprun_out/chip_ab.json``).  ``--phase``
alone runs the phases in this tree, or in ``--package-root``.
"""

import argparse
import contextlib
import copy
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   phase time {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(torch, fn, reps=5, calls=20):
    """ms per call: CUDA events around ``calls`` back-to-back calls, the
    median over ``reps`` such runs, after one warm-up run."""
    return interleaved_ms(torch, [fn], reps, calls)[0]


def interleaved_ms(torch, fns, reps=5, calls=20):
    """``cuda_ms`` of each function, their runs taken in turn (a, b, a, b,
    ...), so that drift in the host's speed reaches each alike."""
    times = [[] for _ in fns]
    for _ in range(reps + 1):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / calls)
    return [statistics.median(ts[1:]) for ts in times]


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM
# 3.35 TB/s, float32 67 TFLOP/s and float64 34 TFLOP/s outside the tensor
# cores.  Special functions (exp2, reciprocal, log2, ...) on the SFU: 16
# results per clock per SM at compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughput), times
# 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def bound_ms(nbytes, ops, ops_per_s, sfu_ops=0):
    """The least time for the work: the largest of its bytes (each input
    read once, each output written once) over the memory rate, its
    arithmetic operations over the peak rate of their type, and its
    special-function operations over the SFU rate (these count as
    operations in ``bound_by``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / ops_per_s, sfu_ops / SFU_OPS_PER_S)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Input copies that device_ms rotates through: twice the H100's 50 MB L2,
# so that a launch finds its inputs in HBM, as bound_ms assumes
L2_BYTES = 50e6
ROTATE_BYTES = 2 * L2_BYTES


def _nbytes(args):
    return sum(a.numel() * a.element_size() for a in args
               if hasattr(a, "element_size"))


def device_ms(torch, fn, *args, reps=5, calls=20):
    """ms per call on the device alone: ``fn(*args)`` called in one CUDA
    graph and replayed, CUDA events around each replay, the median over
    ``reps`` replays after a warm-up one.  Unlike ``cuda_ms`` it leaves out
    the host's work per call (the wrapper's checks and allocations and the
    ``ctypes`` call), which is larger than a small kernel.  The graph's
    launches cycle through copies of the tensor ``args`` that together
    hold at least ``ROTATE_BYTES`` (twice the L2), ``max(calls, copies)``
    launches a replay: each launch reads its inputs from HBM, not from an
    L2 that a replay of the same buffers would leave warm."""
    copies = max(1, -(-int(ROTATE_BYTES) // max(1, _nbytes(args))))
    sets = [args] + [tuple(a.clone() if hasattr(a, "clone") else a
                           for a in args) for _ in range(copies - 1)]
    launches = max(calls, copies)
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*sets[i % copies])
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph, sets
    return statistics.median(times[1:])


def _log_prices(torch, g, shape):
    """Log-price-like rows: a random walk around log(100)."""
    return 4.6 + 0.01 * torch.cumsum(
        torch.randn(*shape, device="cuda", generator=g), dim=-1)


# K1's timed shapes and k: the main path's (64, 999) at its k=300, at the
# bench's k=100 and at a small k, B=500 (ROADMAP item 9), and the
# multitask path's (505, 999) at its k=25
EWMA_TIMED = [((64, 999), 300), ((64, 999), 100), ((64, 999), 25),
              ((500, 999), 300), ((505, 999), 25)]


# K1's checked shapes and k: the main path's, the edges, the baselines
# path's (the basic GP's MLL and the wind Volt window at k=400 >= T, the
# wind baseline at k=200, the multitask wind stations, the CLI's k=100)
# and the mesh path's (a rank's 32 assets, the profiled B=8 call, the
# checkpointed single series, entry()'s step, the live_serving and
# option_pricing examples) and the evaluation path's (eval_compare's
# volt lane at W=32 with ntrain 252, k=50, and with ntrain 400, k=399;
# the baselines' single windows; eval_options' W=16; eval_multitask's 4
# stations and each alone) and the timing path's (bench_refit_multitask's
# T=505 at k=25, bench_scaling's one asset at n=400 and 25000,
# scaling_study's B=16 at ntrain 400 and 8000, bench_fbm's 8 x 1000, all
# at k=100 but the first); ``run_baselines``, ``run_mesh``,
# ``run_evaluation`` and ``run_timing`` fail on a launch of their paths
# at a shape not here
EWMA_CHECKED = [((64, 999), 20), ((64, 999), 100), ((64, 999), 300),
                ((500, 999), 300), ((500, 999), 25), ((1, 5), 300),
                ((2, 3, 37), 20), ((70000, 3), 2), ((16, 2100), 300),
                ((1, 399), 400), ((1, 400), 200), ((4, 399), 400),
                ((2, 399), 100), ((32, 999), 300), ((8, 999), 300),
                ((1, 999), 300), ((1, 128), 25), ((8, 199), 49),
                ((1, 251), 50), ((32, 251), 50), ((32, 399), 399),
                ((16, 251), 50), ((4, 199), 50), ((1, 199), 50),
                ((505, 999), 25), ((1, 400), 100), ((1, 25000), 100),
                ((16, 399), 100), ((16, 7999), 100), ((8, 999), 100)]


def check_ewma(torch):
    """K1 against the plain conv1d on the card at EWMA_CHECKED: a float64
    run of it at 1e-6 max|y| (K1 runs its recurrence in float64) and the
    float32 run at 1e-5 max|y|."""
    from volt_tpu_torch.ops.ewma import _ewma_conv, ewma

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape, k in EWMA_CHECKED:
        y = _log_prices(torch, g, shape)
        got = ewma(y, k)
        err64 = (got.double() - _ewma_conv(y.double(), k)).abs().max().item()
        err = (got - _ewma_conv(y, k)).abs().max().item()
        scale = y.abs().max().item()
        print(f"   K1 {shape} k={k}: max abs err {err64:.3e} from float64 "
              f"(tol {1e-6 * scale:.3e}), {err:.3e} from float32 (tol "
              f"{1e-5 * scale:.3e})")
        if got.shape != (*shape[:-1], shape[-1] + 1) or \
                not err64 <= 1e-6 * scale or not err <= 1e-5 * scale:
            fail(f"K1 disagrees with its plain version at {shape}, k={k}")
        worst = max(worst, err)
    times = time_ewma(torch)
    main = times["(64, 999) k=300"]
    return {"name": "ewma_filter", "route": "cuda",
            "source": "volt_tpu_torch/csrc/ewma_filter.cu",
            "replaces": "volt_tpu/ops/pallas/ewma_filter.py:63",
            "symbol": "volt_ewma_filter", "max_abs_err": worst,
            **main, "by_shape": times}


def time_ewma(torch):
    """K1 at EWMA_TIMED: a call through ``ewma`` (``ms``), on the device
    alone (``device_ms``), the plain version a call, and cuDNN's conv1d
    on the input already padded, a call and on the device alone."""
    from volt_tpu_torch.ops.ewma import _ewma_conv, _pad_left, ewma, \
        ewma_filter_cuda, ewma_weights

    g = torch.Generator(device="cuda").manual_seed(6)
    times = {}
    for (rows, t), k in EWMA_TIMED:
        y = _log_prices(torch, g, (rows, t))
        padded = _pad_left(y, k).reshape(rows, 1, -1).contiguous()
        taps = ewma_weights(k, torch.float32, y.device).reshape(1, 1, k)

        def conv():
            return torch.nn.functional.conv1d(padded, taps)

        # the wrapper, the plain version and the library call a call, in
        # turn (host time dominates each), 11 runs of 20 calls
        ms, plain_ms, library_ms = interleaved_ms(
            torch, [lambda: ewma(y, k), lambda: _ewma_conv(y, k), conv],
            reps=11)
        rec = {"ms": ms,
               "device_ms": device_ms(
                   torch, lambda a: ewma_filter_cuda(a, k), y),
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": device_ms(
                   torch, lambda a: torch.nn.functional.conv1d(a, taps),
                   padded)}
        # reads y, writes the output; three float64 operations an output
        rec.update(bound_ms(4 * (rows * t + rows * (t + 1)), 3 * rows * t,
                            FP64_OPS_PER_S))
        key = f"({rows}, {t}) k={k}"
        times[key] = rec
        print(f"   K1 {key}: kernel {rec['ms']:.4f} ms a call, "
              f"{rec['device_ms']:.4f} ms on the device (bound "
              f"{rec['bound_ms']:.5f}, {rec['bound_by']}); plain "
              f"{rec['plain_ms']:.4f} ms a call; conv1d alone "
              f"{rec['library_ms']:.4f} ms a call, "
              f"{rec['library_device_ms']:.4f} ms on the device")
    return times


# S1's check shapes: the main path, the reference API, the edges, ROADMAP
# item 9's B=500, n=16000 (16 tiles of the kernel's carry; the
# long_main_path phase), the multitask path's T=505, the baselines
# path's (the wind Volt window, the CLI's two windows, the multitask wind
# stations), the mesh path's, the evaluation path's and the timing
# path's (as K1's)
KALMAN_SHAPES = [(64, 999), (1, 999), (3, 1), (5, 33), (500, 999),
                 (505, 999), (16, 16000), (1, 399), (2, 399), (4, 399),
                 (32, 999), (8, 999), (1, 128), (8, 199), (1, 251),
                 (32, 251), (32, 399), (16, 251), (4, 199), (1, 199),
                 (1, 400), (1, 25000), (16, 399), (16, 7999)]
KALMAN_TIMED = [(64, 999), (1, 999), (500, 999), (505, 999), (16, 16000)]


def kalman_inputs(torch, vt, b, n):
    """The main path's stage-3 inputs for ``b`` SABR series of ``n``
    returns: the vol integral, the residual of log prices from their EWMA
    mean, and noise from 1e-4 to 1."""
    from volt_tpu_torch.ops.ewma import ewma
    from volt_tpu_torch.ops.volint import vol_integral

    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=max(b, 2))
    x = torch.arange(n, dtype=torch.float32, device="cuda") / 252.0
    vol = torch.tensor(v_true[:b, 1:], device="cuda")
    log_y = torch.log(torch.tensor(f[:b, 1:], device="cuda"))
    v = vol_integral(x, vol) if n > 1 else vol * vol / 252.0
    resid = log_y - ewma(log_y, 300)[..., :-1]
    g = torch.Generator(device="cuda").manual_seed(1)
    s2 = 10.0 ** (-4.0 + 4.0 * torch.rand(b, device="cuda", generator=g))
    return v, s2, resid


def kalman_run(torch, ttd, ins, how):
    """Outputs ``(ll / n, mean, var)`` and the gradients of ``sum(ll / n)``
    w.r.t. ``(v, sigma2, resid)``, six tensors: by S1 (``"kernel"``), or by
    the plain loop in float32 (``"plain"``) or float64 (``"float64"``)."""
    dtype = torch.float64 if how == "float64" else torch.float32
    ins = [t.to(dtype).clone().requires_grad_() for t in ins]
    if how == "kernel":
        out = ttd._kalman(*ins)
    else:
        delta = torch.diff(ins[0], dim=-1,
                           prepend=torch.zeros_like(ins[0][..., :1]))
        out = ttd._kalman_plain(delta, ins[1], ins[2])
    out[0].sum().backward()
    return [o.detach() for o in out] + [t.grad for t in ins]


def _kalman_reference(ins, how):
    """``kalman_run`` on the CPU of numpy inputs, for a worker process:
    the six tensors as numpy arrays, and the seconds the run took."""
    import torch

    from volt_tpu_torch.ops import tridiag as ttd

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = kalman_run(torch, ttd, [torch.from_numpy(a) for a in ins], how)
    return [o.numpy() for o in out], time.perf_counter() - t0


@contextlib.contextmanager
def kalman_references(torch, vt):
    """S1's plain references, the float64 and the float32 loop, at
    KALMAN_SHAPES on the main path's stage-3 inputs, started on the CPU in
    worker processes.  The plain loop is one small op after another, so a
    long row costs its host time on the card as well; on the CPU the
    shapes run side by side while the card goes on with other checks.
    Yields ``{(b, n): (inputs on the card, {how: future})}``; every
    worker is stopped on exit."""
    import concurrent.futures
    import multiprocessing

    workers = max(1, min(len(KALMAN_SHAPES), (os.cpu_count() or 2) - 2))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = {}
        for b, n in sorted(KALMAN_SHAPES, key=lambda s: -s[1]):
            ins = kalman_inputs(torch, vt, b, n)
            host = [t.cpu().numpy() for t in ins]
            refs[b, n] = (ins, {how: pool.submit(_kalman_reference, host, how)
                                for how in ("float64", "plain")})
        yield refs
    finally:
        pool.shutdown(cancel_futures=True)


def check_kalman(torch, refs):
    """S1 forward and adjoint on the card against the plain loop on the
    CPU (``kalman_references``) at KALMAN_SHAPES, by the rule of
    ``ops.tridiag.kalman_agreement``.  Returns the max abs errors against
    the float32 plain loop, forward and backward."""
    from volt_tpu_torch.ops import tridiag as ttd

    fwd_err = bwd_err = 0.0
    worst = (0.0, "")
    t_check = time.perf_counter()
    for b, n in KALMAN_SHAPES:
        ins, futures = refs[b, n]
        t0 = time.perf_counter()
        got = kalman_run(torch, ttd, ins, "kernel")
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        (f64, f64_s), (plain, plain_s) = (futures[how].result()
                                          for how in ("float64", "plain"))
        f64, plain = ([torch.from_numpy(a).to(got[0].device) for a in out]
                      for out in (f64, plain))
        print(f"   S1 ({b}, {n}): kernel {kernel_s:.3f} s on the card; "
              f"plain loop {f64_s:.3f} s (float64), {plain_s:.3f} s "
              f"(float32) on the CPU")
        for i, (name, used, plain_f64, err) in enumerate(
                ttd.kalman_agreement(got, plain, f64)):
            print(f"   S1 ({b}, {n}) {name}: {used:.2f} of the tolerance "
                  f"from the float64 plain loop (the float32 plain loop "
                  f"{plain_f64:.2f}); max abs err against the float32 "
                  f"plain loop {err:.3e}")
            worst = max(worst, (used, f"({b}, {n}) {name}"))
            if not used <= 1.0:
                fail(f"S1 ({b}, {n}) {name} disagrees with its plain version")
            if i < 3:
                fwd_err = max(fwd_err, err)
            else:
                bwd_err = max(bwd_err, err)
    print(f"   S1 largest share of its tolerance: {worst[0]:.2f}, at "
          f"{worst[1]}; the check waited {time.perf_counter() - t_check:.3f}"
          f" s")
    return fwd_err, bwd_err


def time_kalman(torch, vt):
    """S1 forward (with the saved state) and backward timed at KALMAN_TIMED,
    per call and on the device alone, and the plain loop forward and
    backward at the main path's shape.  Returns the two kernels' records
    without their errors."""
    from volt_tpu_torch.ops import tridiag as ttd

    times = {"forward": {}, "backward": {}}
    for b, n in KALMAN_TIMED:
        v, s2, resid = kalman_inputs(torch, vt, b, n)
        delta = torch.diff(v, dim=-1, prepend=torch.zeros_like(v[..., :1]))
        delta, s2c, resid = (t.contiguous() for t in (delta, s2, resid))
        saved = ttd.kalman_forward_cuda(delta, s2c, resid, save=True)
        ones, zeros = torch.ones_like(s2c), torch.zeros_like(s2c)
        key = f"({b}, {n})"

        fwd_args = (delta, s2c, resid)
        bwd_args = (delta, s2c, resid, saved[3], saved[4], ones, zeros,
                    zeros)

        def fwd(*a):
            return ttd.kalman_forward_cuda(*a, save=True)

        bwd = ttd.kalman_backward_cuda
        for way, fn, args in (("forward", fwd, fwd_args),
                              ("backward", bwd, bwd_args)):
            times[way][key] = {"ms": cuda_ms(torch, lambda: fn(*args)),
                               "device_ms": device_ms(torch, fn, *args)}
        print(f"   S1 {key}: forward {times['forward'][key]['ms']:.4f} ms a "
              f"call, {times['forward'][key]['device_ms']:.4f} ms on the "
              f"device; backward {times['backward'][key]['ms']:.4f} ms a "
              f"call, {times['backward'][key]['device_ms']:.4f} ms on the "
              f"device")
        if (b, n) != (64, 999):
            continue
        with torch.no_grad():
            plain_fwd_ms = cuda_ms(
                torch, lambda: ttd._kalman_plain(delta, s2c, resid), calls=1)
        ins = [t.clone().requires_grad_() for t in (delta, s2c, resid)]
        ll_graph = ttd._kalman_plain(*ins)[0].sum()
        plain_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ll_graph, ins, retain_graph=True), calls=1)
        print(f"   S1 {key}: plain forward {plain_fwd_ms:.2f} ms, plain "
              f"backward {plain_bwd_ms:.2f} ms")
    b, n = 64, 999
    # bytes: forward reads delta, resid, s2 and writes ll, mean, var and the
    # saved (m, P); backward reads delta, resid, m, P, s2 and three
    # cotangents and writes d/d delta, d/d resid, d/d s2.  FP64 operations
    # per step, counted from csrc/kalman.cu: about 40 forward, 50 backward.
    bounds = {"forward": bound_ms(4 * (4 * b * n + 4 * b), 40 * b * n,
                                  FP64_OPS_PER_S),
              "backward": bound_ms(4 * (6 * b * n + 5 * b), 50 * b * n,
                                   FP64_OPS_PER_S)}
    plain = {"forward": plain_fwd_ms, "backward": plain_bwd_ms}
    return [{"name": f"kalman_{way}", "route": "cuda",
             "source": "volt_tpu_torch/csrc/kalman.cu",
             "replaces": "volt_tpu/ops/tridiag.py:166",
             "symbol": f"volt_kalman_{way}", **times[way]["(64, 999)"],
             "plain_ms": plain[way], **bounds[way], "library_ms": None,
             "library_device_ms": None, "by_shape": times[way]}
            for way in ("forward", "backward")]


def check_volt_cov(torch):
    """K2 against the plain build on the card: the main shape (64, 999),
    the joint train + test grid (64, 1099), ragged edges and a 1-D vol."""
    from volt_tpu_torch.ops.volint import min_index_covariance, vol_integral
    from volt_tpu_torch.ops.volt_cov import volt_covariance, \
        volt_covariance_cuda

    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for shape in [(64, 999), (64, 1099), (1, 5), (3, 257), (999,)]:
        n = shape[-1]
        x = torch.arange(1, n + 1, dtype=torch.float32, device="cuda") / 252.0
        vol = 0.1 + 0.2 * torch.rand(*shape, device="cuda", generator=g)
        got = volt_covariance(x, vol)
        want = min_index_covariance(vol_integral(x, vol))
        err = (got - want).abs().max().item()
        print(f"   K2 {shape}: max abs err {err:.3e} (tol 0)")
        if got.shape != want.shape or err != 0.0:
            fail(f"K2 disagrees with its plain version at {shape}")
        worst = max(worst, err)
    x = torch.arange(1, 131, dtype=torch.float32, device="cuda") / 252.0
    vol = 0.1 + 0.2 * torch.rand(2, 130, device="cuda", generator=g)
    a, b = vol.clone().requires_grad_(), vol.clone().requires_grad_()
    torch.cos(volt_covariance(x, a)).sum().backward()
    torch.cos(min_index_covariance(vol_integral(x, b))).sum().backward()
    gerr = (a.grad - b.grad).abs().max().item()
    print(f"   K2 gradient (2, 130): max abs err {gerr:.3e}")
    if not torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-6):
        fail("K2's gradient disagrees with plain autograd")

    x = torch.arange(1, 1000, dtype=torch.float32, device="cuda") / 252.0
    integral = vol_integral(x, 0.1 + 0.2 * torch.rand(
        64, 999, device="cuda", generator=g)).contiguous()
    ms = cuda_ms(torch, lambda: volt_covariance_cuda(integral))
    dev_ms = device_ms(torch, volt_covariance_cuda, integral)
    plain_ms = cuda_ms(torch, lambda: min_index_covariance(integral))

    # the integral is non-decreasing, so one broadcast minimum is the same
    # matrix: PyTorch's own call for K2's function
    def library(i):
        return torch.minimum(i[..., :, None], i[..., None, :])

    if not torch.equal(library(integral), volt_covariance_cuda(integral)):
        fail("K2 differs from torch.minimum's broadcast")
    lib_ms = cuda_ms(torch, lambda: library(integral))
    lib_dev_ms = device_ms(torch, library, integral)
    gbs = 64 * 999 * 999 * 4 / (dev_ms * 1e-3) / 1e9
    print(f"   K2 (64, 999): kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on "
          f"the device ({gbs:.0f} GB/s of stores); plain {plain_ms:.4f} ms; "
          f"torch.minimum's broadcast {lib_ms:.4f} ms a call, "
          f"{lib_dev_ms:.4f} ms on the device")
    # pure copies: the integral read, the (64, 999, 999) output written
    bound = bound_ms(4 * (64 * 999 + 64 * 999 * 999), 0, FP32_OPS_PER_S)
    return {"name": "volt_covariance", "route": "cuda",
            "source": "volt_tpu_torch/csrc/volt_cov.cu",
            "replaces": "volt_tpu/ops/pallas/volt_cov.py:47",
            "symbol": "volt_covariance", "max_abs_err": worst, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms}


def gh_inputs(torch, g, shape):
    """K3 inputs that reach both clamp regions: mean from -10 to 85,
    variance from 1e-8 to 4."""
    y = 0.05 * torch.randn(*shape, device="cuda", generator=g)
    mu = -10.0 + 95.0 * torch.rand(*shape, device="cuda", generator=g)
    s2 = 10.0 ** (-8.0 + 8.6 * torch.rand(*shape, device="cuda",
                                          generator=g))
    return y, mu, s2


def check_gh_ell(torch):
    """K3's fused path (the forward keeping the gradient's node sums, the
    elementwise backward) against the plain node sum and its autograd."""
    from volt_tpu_torch.ops import gh_ell as tgh

    g = torch.Generator(device="cuda").manual_seed(3)
    fwd_err = bwd_err = 0.0
    for shape in [(64, 999), (500, 999), (3, 37)]:
        ins = gh_inputs(torch, g, shape)
        a = [t.clone().requires_grad_() for t in ins]
        b = [t.clone().requires_grad_() for t in ins]
        got = tgh.gh_expected_log_prob(*a)
        want = tgh._gh_ell_plain(*b, 75)
        err = (got - want).abs().max().item()
        print(f"   K3 forward {shape}: max abs err {err:.3e}")
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            fail(f"K3 forward disagrees with its plain version at {shape}")
        fwd_err = max(fwd_err, err)
        cot = torch.randn(*shape, device="cuda", generator=g)
        (got * cot).sum().backward()
        (want * cot).sum().backward()
        # d/dvar also gets the float32 resolution of its node sum, which
        # cancels to a value proportional to sd (var down to 1e-8)
        extra = (0.0, 0.0, tgh.var_grad_resolution(*ins, cot))
        for name, p, q, e in zip(("y", "mean", "var"), a, b, extra):
            err = (p.grad - q.grad).abs()
            atol = 1e-6 * q.grad.abs().max().item()
            used = (err / (1e-4 * q.grad.abs() + atol + e)).max().item()
            print(f"   K3 d/d{name} {shape}: max abs err {err.max().item():.3e} "
                  f"(atol {atol:.1e}), {used:.2f} of the tolerance")
            if not used <= 1.0:
                fail(f"K3 gradient w.r.t. {name} disagrees at {shape}")
            bwd_err = max(bwd_err, err.max().item())

    times = time_gh_ell(torch)
    main = times["(64, 999)"]
    common = {"route": "cuda", "source": "volt_tpu_torch/csrc/gh_ell.cu",
              "library_ms": None, "library_device_ms": None}
    return [
        {"name": "gh_ell_forward", **common,
         "replaces": "volt_tpu/ops/pallas/gh_ell.py:123",
         "symbol": "volt_gh_ell_forward", "max_abs_err": fwd_err,
         **main["forward"], "plain_ms": main["plain_forward_ms"],
         "by_shape": times},
        {"name": "gh_ell_backward", **common,
         "replaces": "volt_tpu/ops/pallas/gh_ell.py:144",
         "symbol": "volt_gh_ell_backward", "max_abs_err": bwd_err,
         **main["backward"], "plain_ms": main["plain_backward_ms"]},
    ]


def time_gh_ell(torch, shapes=((64, 999), (500, 999))):
    """K3 timed as a GPCV Adam step runs it, per call and on the device
    alone: the forward keeping the node sums, the backward from them, and
    the two together (``step``); the forward of E alone; each forward's
    node split swept (lanes per datum); the plain forward and backward at
    the first shape.  A tree whose K3 has no fused forward (the parent of
    its redesign) is timed as its step ran: the forward of E, then the
    backward's own node pass."""
    from volt_tpu_torch import native
    from volt_tpu_torch.ops import gh_ell as tgh

    fused = "save" in inspect.signature(tgh.gh_ell_forward_cuda).parameters
    g = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for shape in shapes:
        y, mu, s2 = (t.contiguous() for t in gh_inputs(torch, g, shape))
        cot = torch.randn(*shape, device="cuda", generator=g)
        count, nodes = y.numel(), 75
        # each way: (the function, its tensor arguments)
        if fused:
            saved = tgh.gh_ell_forward_cuda(y, mu, s2, save=True)[1]
            ways = {
                "forward": (lambda a, b, c: tgh.gh_ell_forward_cuda(
                    a, b, c, save=True), (y, mu, s2)),
                "backward": (lambda a, b, c, d, e: tgh.gh_ell_backward_cuda(
                    a, b, c, d, saved=e), (y, mu, s2, cot, saved)),
                "forward_no_save": (tgh.gh_ell_forward_cuda, (y, mu, s2))}
        else:
            ways = {"forward": (tgh.gh_ell_forward_cuda, (y, mu, s2)),
                    "backward": (tgh.gh_ell_backward_cuda,
                                 (y, mu, s2, cot))}

        def step(a, b, c, d):
            if fused:
                e = tgh.gh_ell_forward_cuda(a, b, c, save=True)[1]
                return tgh.gh_ell_backward_cuda(a, b, c, d, saved=e)
            tgh.gh_ell_forward_cuda(a, b, c)
            return tgh.gh_ell_backward_cuda(a, b, c, d)

        ways["step"] = (step, (y, mu, s2, cot))
        rec = {way: {"ms": cuda_ms(torch, lambda: fn(*args)),
                     "device_ms": device_ms(torch, fn, *args)}
               for way, (fn, args) in ways.items()}
        # bytes: the forward reads y, mu, s2 and the nodes and writes E and
        # the three node sums; the backward reads s2, the cotangent and the
        # sums and writes three gradients.  FP32 operations per node,
        # counted from csrc/gh_ell.cu (an FMA is two): 11 for E, 22 with
        # the sums.  Special functions: one exponential per node, the least
        # any implementation needs.
        rec["forward"].update(bound_ms(4 * (7 * count + 2 * nodes),
                                       22 * nodes * count, FP32_OPS_PER_S,
                                       nodes * count))
        rec["backward"].update(bound_ms(4 * 8 * count, 4 * count,
                                        FP32_OPS_PER_S))
        if fused:
            rec["forward_no_save"].update(bound_ms(
                4 * (4 * count + 2 * nodes), 11 * nodes * count,
                FP32_OPS_PER_S, nodes * count))
            nodes_t = tgh._nodes(nodes, y.device)
            out = torch.empty_like(y)
            rec["split_device_ms"] = {}
            for split_log2 in range(4):
                rec["split_device_ms"][f"{2 ** split_log2} lanes"] = device_ms(
                    torch, lambda a, b, c: native.launch(
                        "volt_gh_ell_forward", a, b, c, nodes_t, out, saved,
                        count, nodes, split_log2, device=y.device),
                    y, mu, s2)
        key = str(shape)
        times[key] = rec
        print(f"   K3 {key}: " + "; ".join(
            f"{way} {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the "
            f"device" for way, r in rec.items() if way != "split_device_ms"))
        if fused:
            print(f"   K3 {key}: forward with the sums, on the device, by "
                  f"node split: {rec['split_device_ms']}")
    y, mu, s2 = (t.contiguous() for t in gh_inputs(torch, g, shapes[0]))
    cot = torch.randn(*shapes[0], device="cuda", generator=g)
    with torch.no_grad():
        times[str(shapes[0])]["plain_forward_ms"] = cuda_ms(
            torch, lambda: tgh._gh_ell_plain(y, mu, s2, 75))
    ins = [t.clone().requires_grad_() for t in (y, mu, s2)]
    out = tgh._gh_ell_plain(*ins, 75)
    times[str(shapes[0])]["plain_backward_ms"] = cuda_ms(
        torch, lambda: torch.autograd.grad(out, ins, cot, retain_graph=True))
    return times


G1_SHAPES = ((64, 999), (505, 999), (3, 37))


def g1_inputs(torch, g, b, n):
    """G1's inputs as the main path gives them: a tridiagonal GPCV model at
    its Laplace init on returns of a drifting scale, on the grid from 0;
    ``(model, x, y)``."""
    from volt_tpu_torch.models import GPCVModel

    x = torch.arange(n, device="cuda", dtype=torch.float32) / 252.0
    scale = 0.2 * torch.exp(0.05 * torch.cumsum(
        torch.randn(b, n, device="cuda", generator=g), dim=-1))
    y = scale * torch.randn(b, n, device="cuda", generator=g)
    return GPCVModel(q="tridiag").init(x, y), x, y


def g1_args(model, x, y):
    """The kernel's tensors: the grid, the returns and the parameters."""
    return (x, y, model.variational_mean.detach(), model.q_log_d.detach(),
            model.q_e.detach(), model.mean.constant.detach(),
            model.kernel.vol().detach())


def tridiag_elbo_plain(torch, x, y, m, q_log_d, q_e, c, vol):
    """The plain composition that ``GPCVModel.elbo`` runs off the card."""
    from volt_tpu_torch.ops.bidiag import (takahashi_band,
                                           tridiag_q_kl_bm_prior)

    d = torch.exp(q_log_d)
    var, _ = takahashi_band(d, q_e)
    kl = tridiag_q_kl_bm_prior(x, vol, m, d, q_e, c.expand(m.shape))
    e = torch.exp(torch.clamp(-2.0 * m + 2.0 * var, max=80.0))
    ell = -0.5 * y * y * e - m - 0.5 * math.log(2.0 * math.pi)
    return torch.mean(ell, dim=-1) - kl / y.shape[-1]


def check_gpcv_elbo(torch):
    """G1 against the plain composition in float64 on the same float32
    values: the ELBO and its five gradients, each over its largest float64
    value, at the shapes of ``G1_SHAPES``."""
    from volt_tpu_torch.ops import gpcv_elbo as tge

    g = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for b, n in G1_SHAPES:
        args = g1_args(*g1_inputs(torch, g, b, n))
        cot = torch.randn(b, device="cuda", generator=g)
        out, grads = tge.tridiag_elbo_cuda(*args, grad=True)
        ins = [t.double().requires_grad_() for t in args[2:]]
        want = tridiag_elbo_plain(torch, args[0].double(), args[1].double(),
                                  *ins)
        wgrads = torch.autograd.grad((want * cot.double()).sum(), ins)
        errs = {"elbo": (out.double() - want).abs().max().item()
                / want.abs().max().item()}
        for name, a, w in zip(("m", "q_log_d", "q_e", "c", "vol"), grads,
                              wgrads):
            errs[name] = ((cot[:, None] * a).double() - w).abs().max().item() \
                / w.abs().max().item()
        print(f"   G1 ({b}, {n}): worst error over the largest float64 "
              f"value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if not max(errs.values()) <= 1e-5:
            fail(f"G1 disagrees with the float64 composition at ({b}, {n})")
        worst = max(worst, *errs.values())
    times = time_gpcv_elbo(torch)
    main = times["(64, 999)"]
    return {"name": "gpcv_tridiag_elbo", "route": "cuda",
            "source": "volt_tpu_torch/csrc/gpcv_elbo.cu",
            "replaces": "none: the composition in GPCVModel.elbo",
            "symbol": "volt_gpcv_tridiag_elbo", "max_rel_err": worst,
            **main["grad"], "plain_ms": main["plain_ms"],
            "library_ms": None, "library_device_ms": None,
            "by_shape": times}


def time_gpcv_elbo(torch, shapes=G1_SHAPES[:2]):
    """G1 per call and on the device alone, with the gradient (a GPCV Adam
    step's launch) and without; the plain composition's forward and
    backward per call beside."""
    from volt_tpu_torch.ops import gpcv_elbo as tge

    g = torch.Generator(device="cuda").manual_seed(12)
    times = {}
    for b, n in shapes:
        args = g1_args(*g1_inputs(torch, g, b, n))
        ways = {"grad": lambda *a: tge.tridiag_elbo_cuda(*a, grad=True),
                "no_grad": tge.tridiag_elbo_cuda}
        rec = {way: {"ms": cuda_ms(torch, lambda: fn(*args)),
                     "device_ms": device_ms(torch, fn, *args)}
               for way, fn in ways.items()}
        # bytes: x, y, m, q_log_d, q_e, c and vol read once; the ELBO and,
        # with the gradient, the five gradients written once (its float64
        # workspace stays in L2); the float64 arithmetic, some tens of
        # operations a step, bounds it below the bytes
        rec["grad"].update(bound_ms(4 * (n + 7 * b * n + 5 * b), 0,
                                    FP64_OPS_PER_S))
        rec["no_grad"].update(bound_ms(4 * (n + 4 * b * n + 3 * b), 0,
                                       FP64_OPS_PER_S))
        ins = [t.clone().requires_grad_() for t in args[2:]]
        rec["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            tridiag_elbo_plain(torch, *args[:2], *ins).sum(), ins))
        times[str((b, n))] = rec
        print(f"   G1 ({b}, {n}): " + "; ".join(
            f"{way} {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the "
            f"device (bound {r['bound_ms']:.4f} ms)"
            for way, r in rec.items() if way != "plain_ms")
            + f"; plain forward and backward {rec['plain_ms']:.4f} ms a call")
    return times


G2_SHAPES = ((505, 999), (64, 999), (3, 37))


def g2_args(torch, g, b, n):
    """G2's tensors as the vol stage gives them: the spectral cache of log
    vols on a random walk over the grid from 0 (a = vol (x0 - dx) < 0, as
    the live cell's) and a vol GP's parameters moved off its init at
    random."""
    from volt_tpu_torch.models import BMGP

    model = BMGP().init((b,), torch.float32, "cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, device="cuda", generator=g))
    x = torch.arange(n, device="cuda", dtype=torch.float32) / 252.0
    y = math.log(0.2) + torch.cumsum(
        0.05 * torch.randn(b, n, device="cuda", generator=g), dim=-1)
    cache = model.spectral_cache(x, y)
    return tuple(a.detach().contiguous() for a in (
        *(cache[k] for k in ("p_y", "p_t", "mu", "w", "dx", "x0")),
        model.kernel.vol(),
        model.likelihood.noise()))


def bm_vol_mll_plain(torch, p_y, p_t, mu, w, dx, x0, vol, noise):
    """The plain composition that ``BMGP.mll_spectral`` runs on the CPU, on
    G2's arguments: the per-asset MLL."""
    n = mu.shape[-1]
    v, s = vol[..., 0], noise[..., 0]
    d = v[..., None] * dx[..., None] * mu + s[..., None]
    p_r = p_y + 0.5 * (v ** 2.0)[..., None] * p_t
    a = v * (x0 - dx)
    wd = w / d
    big_s = 1.0 + a * torch.sum(w * wd, dim=-1)
    quad = (torch.sum(p_r * p_r / d, dim=-1)
            - a * torch.sum(wd * p_r, dim=-1) ** 2 / big_s)
    logdet = torch.sum(torch.log(d), dim=-1) + torch.log(big_s)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi)) / n


def check_bm_vol_mll(torch):
    """G2 against the plain composition in float64 on the same float32
    values: the MLL and its gradients with respect to vol and the noise,
    for a random cotangent, each within 1e-5 of its largest float64 value
    (the card tests' limit), at the shapes of ``G2_SHAPES``."""
    from volt_tpu_torch.ops import bm_vol_mll as tbv

    g = torch.Generator(device="cuda").manual_seed(17)
    worst = 0.0
    for b, n in G2_SHAPES:
        args = g2_args(torch, g, b, n)
        cot = torch.randn(b, device="cuda", generator=g)
        out, grads = tbv.bm_vol_mll_cuda(*args, grad=True)
        ins = [a.double().requires_grad_() for a in args[6:]]
        want = bm_vol_mll_plain(torch, *(a.double() for a in args[:6]),
                                *ins)
        wgrads = torch.autograd.grad((want * cot.double()).sum(), ins)
        errs = {"mll": (out.double() - want).abs().max().item()
                / want.abs().max().item()}
        for name, a, w in zip(("vol", "noise"), grads, wgrads):
            errs[name] = ((cot[:, None] * a).double() - w).abs().max().item() \
                / w.abs().max().item()
        print(f"   G2 ({b}, {n}): worst error over the largest float64 "
              f"value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if not max(errs.values()) <= 1e-5:
            fail(f"G2 disagrees with the float64 composition at ({b}, {n})")
        worst = max(worst, *errs.values())
    times = time_bm_vol_mll(torch)
    main = times[str(G2_SHAPES[0])]
    return {"name": "bm_vol_spectral_mll", "route": "cuda",
            "source": "volt_tpu_torch/csrc/bm_vol_mll.cu",
            "replaces": "none: the composition in BMGP.mll_spectral",
            "symbol": "volt_bm_vol_spectral_mll", "max_rel_err": worst,
            **main["grad"], "plain_ms": main["plain_ms"],
            "library_ms": None, "library_device_ms": None,
            "by_shape": times}


def time_bm_vol_mll(torch, shapes=G2_SHAPES[:2]):
    """G2 per call and on the device alone, with the gradient (a vol Adam
    step's launch) and without; the plain composition's forward and
    backward per call beside.  Its bound: p_y read once, the shared grid's
    p_t, mu, w, dx and x0 once, vol and the noise once, the MLL and the two
    gradients written once; or its float64 operations, 34 an entry with
    the gradient and 15 without, the larger."""
    from volt_tpu_torch.ops import bm_vol_mll as tbv

    g = torch.Generator(device="cuda").manual_seed(18)
    times = {}
    for b, n in shapes:
        args = g2_args(torch, g, b, n)
        ways = {"grad": lambda *a: tbv.bm_vol_mll_cuda(*a, grad=True),
                "no_grad": tbv.bm_vol_mll_cuda}
        rec = {way: {"ms": cuda_ms(torch, lambda: fn(*args)),
                     "device_ms": device_ms(torch, fn, *args)}
               for way, fn in ways.items()}
        reads = b * n + 3 * n + 2 + 2 * b
        rec["grad"].update(bound_ms(4 * (reads + 3 * b), 34 * b * n,
                                    FP64_OPS_PER_S))
        rec["no_grad"].update(bound_ms(4 * (reads + b), 15 * b * n,
                                       FP64_OPS_PER_S))
        for r in rec.values():
            r["share"] = r["bound_ms"] / r["device_ms"]
        ins = [a.clone().requires_grad_() for a in args[6:]]
        rec["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            bm_vol_mll_plain(torch, *args[:6], *ins).sum(), ins))
        times[str((b, n))] = rec
        print(f"   G2 ({b}, {n}): " + "; ".join(
            f"{way} {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the "
            f"device (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{100 * r['share']:.2f}%)"
            for way, r in rec.items() if way != "plain_ms")
            + f"; plain forward and backward {rec['plain_ms']:.4f} ms a call")
    return times


G3_SHAPES = ((999, 505, 1), (64, 8, 2), (3, 2, 1))


def g3_args(torch, g, n, t, r):
    """G3's tensors as the multitask pipeline gives them: a tridiagonal
    multitask GPCV model at its Laplace init on returns of a drifting
    scale (n >= 11; below, parameters of the same sizes), on the grid from
    0, every parameter then moved off it at random
    (the task root gains a random lower triangle)."""
    from volt_tpu_torch.likelihoods import VolatilityGaussianLikelihood
    from volt_tpu_torch.models.multitask import MultitaskVariationalGP

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    x = torch.arange(n, device="cuda", dtype=torch.float32) / 252.0
    scale = 0.2 * torch.exp(0.05 * torch.cumsum(randn(t, n), dim=-1))
    y = (scale * randn(t, n)).T.contiguous()
    lik = VolatilityGaussianLikelihood(param="exp")
    model = MultitaskVariationalGP(t, rank=r, q="tridiag")
    model.init(x, torch.float32, torch.Generator().manual_seed(1))
    if n >= 11:
        model.initialize_variational_parameters(lik, x, y)
    else:  # below the Laplace init's length: values of the same sizes
        with torch.no_grad():
            model.variational_mean.copy_(-1.5 + 0.3 * randn(n, t))
            model.mean_constants.fill_(-1.5)
            model.q_log_d.copy_(2.0 + 0.3 * randn(n))
            model.q_e.copy_(-5.0 + randn(n - 1))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.0 + 0.05 * randn(*p.shape))
        model.variational_task_covar_root.add_(
            torch.tril(0.05 * randn(t, t), diagonal=-1))
        factor, task_diag = model.index_kernel.factor_and_diag()
        return tuple(a.detach().contiguous() for a in (
            x, y, model.variational_mean, model.q_log_d, model.q_e,
            model.variational_task_covar_root, model.mean_constants,
            factor, task_diag, model.data_kernel.vol()))


def mt_tridiag_elbo_plain(torch, x, y, m, q_log_d, q_e, root, c, factor, v,
                          vol):
    """The plain composition that ``MultitaskVariationalGP.elbo`` runs off
    the card (``q="tridiag"``, the exp term)."""
    from volt_tpu_torch.gp.kronecker import kron_kl_bm_prior_tridiag
    from volt_tpu_torch.ops.bidiag import takahashi_band

    d = torch.exp(q_log_d)
    rt = torch.tril(root)
    var = takahashi_band(d, q_e)[0][:, None] * torch.sum(rt * rt, dim=-1)
    e = torch.exp(torch.clamp(-2.0 * m + 2.0 * var, max=80.0))
    ell = torch.mean(-0.5 * y * y * e - m - 0.5 * math.log(2.0 * math.pi))
    k_task = factor @ factor.mT + torch.diag_embed(v)
    kl = kron_kl_bm_prior_tridiag(m, d, q_e, root, c.expand(m.shape), x, vol,
                                  k_task)
    return ell - kl / m.numel()


G3_GRADS = ("m", "q_log_d", "q_e", "root", "c", "factor", "v", "vol")


def check_mt_gpcv_elbo(torch):
    """G3 against the plain composition in float64 on the same float32
    values: the ELBO and its eight gradients, each over its largest
    float64 value, at the shapes of ``G3_SHAPES``."""
    from volt_tpu_torch.ops import mt_gpcv_elbo as tmg

    g = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    for n, t, r in G3_SHAPES:
        args = g3_args(torch, g, n, t, r)
        out, grads = tmg.mt_tridiag_elbo_cuda(*args, grad=True)
        ins = [a.double().requires_grad_() for a in args[2:]]
        want = mt_tridiag_elbo_plain(torch, args[0].double(),
                                     args[1].double(), *ins)
        wgrads = torch.autograd.grad(want, ins)
        errs = {"elbo": abs(out.item() - want.item()) / abs(want.item())}
        for name, a, w in zip(G3_GRADS, grads, wgrads):
            if w.numel():
                errs[name] = (a.double() - w).abs().max().item() \
                    / w.abs().max().item()
        print(f"   G3 {(n, t, r)}: worst error over the largest float64 "
              f"value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if not max(errs.values()) <= 1e-5:
            fail(f"G3 disagrees with the float64 composition at {(n, t, r)}")
        worst = max(worst, *errs.values())
    times = time_mt_gpcv_elbo(torch)
    main = times[str(G3_SHAPES[0])]
    return {"name": "mt_gpcv_tridiag_elbo", "route": "cuda",
            "source": "volt_tpu_torch/csrc/mt_gpcv_elbo.cu",
            "replaces": "none: the composition in "
                        "MultitaskVariationalGP.elbo",
            "symbol": "volt_mt_gpcv_tridiag_elbo", "max_rel_err": worst,
            **main["grad"], "plain_ms": main["plain_ms"],
            "library_ms": None, "library_device_ms": None,
            "by_shape": times}


def time_mt_gpcv_elbo(torch, shapes=G3_SHAPES[:1]):
    """G3 per call and on the device alone, with the gradient (a joint
    GPCV Adam step's call, three launches) and without; the plain
    composition's forward and backward per call beside."""
    from volt_tpu_torch.ops import mt_gpcv_elbo as tmg

    g = torch.Generator(device="cuda").manual_seed(14)
    times = {}
    for n, t, r in shapes:
        args = g3_args(torch, g, n, t, r)
        ways = {"grad": lambda *a: tmg.mt_tridiag_elbo_cuda(*a, grad=True),
                "no_grad": tmg.mt_tridiag_elbo_cuda}
        rec = {way: {"ms": cuda_ms(torch, lambda: fn(*args)),
                     "device_ms": device_ms(torch, fn, *args)}
               for way, fn in ways.items()}
        # bytes: every input read once (x, y, m, q_log_d, q_e, the root,
        # c, F, v, vol) and the ELBO and, with the gradient, the eight
        # gradients written once; the float64 workspace stays in L2
        reads = n + 2 * n * t + 2 * n + t * t + 2 * t + t * r + 1
        writes = n * t + 2 * n + t * t + 2 * t + t * r + 1
        rec["grad"].update(bound_ms(4 * (reads + 1 + writes), 0,
                                    FP64_OPS_PER_S))
        rec["no_grad"].update(bound_ms(4 * (reads + 1), 0, FP64_OPS_PER_S))
        ins = [a.clone().requires_grad_() for a in args[2:]]
        rec["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            mt_tridiag_elbo_plain(torch, *args[:2], *ins), ins))
        times[str((n, t, r))] = rec
        print(f"   G3 {(n, t, r)}: " + "; ".join(
            f"{way} {r_['ms']:.4f} ms a call, {r_['device_ms']:.4f} ms on "
            f"the device (bound {r_['bound_ms']:.4f} ms)"
            for way, r_ in rec.items() if way != "plain_ms")
            + f"; plain forward and backward {rec['plain_ms']:.4f} ms a call")
    return times


def g4_args(torch, g, n, t, r):
    """G4's tensors as the multitask vol stage gives them: the spectral
    cache of log vols on a random walk over the grid from 0 (c < 0, as
    the live cell's), a multitask vol GP's parameters moved off its init
    at random."""
    from volt_tpu_torch.models.multitask import MultitaskBMGP

    model = MultitaskBMGP(t, rank=r).init(torch.float32, "cuda",
                                          torch.Generator().manual_seed(2))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, device="cuda", generator=g))
    x = torch.arange(n, device="cuda", dtype=torch.float32) / 252.0
    y = math.log(0.2) + torch.cumsum(
        0.05 * torch.randn(n, t, device="cuda", generator=g), dim=0)
    cache = model.spectral_cache(x, y)
    factor, task_diag = model.task_kernel.factor_and_diag()
    return tuple(a.detach().contiguous() for a in (
        *(cache[k] for k in ("p_y", "p_x", "mu", "w", "dx", "x0")),
        model.data_kernel.vol(), factor, task_diag,
        model.likelihood.noise()))


def mt_vol_mll_plain(torch, p_y, p_x, mu, w, dx, x0, vol, factor,
                     task_diag, noise):
    """The plain composition that ``MultitaskBMGP.mll_spectral`` runs on
    the CPU, on G4's arguments: the MLL ``/ (N T)``."""
    from volt_tpu_torch.gp.kronecker import \
        kron_mvn_log_prob_blockdiag_lowrank

    n, t = p_y.shape
    vol = vol[..., 0]
    diag_b = torch.sum(factor * factor, dim=-1) + task_diag
    r_tilde = p_y + (0.5 * vol ** 2 * p_x)[:, None] * diag_b
    lp = kron_mvn_log_prob_blockdiag_lowrank(
        r_tilde, vol * dx * mu, vol * (x0 - dx), factor, task_diag,
        noise[..., 0], w)
    return lp / (n * t)


G4_SHAPES = ((999, 505, 1),)
G4_GRADS = ("vol", "factor", "task_diag", "noise")


def check_mt_vol_mll(torch):
    """G4 against the plain composition in float64 on the same float32
    values at the shapes of ``G4_SHAPES`` (grid from 0, so c < 0 as in the
    live cell): the MLL within 1e-6 of its float64 value, each of its four
    gradients within 1e-4 of its largest float64 entry (the card tests'
    limits: the coupling's LU is float32, as on the plain path)."""
    from volt_tpu_torch.ops import mt_vol_mll as tmv

    g = torch.Generator(device="cuda").manual_seed(16)
    worst = 0.0
    for n, t, r in G4_SHAPES:
        args = g4_args(torch, g, n, t, r)
        out, grads = tmv.mt_vol_mll_cuda(*args)
        ins = [a.double().requires_grad_() for a in args[6:]]
        want = mt_vol_mll_plain(torch, *(a.double() for a in args[:6]),
                                *ins)
        wgrads = torch.autograd.grad(want, ins)
        errs = {"mll": abs(out.item() - want.item()) / abs(want.item())}
        for name, a, w in zip(G4_GRADS, grads, wgrads):
            errs[name] = (a.double() - w).abs().max().item() \
                / w.abs().max().item()
        print(f"   G4 {(n, t, r)}: error over the largest float64 value: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if not (errs.pop("mll") <= 1e-6 and max(errs.values()) <= 1e-4):
            fail(f"G4 disagrees with the float64 composition at {(n, t, r)}")
        worst = max(worst, *errs.values())
    times = time_mt_vol_mll(torch)
    main = times[str(G4_SHAPES[0])]
    return {"name": "mt_vol_woodbury_mll", "route": "cuda",
            "source": "volt_tpu_torch/csrc/mt_vol_mll.cu",
            "replaces": "none: the composition in "
                        "MultitaskBMGP.mll_spectral",
            "symbol": "volt_mt_vol_woodbury_mll", "max_rel_err": worst,
            **{k: main[k] for k in ("ms", "device_ms", "bound_ms",
                                    "bound_by")},
            "plain_ms": main["plain_ms"], "library_ms": None,
            "library_device_ms": None, "by_shape": times}


def time_mt_vol_mll(torch, shapes=G4_SHAPES):
    """G4 per call (its two C calls and the coupling's products, LU and
    solve: the MLL and its gradient, a vol Adam step's call) and on the
    device alone; the plain composition's forward and backward per call
    beside.  Its bound: every input read and every output written once,
    or the coupling's operations, the larger: the two products that form
    S and m (2 N r T^2 and 2 T^3), the LU (2 T^3 / 3), the solve of its
    2 T right-hand sides (4 T^3) and the product Y (2 N r T^2)."""
    from volt_tpu_torch.ops import mt_vol_mll as tmv

    g = torch.Generator(device="cuda").manual_seed(15)
    times = {}
    for n, t, r in shapes:
        args = g4_args(torch, g, n, t, r)
        rec = {"ms": cuda_ms(torch, lambda: tmv.mt_vol_mll_cuda(*args)),
               "device_ms": device_ms(torch, tmv.mt_vol_mll_cuda, *args)}
        reads = n * t + 3 * n + 3 + t * r + t + 1
        writes = 1 + 1 + t * r + t + 1
        ops = 4 * n * r * t ** 2 + 6 * t ** 3 + 2 * t ** 3 / 3
        rec.update(bound_ms(4 * (reads + writes), ops, FP32_OPS_PER_S))
        rec["share"] = rec["bound_ms"] / rec["device_ms"]
        ins = [a.clone().requires_grad_() for a in args[6:]]
        rec["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            mt_vol_mll_plain(torch, *args[:6], *ins), ins))
        times[str((n, t, r))] = rec
        print(f"   G4 {(n, t, r)}: {rec['ms']:.4f} ms a call, "
              f"{rec['device_ms']:.4f} ms on the device (bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
              f"{100 * rec['share']:.2f}%); plain forward and backward "
              f"{rec['plain_ms']:.4f} ms a call")
    return times


def grids(torch, n, h, device, start=0):
    """The return grid ``x`` (``n`` points from ``start`` steps of 1/252)
    and the ``h`` points after it."""
    dt = 1.0 / 252
    x = torch.arange(start, n + start, dtype=torch.float32,
                     device=device) * dt
    test_x = torch.arange(h, dtype=torch.float32, device=device) * dt \
        + x[-1] + dt
    return x, test_x


def run_main_path(torch, vt, native):
    """The full-width slice through the user's entry point."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

    b, n, h = 64, 999, 100
    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    x, test_x = grids(torch, n, h, "cuda")
    ys = torch.tensor(f, device="cuda")
    cfg = PipelineConfig(output="quantiles")
    g = torch.Generator(device="cuda").manual_seed(0)

    native.launches.clear()
    t0 = time.perf_counter()
    fan, aux = fit_forecast_batch(g, x, ys, test_x, cfg)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(native.launches)
    stages = {k: round(v, 4) for k, v in aux["stage_seconds"].items()}
    print(f"   quantiles call: {total:.3f} s; stages (s) {stages}")
    print(f"   kernel launches in the call: {launches}")

    levels = len(cfg.quantile_levels)
    if tuple(fan.shape) != (b, levels, h):
        fail(f"fan shape {tuple(fan.shape)}")
    if not torch.isfinite(fan).all():
        fail("non-finite fan")
    if not bool(aux["ok"].all()):
        fail(f"ok flags {aux['ok'].tolist()}")
    if not bool((fan.diff(dim=-2) >= 0).all()):
        fail("fan decreases across quantile levels")
    check_vol_band(aux["vol"], v_true, "main path")
    SHARED["tridiag_vol"] = aux["vol"]
    SHARED["main_fit"] = (x, ys, aux, cfg)

    cfg_s = PipelineConfig(output="samples")
    t1 = time.perf_counter()
    paths, aux_s = fit_forecast_batch(g, x, ys, test_x, cfg_s)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    stages_s = {k: round(v, 4) for k, v in aux_s["stage_seconds"].items()}
    print(f"   samples call: {total_s:.3f} s; stages (s) {stages_s}")
    if tuple(paths.shape) != (b, cfg_s.nsample, h) or \
            not torch.isfinite(paths).all() or not bool(aux_s["ok"].all()):
        fail("samples call: bad shape, non-finite paths or a failed asset")
    return launches, {"quantiles_s": total, "quantiles_stages": stages,
                      "samples_s": total_s, "samples_stages": stages_s}


def run_reference_api(torch, vt, native, dev="cuda", n=999, h=100,
                      nsample=1000, train=None, dense_s=64, dense_h=10):
    """The single-asset reference API at full width: ``Volt.Train`` /
    ``Forecast``, the dense MLL against the Kalman MLL, and the dense
    rollout against the Markov one on the same draws.  ``train`` overrides
    ``Train``'s iteration counts (a small rehearsal on the CPU)."""
    from volt_tpu_torch.rollouts import _rollout_volt_scan, rollouts_dense

    f, _ = vt.data.sabr_paths(steps=n + 1, seed=1)
    dt = 1.0 / 252
    x = torch.arange(n + 1, dtype=torch.float32, device=dev) * dt
    prices = torch.tensor(f, device=dev)
    test_x = x[-1] + dt * torch.arange(1, h + 1, dtype=torch.float32,
                                       device=dev)
    g = torch.Generator(device=dev).manual_seed(4)

    native.launches.clear()
    t0 = time.perf_counter()
    volt = vt.Volt(x, torch.log(prices), mean="ewma", k=300)
    state = volt.Train(**(train or {}))
    _sync(torch, dev)
    train_launches = dict(native.launches)
    t1 = time.perf_counter()
    paths = volt.Forecast(test_x, nsample=nsample, generator=g)
    _sync(torch, dev)
    t2 = time.perf_counter()
    print(f"   Train {t1 - t0:.3f} s, Forecast({nsample}) {t2 - t1:.3f} s")
    if tuple(paths.shape) != (nsample, h) or not torch.isfinite(paths).all():
        fail(f"Forecast: shape {tuple(paths.shape)} or non-finite paths")

    with torch.no_grad():
        dense, kalman = state.mll().item(), state.mll_kalman().item()
        cache = state.module.make_cov_cache(state.train_x,
                                            torch.exp(state.log_vol_path))
        fixed = state.module.mll_fixed_cov(cache, state.train_x,
                                           state.train_y).item()
        # the same dense MLL in float64 on the host, for the record
        vol64 = torch.exp(state.log_vol_path).double().cpu()
        y64 = state.train_y.double().cpu()
        x64 = state.train_x.double().cpu()
        mod = state.module
        noise64 = mod.likelihood.noise().double().cpu()
        from volt_tpu_torch.gp.exact import exact_mll
        from volt_tpu_torch.ops.volint import min_index_covariance, \
            vol_integral
        dense64 = exact_mll(y64, mod.mean.train_values(y64),
                            min_index_covariance(vol_integral(x64, vol64)),
                            noise64).item()
    t3 = time.perf_counter()
    rel = abs(dense - kalman) / abs(kalman)
    rel_fixed = abs(fixed - dense) / abs(dense)
    print(f"   MLL/n: dense {dense:.7f} (K2), Kalman {kalman:.7f} (S1), "
          f"fixed-covariance {fixed:.7f} (K2, eigh), float64 host "
          f"{dense64:.7f}; rel diff dense-Kalman {rel:.2e} (tol 1e-4), "
          f"fixed-dense {rel_fixed:.2e} (tol 1e-3); {t3 - t2:.3f} s")
    if not rel <= 1e-4:
        fail("the dense MLL disagrees with the Kalman MLL of the same state")
    if not rel_fixed <= 1e-3:
        fail("the fixed-covariance MLL disagrees with the dense MLL")

    with torch.no_grad():
        tx = test_x[:dense_h]
        pred_vol = vt.sample_vol_paths(state.vol_state, tx, dense_s, g)
        zs = torch.randn(dense_s, dense_h, device=dev, generator=g)
        fast = _rollout_volt_scan(state, torch.zeros((), device=dev), tx,
                                  pred_vol, zs, False, 0.0)
        slow = rollouts_dense(None, state, x[1:], prices, tx, dense_s,
                              pred_vol=pred_vol, zs=zs)
    _sync(torch, dev)
    err = (fast - slow).abs().max().item()
    print(f"   rollouts_dense vs Markov rollout (S={dense_s}, H={dense_h}): "
          f"max abs diff {err:.3e} (tol 5e-4); "
          f"{time.perf_counter() - t3:.3f} s")
    if not err <= 5e-4 or not torch.isfinite(slow).all():
        fail("rollouts_dense disagrees with the Markov rollout")
    launches = dict(native.launches)
    print(f"   kernel launches in Train(): {train_launches}; in the phase: "
          f"{launches}")
    return launches, {"train_launches": train_launches,
                      "train_s": t1 - t0, "forecast_s": t2 - t1,
                      "mll_dense": dense, "mll_kalman": kalman,
                      "mll_fixed_cov": fixed, "mll_dense_f64": dense64,
                      "rollout_dense_err": err}


# The fixed-covariance MLL's tolerances.  Its float32 eigh of the Volt
# covariance puts errors of about eps x lambda_max into the smallest
# eigenvalues, beside the fitted noise at its 1e-4 floor, so the JAX
# package's own float32 form, on the main path's 64 states, lies up to
# 6.99e-4 (values, within its tests' 1e-3) and 1.80e-2 (the raw-noise
# gradient, 18 x its tests' 1e-3) from a float64 reference, LAPACK's eigh
# on the CPU (``tests/torch_fixed_cov_states.py jax`` on states fitted on
# an H100).  Values are held at 1e-3; gradients at max(1e-3, 3 x JAX's
# own float32 distance).
JAX_F32_GRAD_REL = 1.80e-2
FIXED_COV_VALUE_RTOL = 1e-3
FIXED_COV_GRAD_RTOL = max(1e-3, 3 * JAX_F32_GRAD_REL)
# S1 (forward and adjoint) against the same form with its eigh in float64,
# which lies within 2e-7 of the float64 MLL on those states (the same
# script's ``routes``, NVIDIA H100 80GB HBM3, 700.00 W): rel 1e-5, the
# gradients with atol 1e-7 of the largest.
KALMAN_F64_RTOL = 1e-5


def _shares(got, want, rtol, atol):
    """Each lane's (leading index's) largest ``|got - want| / (atol +
    rtol |want|)``: its share of the tolerance."""
    share = (got - want).abs() / (atol + rtol * want.abs())
    return share.reshape(share.shape[0], -1).amax(dim=-1)


def _fmt_shares(shares):
    return " ".join(f"{v:.2f}" for v in shares.tolist())


def _grad_shares(torch, got, want, rtol, atol_of_largest):
    """The lanes' worst shares over the parameters' gradients."""
    return torch.stack([
        _shares(g, w, rtol, atol_of_largest * w.abs().max().item())
        for g, w in zip(got, want)]).amax(dim=0)


def _max_rel(got, want):
    return max(((g - w).abs() / w.abs()).max().item()
               for g, w in zip(got, want))


def run_fixed_cov(torch, vt, native, dev="cuda"):
    """The fixed-covariance MLL at the main path's full width: the 64
    fitted states of phase 4 (its vol paths and data-model parameters on
    its series; the main path runs first when it has not),
    ``VoltGP.make_cov_cache`` (K2, ``(64, 999, 999)``, then a batched
    float32 ``eigh``) and ``mll_fixed_cov`` with its gradient in the data
    model's parameters, held to the Kalman MLL of the same states (S1,
    forward and adjoint): values rel ``FIXED_COV_VALUE_RTOL``, gradients
    rtol ``FIXED_COV_GRAD_RTOL`` with atol 1e-5 of the largest.  S1 is
    also held to the same form with its ``eigh`` in float64 at rel
    ``KALMAN_F64_RTOL``.  Each lane's share of each tolerance is printed,
    with the times of K2, of ``make_cov_cache`` and of each MLL with its
    gradient."""
    from volt_tpu_torch.convert import load_jax_params
    from volt_tpu_torch.gp.exact import FixedCovCache, exact_mll_fixed_cov
    from volt_tpu_torch.models import VoltGP, make_mean

    if "main_fit" not in SHARED:
        run_main_path(torch, vt, native)
    x, ys, aux, cfg = SHARED["main_fit"]
    log_y = torch.log(ys[..., 1:])
    vol = aux["vol"]
    volt = load_jax_params(VoltGP(mean=make_mean(cfg.mean_func, k=cfg.k),
                                  integral_rule=cfg.integral_rule),
                           aux["volt_params"], dev)
    names, params = zip(*volt.named_parameters())
    _reset_peak(torch, dev)

    native.launches.clear()
    t0 = time.perf_counter()
    cache = volt.make_cov_cache(x, vol)
    _sync(torch, dev)
    cache_s = time.perf_counter() - t0
    fixed = volt.mll_fixed_cov(cache, x, log_y)
    g_fixed = torch.autograd.grad(fixed.sum(), params)
    kalman = volt.mll_kalman(x, log_y, vol)
    g_kalman = torch.autograd.grad(kalman.sum(), params)
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    launches = dict(native.launches)

    # the witness: the same form with its eigh in float64
    t1 = time.perf_counter()
    evals64, evecs64 = torch.linalg.eigh(volt.train_cov(x, vol).double())
    cache64 = FixedCovCache(evals=evals64.clamp(min=0.0), evecs=evecs64)
    exact64 = exact_mll_fixed_cov(
        log_y.double(), volt.train_mean(x, log_y).double(), cache64,
        volt.likelihood.noise().double())
    g_exact64 = torch.autograd.grad(exact64.sum(), params)
    del evals64, evecs64, cache64
    _sync(torch, dev)
    witness_s = time.perf_counter() - t1
    peak = _peak_gib(torch, dev)

    fixed, kalman = fixed.detach(), kalman.detach()
    kalman64, exact64 = kalman.double(), exact64.detach()
    vtol, gtol, ktol = (FIXED_COV_VALUE_RTOL, FIXED_COV_GRAD_RTOL,
                        KALMAN_F64_RTOL)
    v_shares = _shares(fixed, kalman, vtol, 0.0)
    g_shares = _grad_shares(torch, g_fixed, g_kalman, gtol, 1e-5)
    k_shares = _shares(kalman64, exact64, ktol, 0.0)
    kg_shares = _grad_shares(torch, [g.double() for g in g_kalman],
                             g_exact64, ktol, 1e-7)
    v_rel = ((fixed - kalman).abs() / kalman.abs()).max().item()
    g_rel = _max_rel(g_fixed, g_kalman)
    k_rel = ((kalman64 - exact64).abs() / exact64.abs()).max().item()
    kg_rel = _max_rel([g.double() for g in g_kalman], g_exact64)
    b, n = log_y.shape
    print(f"   B={b}, n={n}: cache {tuple(cache.evecs.shape)} "
          f"{cache.evecs.dtype}; MLL/n fixed-covariance (K2, eigh) "
          f"{fixed.mean().item():.7f}, Kalman (S1) "
          f"{kalman.mean().item():.7f}, means over lanes; the parameters "
          f"{list(names)}; {secs:.3f} s (make_cov_cache {cache_s:.3f} s), "
          f"the float64 witness {witness_s:.3f} s, peak {peak:.2f} GiB "
          f"allocated ({CARD})")
    print(f"   float32 fixed-covariance against S1, value: largest rel diff "
          f"{v_rel:.3e}; rel {vtol:.3g}, worst share "
          f"{v_shares.max().item():.3f}; each lane: "
          f"{_fmt_shares(v_shares)}")
    print(f"   gradient: largest rel diff {g_rel:.3e} (JAX's float32 "
          f"{JAX_F32_GRAD_REL:.2e}); rtol {gtol:.3g}, atol 1e-5 of the "
          f"largest, worst share {g_shares.max().item():.3f}; each lane: "
          f"{_fmt_shares(g_shares)}")
    print(f"   S1 against the form with its eigh in float64, value: largest "
          f"rel diff {k_rel:.3e}, worst share {k_shares.max().item():.3f}; "
          f"gradient: largest rel diff {kg_rel:.3e}, worst share "
          f"{kg_shares.max().item():.3f} (rel {ktol:g}, atol 1e-7 of the "
          f"largest); each lane's worse: "
          f"{_fmt_shares(torch.maximum(k_shares, kg_shares))}")
    print(f"   kernel launches in the checked calls: {launches}")
    if not bool(v_shares.max() <= 1.0 and g_shares.max() <= 1.0):
        fail("fixed_cov: the fixed-covariance MLL or its gradient disagrees "
             "with the Kalman MLL of the same states (whether the float32 "
             "eigh or a fault: tests/torch_fixed_cov_states.py)")
    if not bool(k_shares.max() <= 1.0 and kg_shares.max() <= 1.0):
        fail("fixed_cov: the Kalman MLL (S1) or its adjoint disagrees with "
             "the fixed-covariance MLL with its eigh in float64")
    if dev == "cuda":
        for sym in ("volt_covariance", "volt_kalman_forward",
                    "volt_kalman_backward"):
            if launches.get(sym, 0) < 1:
                fail(f"fixed_cov: {sym} was not launched")

    times = {"make_cov_cache_ms": 1e3 * cache_s}
    if dev == "cuda":
        times["k2_ms"] = cuda_ms(torch, lambda: volt.train_cov(x, vol))
        times["mll_grad_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            volt.mll_fixed_cov(cache, x, log_y).sum(), params), reps=3,
            calls=3)
        times["kalman_grad_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            volt.mll_kalman(x, log_y, vol).sum(), params), reps=3, calls=3)
        times["eigh_ms"] = times["make_cov_cache_ms"] - times["k2_ms"]
        print(f"   ms a call: K2 (with the vol integral) "
              f"{times['k2_ms']:.4f}, eigh {times['eigh_ms']:.2f} "
              f"(make_cov_cache's one call less K2), fixed-covariance "
              f"MLL and gradient {times['mll_grad_ms']:.3f}, Kalman MLL and "
              f"gradient {times['kalman_grad_ms']:.3f} ({CARD})")
    return launches, {"s": secs, "witness_s": witness_s, "peak_gib": peak,
                      "mll_fixed_cov_mean": fixed.mean().item(),
                      "mll_kalman_mean": kalman.mean().item(),
                      "value_rel_max": v_rel, "grad_rel_max": g_rel,
                      "value_share_max": v_shares.max().item(),
                      "grad_share_max": g_shares.max().item(),
                      "kalman_f64_value_rel_max": k_rel,
                      "kalman_f64_grad_rel_max": kg_rel,
                      "kalman_f64_share_max": max(
                          k_shares.max().item(), kg_shares.max().item()),
                      "value_shares": v_shares.tolist(),
                      "grad_shares": g_shares.tolist(), **times}


def run_gpcv_gh(torch, vt, native, dev="cuda", b=64, n=999, adam_iters=300,
                ngvi_iters=30):
    """GPCV trained on the GH-75 term (K3) by Adam and by NGVI, each held
    against the closed-form fit of the same input."""
    f, _ = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    ys = torch.tensor(f, device=dev)
    out = {}
    native.launches.clear()
    # NGVI's grid starts one step in: at x = 0 the BM prior's variance is
    # zero and the marginal variance the jitter alone, where d/dvar of the
    # GH term is below the float32 resolution of its node sum in any
    # summation order (ops.gh_ell.var_grad_resolution), and NGVI's
    # curvature step takes it as it is (at x = 0 the plain version on the
    # CPU is 4e-3 from the closed form, one step in 6e-5)
    for opt, iters, rtol, start in (("adam", adam_iters, 2e-2, 0),
                                    ("ngvi", ngvi_iters, 2e-4, 1)):
        x = torch.arange(start, n + start, dtype=torch.float32,
                         device=dev) / 252.0
        scales = {}
        for ell in ("quadrature", "analytic"):
            t0 = time.perf_counter()
            scales[ell] = vt.learn_gpcv(x, ys, iters, opt=opt,
                                        ell_method=ell)
            _sync(torch, dev)
            out[f"{opt}_{ell}_s"] = time.perf_counter() - t0
        q, a = scales["quadrature"], scales["analytic"]
        rel_all = (q - a).abs() / a.abs()
        rel = rel_all.max().item()
        worst = divmod(int(rel_all.argmax()), n)
        print(f"   {opt} x{iters}: GH-75 fit {out[f'{opt}_quadrature_s']:.3f} "
              f"s, closed-form fit {out[f'{opt}_analytic_s']:.3f} s; "
              f"predicted scale max rel diff {rel:.2e} (tol {rtol:.0e}) at "
              f"(series, point) {worst}")
        if tuple(q.shape) != (b, n) or not torch.isfinite(q).all() or \
                not rel <= rtol:
            fail(f"GPCV {opt}: the GH-75 fit disagrees with the closed form")
        out[f"{opt}_rel"] = rel
    launches = dict(native.launches)
    print(f"   kernel launches in the phase: {launches}")
    return launches, out


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


# what one phase leaves for a later one in the same process: the main
# path's tridiagonal vol, which the dense and cv GPCV phases compare with
SHARED = {}
CARD = "no card"


def vol_ratio(vol, v_true):
    """Recovered vol / true SABR vol, the median over series of their
    means (``vol (B, n)``, ``v_true (B, n + 1)``)."""
    vol = vol.detach().cpu().numpy().reshape(-1, vol.shape[-1])
    v_true = v_true.reshape(-1, v_true.shape[-1])
    return float(statistics.median(
        vol[i].mean() / v_true[i, 1:].mean() for i in range(len(vol))))


def check_vol_band(vol, v_true, what):
    ratio = vol_ratio(vol, v_true)
    print(f"   {what}: recovered vol / true SABR vol, median over series "
          f"{ratio:.3f} (band 0.3-3.5)")
    if not 0.3 < ratio < 3.5:
        fail(f"{what}: recovered vol off by more than an order of magnitude")
    return ratio


def median_rel(a, b):
    return float(((a - b).abs() / b.abs()).median())


def tridiag_vol(torch, vt, dev, x, ys, iters=300):
    """The main path's GPCV vol (300 Adam steps on the tridiagonal
    family, exp likelihood): from the ``main_path`` phase of this process,
    else fitted here."""
    if dev == "cuda" and "tridiag_vol" in SHARED:
        return SHARED["tridiag_vol"]
    return vt.learn_gpcv(x, ys, iters, opt="adam")


def run_gpcv_full(torch, vt, native, dev="cuda", b=64, n=999, h=100,
                  iters=300):
    """``fit_forecast_batch`` with the dense GPCV family (``gpcv_q="full"``,
    quantiles, the other defaults) on the main path's series."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    x, test_x = grids(torch, n, h, dev)
    ys = torch.tensor(f, device=dev)
    cfg = PipelineConfig(gpcv_q="full", output="quantiles", gpcv_iters=iters,
                         vol_iters=iters, data_iters=iters)
    g = torch.Generator(device=dev).manual_seed(0)
    native.launches.clear()
    t0 = time.perf_counter()
    fan, aux = fit_forecast_batch(g, x, ys, test_x, cfg)
    _sync(torch, dev)
    total = time.perf_counter() - t0
    launches = dict(native.launches)
    stages = {k: round(v, 4) for k, v in aux["stage_seconds"].items()}
    print(f"   gpcv_q='full' call: {total:.3f} s; stages (s) {stages} "
          f"({CARD})")
    print(f"   kernel launches in the call: {launches}")
    if tuple(fan.shape) != (b, len(cfg.quantile_levels), h) or \
            not torch.isfinite(fan).all():
        fail(f"gpcv_full: fan shape {tuple(fan.shape)} or non-finite fan")
    if not bool(aux["ok"].all()):
        fail(f"gpcv_full: ok flags {aux['ok'].tolist()}")
    if not bool((fan.diff(dim=-2) >= 0).all()):
        fail("gpcv_full: fan decreases across quantile levels")
    ratio = check_vol_band(aux["vol"], v_true, "gpcv_full")
    rel = median_rel(aux["vol"], tridiag_vol(torch, vt, dev, x, ys, iters))
    print(f"   dense against tridiagonal GPCV vol: median rel diff {rel:.3e}")
    return launches, {"s": total, "stages": stages, "vol_ratio": ratio,
                      "vol_rel_to_tridiag": rel,
                      "root_shape": list(aux["gpcv_params"][
                          "chol_variational_covar"].shape)}


def run_gpcv_cv(torch, vt, native, dev="cuda", b=64, n=999, ngvi_iters=30,
                adam_iters=300):
    """``learn_gpcv(param="cv")`` on the main path's series by NGVI and by
    Adam, each beside the exp fit of the same input."""
    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    x, _ = grids(torch, n, 1, dev)
    ys = torch.tensor(f, device=dev)
    out = {}
    native.launches.clear()
    for opt, iters in (("ngvi", ngvi_iters), ("adam", adam_iters)):
        t0 = time.perf_counter()
        cv = vt.learn_gpcv(x, ys, iters, param="cv", opt=opt)
        _sync(torch, dev)
        out[f"{opt}_s"] = time.perf_counter() - t0
        ok = torch.isfinite(cv).all(dim=-1)
        if tuple(cv.shape) != (b, n) or not bool(ok.all()):
            fail(f"gpcv_cv {opt}: shape {tuple(cv.shape)}, finite series "
                 f"{ok.tolist()}")
        out[f"{opt}_vol_ratio"] = check_vol_band(cv, v_true,
                                                 f"gpcv_cv {opt} x{iters}")
        exp = (tridiag_vol(torch, vt, dev, x, ys, iters) if opt == "adam"
               else vt.learn_gpcv(x, ys, iters, opt=opt))
        out[f"{opt}_rel_to_exp"] = median_rel(cv, exp)
        print(f"   cv {opt} x{iters}: {out[f'{opt}_s']:.3f} s ({CARD}); "
              f"median rel diff from the exp fit "
              f"{out[f'{opt}_rel_to_exp']:.3e}")
    launches = dict(native.launches)
    print(f"   kernel launches in the phase: {launches}")
    return launches, out


def run_gpcv_sparse(torch, vt, native, dev="cuda", n=16000, m=256,
                    iters=1000):
    """``learn_gpcv_sparse`` on one long SABR series (ROADMAP item 9's
    n=16000), ``m`` inducing points, its default 1000 Adam steps."""
    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=3)
    # the grid takes the simulation's own step (``sabr_paths`` spreads its
    # steps over [0, 1]), so that the vol band compares like with like: on
    # the 1/252 grid of the other phases the recovered vol is
    # sqrt(252 / (n + 1)) of the true one's scale, 0.5 at n=999 but 0.13
    # at n=16000
    x = torch.arange(n, dtype=torch.float32, device=dev) / (n + 1)
    ys = torch.tensor(f, device=dev)
    native.launches.clear()
    t0 = time.perf_counter()
    scale, state = vt.learn_gpcv_sparse(x, ys, num_inducing=m,
                                        train_iters=iters, return_model=True)
    _sync(torch, dev)
    total = time.perf_counter() - t0
    print(f"   learn_gpcv_sparse n={n}, m={m}, {iters} Adam steps: "
          f"{total:.3f} s ({CARD})")
    if tuple(scale.shape) != (n,) or not torch.isfinite(scale).all():
        fail(f"gpcv_sparse: shape {tuple(scale.shape)} or non-finite scale")
    ratio = check_vol_band(scale[None], v_true[None], "gpcv_sparse")
    with torch.no_grad():
        again = state.predicted_scale()
    err = (again - scale).abs().max().item()
    print(f"   the returned model's predicted_scale(): max abs diff {err:.3e}"
          f" (tol 1e-6 rel)")
    if not torch.allclose(again, scale, rtol=1e-6, atol=0.0):
        fail("gpcv_sparse: the returned model does not reproduce the scale")
    return dict(native.launches), {"s": total, "vol_ratio": ratio,
                                   "inducing": int(state.inducing_x.numel())}


def _peak_gib(torch, dev):
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else float("nan"))


def _reset_peak(torch, dev):
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _check_fan(torch, what, fan, shape):
    if tuple(fan.shape) != shape or not torch.isfinite(fan).all():
        fail(f"{what}: fan shape {tuple(fan.shape)} or non-finite fan")
    if not bool((fan.diff(dim=-2) >= 0).all()):
        fail(f"{what}: fan decreases across quantile levels")


def _check_launched(what, launches, dev):
    for sym in ("volt_ewma_filter", "volt_kalman_forward",
                "volt_kalman_backward"):
        if dev == "cuda" and launches.get(sym, 0) < 1:
            fail(f"{what}: {sym} was not launched")


def run_fbm_path(torch, vt, native, dev="cuda", b=64, n=999, h=100,
                 iters=100, nsample=1000):
    """``fit_forecast_batch(PipelineConfig(kernel="fbm"))`` on the main
    path's series with the defaults (quantiles) but ``iters`` Adam steps a
    stage (100: the defaults' 300 cut to make room for the evaluation
    phase): it resolves to the dense GPCV family, the dense FBM vol MLL
    (the increment-domain factor) and the dense vol sampler."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch
    from volt_tpu_torch.parallel.pipeline import _resolve_config

    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    x, test_x = grids(torch, n, h, dev)
    ys = torch.tensor(f, device=dev)
    cfg = PipelineConfig(kernel="fbm", output="quantiles", gpcv_iters=iters,
                         vol_iters=iters, data_iters=iters, nsample=nsample)
    resolved = _resolve_config(cfg)
    if (resolved.gpcv_q, resolved.vol_mll) != ("full", "kalman"):
        fail(f"fbm_path: resolved to {resolved}")
    g = torch.Generator(device=dev).manual_seed(8)
    _reset_peak(torch, dev)
    native.launches.clear()
    t0 = time.perf_counter()
    fan, aux = fit_forecast_batch(g, x, ys, test_x, cfg)
    _sync(torch, dev)
    total = time.perf_counter() - t0
    launches = dict(native.launches)
    peak = _peak_gib(torch, dev)
    stages = {k: round(v, 4) for k, v in aux["stage_seconds"].items()}
    hurst = torch.sigmoid(aux["vol_params"]["kernel"]["raw_vol"][..., 0])
    q = torch.quantile(hurst.cpu(), torch.tensor([0.0, 0.25, 0.5, 0.75,
                                                  1.0])).tolist()
    print(f"   kernel='fbm' call: {total:.3f} s; stages (s) {stages}; peak "
          f"{peak:.2f} GiB allocated ({CARD})")
    print(f"   recovered Hurst parameters, min/quartiles/max over series: "
          f"{[round(v, 4) for v in q]}")
    print(f"   ok lanes {int(aux['ok'].sum())} of {b}; kernel launches in "
          f"the call: {launches}")
    _check_fan(torch, "fbm_path", fan, (b, len(cfg.quantile_levels), h))
    if not bool(aux["ok"].all()):
        fail(f"fbm_path: ok flags {aux['ok'].tolist()}")
    if not bool(torch.isfinite(hurst).all()):
        fail("fbm_path: non-finite Hurst parameters")
    _check_launched("fbm_path", launches, dev)
    ratio = check_vol_band(aux["vol"], v_true, "fbm_path")
    return launches, {"s": total, "stages": stages, "peak_gib": peak,
                      "ok": int(aux["ok"].sum()), "vol_ratio": ratio,
                      "hurst_quantiles": q}


def run_multitask(torch, vt, native, dev="cuda", t=505, ntrain=1000, h=100,
                  nsample=100, iters=300, warm_iters=30, shift=1):
    """``fit_forecast_multitask`` at ``tools/bench_refit_multitask.py``'s
    defaults (505 SABR series, seed 0, 999 returns on a grid from dt, H=100,
    100 paths, 300 steps a stage, quantiles), cold; then a warm refit from
    ``warm_start_multitask(aux, shift=1)`` with 30 steps a stage on the
    window slid by one tick.  The warm-against-cold difference of the vol
    paths is taken on the ticks the two windows share."""
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask,
                                         warm_start_multitask)

    n = ntrain - 1
    f, _ = vt.data.sabr_paths(steps=ntrain + shift, seed=0, n_paths=t)
    x, test_x = grids(torch, n, h, dev, start=1)
    prices = torch.tensor(f, device=dev)
    base = dict(nsample=nsample, output="quantiles", k=min(25, max(2, n // 4)))
    runs = {}
    aux = None
    for name, window, steps in (("cold", prices[:, :ntrain], iters),
                                ("warm", prices[:, shift:ntrain + shift],
                                 warm_iters)):
        cfg = MultitaskPipelineConfig(gpcv_iters=steps, vol_iters=steps,
                                      data_iters=steps, **base)
        init = None if aux is None else warm_start_multitask(aux, shift, n)
        g = torch.Generator(device=dev).manual_seed(9)
        _reset_peak(torch, dev)
        native.launches.clear()
        t0 = time.perf_counter()
        fan, out_aux = fit_forecast_multitask(g, x, window, test_x, cfg,
                                              init_params=init)
        _sync(torch, dev)
        total = time.perf_counter() - t0
        launches = dict(native.launches)
        peak = _peak_gib(torch, dev)
        stages = {k: round(v, 4) for k, v in
                  out_aux["stage_seconds"].items()}
        rec = {"s": total, "stages": stages, "peak_gib": peak,
               "ok": int(out_aux["ok"].sum()), "launches": launches}
        if aux is not None:
            rec["vol_rel_to_cold"] = median_rel(
                out_aux["vols"][:, :-shift], aux["vols"][:, shift:])
        print(f"   {name} T={t}, n={n}, {steps} steps a stage: {total:.3f} "
              f"s; stages (s) {stages}; peak {peak:.2f} GiB allocated "
              f"({CARD})")
        print(f"   {name}: ok lanes {rec['ok']} of {t}"
              + (f"; vol paths against the cold fit's, median rel diff "
                 f"{rec['vol_rel_to_cold']:.3e}" if aux is not None else "")
              + f"; kernel launches {launches}")
        _check_fan(torch, f"multitask {name}", fan,
                   (t, len(cfg.quantile_levels), h))
        if not bool(out_aux["ok"].all()):
            fail(f"multitask {name}: {t - rec['ok']} tasks failed")
        _check_launched(f"multitask {name}", launches, dev)
        runs[name] = rec
        aux = out_aux
    if not runs["warm"]["vol_rel_to_cold"] < 0.1:
        fail("multitask: the warm refit's vol paths are far from the cold "
             "fit's")
    return runs["cold"]["launches"], runs


def run_long_main_path(torch, vt, native, dev="cuda", b=16, n=16000, h=100,
                       iters=300, nsample=1000):
    """``fit_forecast_batch`` with the defaults at B=16, n=16000 (ROADMAP
    item 9's cell): the vol stage's spectral cache projects by the FFT.
    The grid takes the simulation's own step (as ``gpcv_sparse``)."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=2, n_paths=b)
    dt = 1.0 / (n + 1)
    x = torch.arange(n, dtype=torch.float32, device=dev) * dt
    test_x = x[-1] + dt * torch.arange(1, h + 1, dtype=torch.float32,
                                       device=dev)
    ys = torch.tensor(f, device=dev)
    cfg = PipelineConfig(gpcv_iters=iters, vol_iters=iters, data_iters=iters,
                         nsample=nsample)
    g = torch.Generator(device=dev).manual_seed(10)
    _reset_peak(torch, dev)
    native.launches.clear()
    t0 = time.perf_counter()
    paths, aux = fit_forecast_batch(g, x, ys, test_x, cfg)
    _sync(torch, dev)
    total = time.perf_counter() - t0
    launches = dict(native.launches)
    peak = _peak_gib(torch, dev)
    stages = {k: round(v, 4) for k, v in aux["stage_seconds"].items()}
    print(f"   B={b}, n={n} call: {total:.3f} s; stages (s) {stages}; peak "
          f"{peak:.2f} GiB allocated ({CARD})")
    print(f"   ok lanes {int(aux['ok'].sum())} of {b}; kernel launches in "
          f"the call: {launches}")
    if tuple(paths.shape) != (b, nsample, h) or \
            not torch.isfinite(paths).all():
        fail(f"long_main_path: paths {tuple(paths.shape)} or non-finite")
    if not bool(aux["ok"].all()):
        fail(f"long_main_path: ok flags {aux['ok'].tolist()}")
    _check_launched("long_main_path", launches, dev)
    ratio = check_vol_band(aux["vol"], v_true, "long_main_path")
    return launches, {"s": total, "stages": stages, "peak_gib": peak,
                      "ok": int(aux["ok"].sum()), "vol_ratio": ratio}


K1_SYM = "volt_ewma_filter"
S1_SYMS = ("volt_kalman_forward", "volt_kalman_backward")


def _timed(torch, dev, native, fn):
    """``fn()``, its seconds and the launch counts it made (reset first)."""
    native.launches.clear()
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    return out, time.perf_counter() - t0, dict(native.launches)


def _check_saved(what, outdir, names, shape):
    """The files ``names`` under ``outdir``, and nothing else, each finite
    of ``shape``."""
    import numpy as np

    got = sorted(p.name for p in Path(outdir).iterdir())
    if got != sorted(names):
        fail(f"{what}: wrote {got}, expected {sorted(names)}")
    for name in names:
        arr = np.load(Path(outdir) / name)
        if arr.shape != shape or not np.isfinite(arr).all():
            fail(f"{what}: {name} has shape {arr.shape} or non-finite "
                 "values")


def _check_paths(torch, what, paths, shape):
    if tuple(paths.shape) != shape or not torch.isfinite(paths).all():
        fail(f"{what}: samples {tuple(paths.shape)} (want {shape}) or "
             "non-finite")


@contextlib.contextmanager
def _launch_shapes(native, seen):
    """Add each K1 launch's ``(symbol, rows, T, k)`` and each S1 launch's
    ``(symbol, B, n)`` to the set ``seen`` while open."""
    launch = native.launch

    def recording(symbol, *args, device):
        if symbol == K1_SYM:
            seen.add((symbol, *args[2:5]))
        elif symbol in S1_SYMS:
            seen.add((symbol, *args[-2:]))
        return launch(symbol, *args, device=device)

    native.launch = recording
    try:
        yield seen
    finally:
        native.launch = launch


def _checked_shapes():
    """The launch shapes, as :func:`_launch_shapes` records them, at which
    the kernels phase holds K1 (EWMA_CHECKED) and S1 (KALMAN_SHAPES)
    against their plain versions."""
    k1 = {(K1_SYM, math.prod(shape[:-1]), shape[-1], k)
          for shape, k in EWMA_CHECKED}
    return k1 | {(sym, b, n) for b, n in KALMAN_SHAPES for sym in S1_SYMS}


@contextlib.contextmanager
def _default_precision(torch):
    """PyTorch's default float32 precision while open: TF32 allowed in
    cuDNN, not in matmuls (``setup`` turns both off for the kernel
    checks)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def run_baselines(torch, vt, native, dev="cuda", ntrain=400, h=100,
                  basic_iters=200, nsample=1000, wind_iters=200,
                  wind_nsample=200, lstm_epochs=50, lstm_hidden=128,
                  lstm_h=20, mt_h=126, mt_gpcv_iters=100, mt_vol_iters=100,
                  fg_train_iters=100, dense_s=64, dense_h=10):
    """The baselines and the paper's experiment drivers at the published
    backtest widths, their Adam steps and epochs cut to make room for the
    evaluation phase (the published depth in brackets), at PyTorch's
    default precision as their CLIs run (each item's launch counts reset
    before it, each K1 and S1 launch's shape checked to be one that
    ``check_ewma`` / ``check_kalman`` hold against the plain version):

    1. ``generate_basic_predictions`` on the ``AAA`` fixture (520 closes,
       read from its CSV) with a spectral mixture of 15 and an EWMA k=400
       mean: 200 Adam steps (600), 1000 autoregressive paths of 100
       steps, ntrain=400, 2 windows;
    2. the same with a scaled Matérn and the log-linear mean (the joint
       posterior in one shot);
    3. ``basic_wind_rollouts`` (RBF, EWMA k=200, 200 steps (500), 200
       paths) on one ``wind_windows`` window of ntrain=400, H=100;
    4. ``wind_volt_window`` with the constant mean (S1) and EWMA k=400
       (K1), 1000 paths, theta=0.01;
    5. the LSTM at ``lstm_generator.py``'s widths (window 25, hidden 128,
       one layer, batch 128) for 50 epochs (200) on two windows of
       ``AAA``, 1000 paths of 20 steps;
    6. ``run_multitask_wind`` on the 4 synthetic stations, ntrain=400,
       H=126, 1000 paths, k=400, 100 GPCV and 100 vol steps (200, 400);
    7. ``forecast_generator.main`` over the fixtures with ``--kernel volt
       --ntimes 2 --save --train_iters 100`` (300);

    then the card's ``nonvol_rollouts`` against ``nonvol_rollouts_dense``
    on the same normals (item 1's first window, S=64, H=10, atol 5e-4 per
    path).  Keyword sizes shrink it for a rehearsal on the CPU."""
    import io
    import tempfile

    import numpy as np

    from volt_tpu_torch.data import fixtures_dir, universes
    from volt_tpu_torch.experiments import (basic_wind_rollouts,
                                            generate_basic_predictions,
                                            run_multitask_wind)
    from volt_tpu_torch.experiments import forecast_generator as fg
    from volt_tpu_torch.experiments.basic_wind import make_basic_model
    from volt_tpu_torch.experiments.generate_preds import rolling_windows
    from volt_tpu_torch.experiments.gp_generator import (load_wind,
                                                         wind_volt_window)
    from volt_tpu_torch.models.lstm import train_lstm
    from volt_tpu_torch.rollouts import (nonvol_rollouts,
                                         nonvol_rollouts_dense)

    fix = fixtures_dir()
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name)
    prices, dates = fg.load_prices("AAA", 520, csv_dir=fix)
    if dates is None or len(prices) != 520:
        fail("baselines: load_prices did not read the AAA fixture's CSV")
    ends = rolling_windows(prices, ntrain, 2)
    labels = [dates[e] for e in ends]
    g = torch.Generator(device=dev).manual_seed(11)
    items, launches = {}, {}

    def record(name, secs, counts, extra=None):
        items[name] = {"s": secs, "launches": counts, **(extra or {})}
        launches[name] = counts
        print(f"   {name}: {secs:.3f} s; launches {counts}; peak "
              f"{_peak_gib(torch, dev):.2f} GiB allocated ({CARD})",
              flush=True)

    # the items run as their CLIs do, at PyTorch's default precision
    # (cuDNN's LSTM may use TF32), and each K1 and S1 launch's shape is
    # recorded
    seen = set()
    with _launch_shapes(native, seen), _default_precision(torch):
        for kname, mean in (("sm", "ewma"), ("matern", "loglinear")):
            _reset_peak(torch, dev)
            res, secs, counts = _timed(torch, dev, native, lambda: (
                generate_basic_predictions(
                    "AAA", prices, kname, dates=dates, mean_name=mean, k=400,
                    forecast_horizon=h, train_iters=basic_iters,
                    nsample=nsample, ntrain=ntrain, save=True, ntimes=2,
                    outdir=str(out / kname), generator=g, device=dev)))
            record(f"basic_{kname}_{mean}", secs, counts,
                   {"peak_gib": _peak_gib(torch, dev)})
            if list(res) != labels:
                fail(f"basic {kname}: windows {list(res)}, expected "
                     f"{labels}")
            _check_saved(f"basic {kname}", out / kname / "AAA",
                         [f"{kname}_{mean}400_{lb}.npy" for lb in labels],
                         (nsample, h))
        if dev == "cuda" and launches["basic_sm_ewma"].get(K1_SYM, 0) < 1:
            fail("basic sm/ewma: K1 was not launched")

        rng = np.random.default_rng(0)
        wind = universes.wind_windows(rng, 1, ntrain, h)[0]
        wx = torch.arange(ntrain, dtype=torch.float32, device=dev) / 365
        wtest = torch.arange(ntrain, ntrain + h, dtype=torch.float32,
                             device=dev) / 365
        _reset_peak(torch, dev)
        paths, secs, counts = _timed(torch, dev, native, lambda: (
            basic_wind_rollouts(wx, wind[:ntrain], wtest, "rbf", "ewma",
                                k=200, train_iters=wind_iters,
                                nsample=wind_nsample, generator=g,
                                device=dev)))
        record("basic_wind_rbf_ewma", secs, counts,
               {"peak_gib": _peak_gib(torch, dev)})
        _check_paths(torch, "basic_wind_rollouts", paths,
                     (wind_nsample, h))
        if dev == "cuda" and counts.get(K1_SYM, 0) < 1:
            fail("basic_wind_rollouts: K1 was not launched")

        for mean, syms in (("constant", S1_SYMS), ("ewma", (K1_SYM,))):
            _reset_peak(torch, dev)
            paths, secs, counts = _timed(torch, dev, native, lambda: (
                wind_volt_window(wx[:-1], wind[:ntrain], wtest, mean,
                                 nsample=nsample, theta=0.01, k=400,
                                 generator=g, device=dev)))
            record(f"wind_volt_{mean}", secs, counts,
                   {"peak_gib": _peak_gib(torch, dev)})
            _check_paths(torch, f"wind_volt_window({mean})", paths,
                         (nsample, h))
            for sym in syms:
                if dev == "cuda" and counts.get(sym, 0) < 1:
                    fail(f"wind_volt_window({mean}): {sym} was not "
                         "launched")

        def lstm_windows():
            res = []
            for e in ends:
                log_y = np.log(prices[e - ntrain:e].astype(np.float32))
                st = train_lstm(log_y, seq_len=25, hidden_size=lstm_hidden,
                                num_layers=1, epochs=lstm_epochs,
                                batch_size=128, generator=g, device=dev)
                res.append(st.forecast(g, lstm_h, nsample))
            return res

        _reset_peak(torch, dev)
        fcs, secs, counts = _timed(torch, dev, native, lstm_windows)
        record("lstm", secs, counts, {"peak_gib": _peak_gib(torch, dev)})
        for fc, e in zip(fcs, ends):
            _check_paths(torch, "lstm forecast", fc, (nsample, lstm_h))
        # the forecast is of the log price: its median path starts near
        # the window's last log price
        start = [abs(float(fc[:, 0].median())
                     - float(np.log(prices[e - 1])))
                 for fc, e in zip(fcs, ends)]
        print(f"   lstm: |median first step - last log price| {start}")
        if not max(start) < 0.1:
            fail("lstm: the forecast starts far from the series")

        names, _, data = load_wind("", synthetic=True)
        _reset_peak(torch, dev)
        res, secs, counts = _timed(torch, dev, native, lambda: (
            run_multitask_wind(names, data, ntrain=ntrain,
                               forecast_horizon=mt_h, nsample=nsample,
                               gpcv_iters=mt_gpcv_iters,
                               vol_iters=mt_vol_iters, k=400, generator=g,
                               device=dev)))
        record("multitask_wind", secs, counts,
               {"peak_gib": _peak_gib(torch, dev)})
        xp = torch.as_tensor(res["x_paths"])
        _check_paths(torch, "run_multitask_wind", xp,
                     (len(data), nsample, mt_h))
        if res["names_list"] != [names[i] for i in range(len(data))]:
            fail(f"run_multitask_wind: stations {res['names_list']}")

        argv = ["--ticker_fname", str(Path(fix) / "offline_tickers"),
                "--csv_dir", fix, "--kernel", "volt", "--ntimes", "2",
                "--save",
                "--ntrain", str(ntrain), "--nsample", str(nsample),
                "--forecast_horizon", str(h), "--train_iters",
                str(fg_train_iters), "--outdir", str(out / "cli"),
                "--device", dev]
        buf = io.StringIO()
        _reset_peak(torch, dev)
        with contextlib.redirect_stdout(buf):
            _, secs, counts = _timed(torch, dev, native, lambda: fg.main(
                fg.build_parser().parse_args(argv)))
        text = buf.getvalue()
        record("forecast_generator", secs, counts,
               {"peak_gib": _peak_gib(torch, dev)})
        if "FAILED" in text or "done AAA" not in text or \
                "done BBB" not in text:
            fail(f"forecast_generator.main: {text.strip()}")
        for tckr in ("AAA", "BBB"):
            p, d = fg.load_prices(tckr, ntrain + 500, csv_dir=fix)
            _check_saved(f"forecast_generator {tckr}", out / "cli" / tckr,
                         [f"volt_ewma100_{d[e]}.npy"
                          for e in rolling_windows(p, ntrain, 2)],
                         (nsample, h))

    unchecked = sorted(seen - _checked_shapes())
    print(f"   K1 and S1 launch shapes on the path: {sorted(seen)}")
    if unchecked:
        fail(f"baselines: K1 or S1 launched at shapes that the kernels "
             f"phase does not hold against their plain versions: "
             f"{unchecked}")

    # the grown-Cholesky rollout against the dense loop, item 1's model
    x, test_x = grids(torch, ntrain - 1, dense_h, dev)
    log_y = torch.log(torch.tensor(prices[ends[0] - ntrain:ends[0]],
                                   device=dev))[1:]
    model = make_basic_model(x, log_y, "sm", "ewma", 400, basic_iters,
                             num_mixtures=15, generator=g)
    zs = torch.randn(dense_s, dense_h, device=dev, generator=g)
    t0 = time.perf_counter()
    fast = nonvol_rollouts(None, model, x, None, test_x, dense_s, zs=zs)
    _sync(torch, dev)
    t1 = time.perf_counter()
    slow = nonvol_rollouts_dense(None, model, test_x, dense_s, zs=zs)
    _sync(torch, dev)
    err = (fast - slow).abs().max().item()
    print(f"   nonvol_rollouts (S={dense_s}, H={dense_h}) {t1 - t0:.4f} s "
          f"against nonvol_rollouts_dense {time.perf_counter() - t1:.4f} s:"
          f" max abs diff {err:.3e} (tol 5e-4)")
    if not err <= 5e-4 or not torch.isfinite(slow).all():
        fail("nonvol_rollouts disagrees with nonvol_rollouts_dense")
    items["nonvol_dense_err"] = err
    tmp.cleanup()
    total = {}
    for counts in launches.values():
        for sym, c in counts.items():
            total[sym] = total.get(sym, 0) + c
    return total, items


def check_small_agreement_baselines(torch, vt):
    """Card against CPU on small inputs: the basic GP's MLL and gradient
    (spectral mixture, EWMA mean: K1 on the card), the baselines' rollout
    on the same normals, and the LSTM forward and two training epochs on
    the same initial values and permutations (TF32 off; the forward also
    at PyTorch's default precision, as the LSTM CLI runs)."""
    from volt_tpu_torch.models import SMGP
    from volt_tpu_torch.models.lstm import _Net, _train
    from volt_tpu_torch.means import EWMAMean
    from volt_tpu_torch.rollouts import nonvol_rollouts

    f, _ = vt.data.sabr_paths(steps=61, seed=5, F0=50.0)
    y = torch.log(torch.tensor(f[1:]))
    x, test_x = grids(torch, 60, 8, "cpu")
    cpu = SMGP(5, EWMAMean(20)).init(generator=torch.Generator()
                                     .manual_seed(0))
    cpu.kernel.initialize_from_data(x, y, torch.Generator().manual_seed(1))
    card = copy.deepcopy(cpu).cuda()
    vals, grads = {}, {}
    for dev, mod in (("cpu", cpu), ("cuda", card)):
        mll = mod.mll(x.to(dev), y.to(dev))
        mll.backward()
        vals[dev] = mll.item()
        grads[dev] = torch.cat([p.grad.reshape(-1).cpu()
                                for p in mod.parameters()])
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    grel = ((grads["cuda"] - grads["cpu"]).abs().max()
            / grads["cpu"].abs().max()).item()
    print(f"   basic GP MLL card vs CPU: rel {rel:.2e}, gradient rel "
          f"{grel:.2e} (tol 1e-4)")
    if not (rel <= 1e-4 and grel <= 1e-4):
        fail("the basic GP's MLL or gradient differs between card and CPU")

    zs = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        paths = {dev: nonvol_rollouts(None, mod.fit_state(x.to(dev),
                                                           y.to(dev)),
                                      None, None, test_x.to(dev), 16,
                                      zs=zs.to(dev)).cpu()
                 for dev, mod in (("cpu", cpu), ("cuda", card))}
    err = (paths["cuda"] - paths["cpu"]).abs().max().item()
    print(f"   nonvol_rollouts card vs CPU: max abs diff {err:.2e} (tol "
          f"1e-4 max|y| = {1e-4 * y.abs().max().item():.2e})")
    if not err <= 1e-4 * y.abs().max().item():
        fail("nonvol_rollouts differs between card and CPU")

    net = _Net(25, 16, 2).init_flax(torch.Generator().manual_seed(3))
    wins = torch.randn(32, 25, generator=torch.Generator().manual_seed(4))
    gnet = copy.deepcopy(net).cuda()
    with torch.no_grad():
        err = (gnet(wins.cuda()).cpu() - net(wins)).abs().max().item()
    print(f"   LSTM forward card vs CPU: max abs diff {err:.2e} (tol 1e-5)")
    if not err <= 1e-5:
        fail("the LSTM forward differs between card and CPU")
    # at PyTorch's default precision, as the LSTM CLI runs, cuDNN may
    # round the LSTM's matmul inputs to TF32 (10 mantissa bits, 2^-11
    # relative a factor)
    with torch.no_grad(), _default_precision(torch):
        err = (gnet(wins.cuda()).cpu() - net(wins)).abs().max().item()
    print(f"   LSTM forward card (cuDNN TF32 allowed) vs CPU: max abs diff "
          f"{err:.2e} (tol 1e-2)")
    if not err <= 1e-2:
        fail("the LSTM forward at the default precision differs between "
             "card and CPU")
    perms = torch.stack([torch.randperm(59, generator=torch.Generator()
                                        .manual_seed(5 + e))
                         for e in range(2)])
    lc = _train(net, y, 25, 2, 16, 0.01, None, perms)[3]
    lg = _train(gnet, y.cuda(), 25, 2, 16, 0.01, None, perms)[3].cpu()
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    print(f"   LSTM training losses card vs CPU: rel {rel:.2e} (tol 1e-4)")
    if not rel <= 1e-4:
        fail("LSTM training differs between card and CPU")


EXPIRY_STEPS = (4, 20, 62, 99)


def run_option_pricing(torch, vt, native, dev="cuda", b=500, n=999, h=100,
                       nsample=10000, iters=300, expiry=EXPIRY_STEPS,
                       crps_assets=64):
    """``price_options_batch`` at the BASELINE configuration: 500 SABR
    series, 10k paths of 100 steps, 21 strikes from 0.8x to 1.2x the median
    last price, four expiries, the realised prices from each series' own
    continuation."""
    from volt_tpu_torch.calibration import calibration, crps
    from volt_tpu_torch.parallel import PipelineConfig, price_options_batch

    f, _ = vt.data.sabr_paths(steps=n + 1 + h, seed=5, n_paths=b)
    x, test_x = grids(torch, n, h, dev)
    ys = torch.tensor(f[:, :n + 1], device=dev)
    future = torch.tensor(f[:, n + 1:], device=dev)  # (B, H)
    realized = future[:, list(expiry)]
    strikes = torch.linspace(0.8, 1.2, 21, device=dev) * ys[:, -1].median()
    cfg = PipelineConfig(output="samples", nsample=nsample, gpcv_iters=iters,
                         vol_iters=iters, data_iters=iters)
    g = torch.Generator(device=dev).manual_seed(6)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    native.launches.clear()
    t0 = time.perf_counter()
    res = price_options_batch(g, x, ys, test_x, strikes, expiry, cfg,
                              realized=realized)
    _sync(torch, dev)
    total = time.perf_counter() - t0
    launches = dict(native.launches)
    stages = {k: round(v, 4) for k, v in res["aux"]["stage_seconds"].items()}
    grid_s = total - sum(res["aux"]["stage_seconds"].values())
    rate = b * nsample * h / res["aux"]["stage_seconds"]["rollout"]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else float("nan"))
    print(f"   price_options_batch B={b}, {nsample} paths x {h} steps: "
          f"{total:.3f} s; stages (s) {stages}, payoff grid "
          f"{grid_s:.4f}; rollout {rate:.4g} path-steps/s; peak "
          f"{peak:.2f} GiB allocated ({CARD})")
    print(f"   kernel launches in the call: {launches}")

    values, fwd, pct = res["values"], res["forwards"], res["percentiles"]
    k, e = len(strikes), len(expiry)
    if tuple(values.shape) != (b, k, e) or tuple(fwd.shape) != (b, e) or \
            tuple(pct.shape) != (b, e):
        fail(f"option_pricing: shapes {tuple(values.shape)}, "
             f"{tuple(fwd.shape)}, {tuple(pct.shape)}")
    if not torch.isfinite(values).all() or not bool((values >= 0).all()):
        fail("option_pricing: values non-finite or negative")
    rise = (values.diff(dim=1) / values[:, :-1].clamp(min=1e-30)).max()
    if not bool((values.diff(dim=1) <= 1e-5 * values[:, :-1]).all()):
        fail(f"option_pricing: values rise with the strike (rel {rise:.2e})")
    if not torch.isfinite(fwd).all():
        fail("option_pricing: non-finite forwards")
    if not bool(((pct >= 0) & (pct <= 1)).all()):
        fail("option_pricing: percentiles outside [0, 1]")
    if not bool(res["aux"]["ok"].all()):
        fail(f"option_pricing: {int((~res['aux']['ok']).sum())} assets "
             f"failed")
    _check_launched("option_pricing", launches, dev)

    levels, observed = calibration(pct)
    paths = torch.exp(res["samples"][:crps_assets])
    score = torch.stack([crps(paths[i], future[i]).mean()
                         for i in range(len(paths))]).mean().item()
    cal = {f"{lv:.2f}": round(ob, 4)
           for lv, ob in zip(levels.tolist(), observed.tolist())}
    print(f"   calibration(percentiles), level: observed {cal}")
    print(f"   mean CRPS over {len(paths)} assets and {h} steps: {score:.5f}")
    return launches, {"s": total, "stages": stages, "grid_s": grid_s,
                      "rollout_path_steps_per_s": rate, "peak_gib": peak,
                      "calibration": cal, "crps": score,
                      "atm_value_mean": values[:, k // 2].mean(0).tolist()}


def _mesh_inputs(torch, vt, dev, b, n, h, s, seed):
    """``b`` SABR series of ``n`` returns with their ``h``-step continuation,
    the grids, and the pipeline's normals for ``s`` paths, drawn alike in
    every process from ``seed`` on ``dev``."""
    f, _ = vt.data.sabr_paths(steps=n + 1 + h, seed=seed, n_paths=b)
    x, test_x = grids(torch, n, h, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = {"vol_r0": torch.randn(b, s, device=dev, generator=g),
             "vol_z": torch.randn(b, s, h, device=dev, generator=g),
             "zs": torch.randn(b, s, h, device=dev, generator=g)}
    ys = torch.tensor(f, device=dev)
    return x, test_x, ys[:, :n + 1], ys[:, n + 1:], noise


def _mesh_pricing(torch, future, ys, h):
    """The option_pricing phase's grid: 21 strikes from 0.8x to 1.2x the
    median last price, the expiries, the realised prices there."""
    expiry = [e for e in EXPIRY_STEPS if e < h] or [h - 1]
    strikes = torch.linspace(0.8, 1.2, 21, device=ys.device) \
        * ys[:, -1].median()
    return strikes, expiry, future[:, expiry]


def _mesh_rank(rank, dev, sizes):
    """One rank of the mesh phase's world of 2 on one device (gloo, the
    collectives staged through host memory): the unsharded call on the
    rank's block of assets, the main path on a (2, 1) mesh, then
    ``price_options_batch`` on a (1, 2) mesh.  Returns the block's
    reference, the gathered fan, the values, the seconds, the peak memory,
    the K1 and S1 launches of the sharded calls, and the shapes of every
    launch."""
    import torch

    import volt_tpu_torch as vt
    from volt_tpu_torch import native
    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         make_mesh, price_options_batch)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [dev] * 2
    seen, out = set(), {}
    native.launches.clear()
    with _launch_shapes(native, seen):
        x, test_x, ys, _, noise = _mesh_inputs(torch, vt, dev,
                                               *sizes["main"])
        mesh = make_mesh((2, 1), devices=devices, backend="gloo")
        cfg = PipelineConfig(output="quantiles", **sizes["cfg"])
        # the reference first, which also pays the process's first-use
        # costs: the unsharded call on this rank's block of assets
        half = len(ys) // 2
        block = slice(half * mesh.coords[0], half * (mesh.coords[0] + 1))
        t0 = time.perf_counter()
        out["block_want"], _ = fit_forecast_batch(
            None, x, ys[block], test_x, cfg,
            noise={k: v[block] for k, v in noise.items()})
        _sync(torch, dev)
        out["block_want_s"] = time.perf_counter() - t0
        native.launches.clear()  # the sharded path's launches count
        _reset_peak(torch, dev)
        t0 = time.perf_counter()
        fan, _ = fit_forecast_batch(None, x, ys, test_x, cfg, noise=noise,
                                    mesh=mesh)
        out["fan"] = mesh.gather(fan, ("asset",))
        _sync(torch, dev)
        out["main_s"] = time.perf_counter() - t0
        out["main_peak_gib"] = _peak_gib(torch, dev)
        del noise

        x, test_x, ys, future, noise = _mesh_inputs(torch, vt, dev,
                                                    *sizes["pricing"])
        strikes, expiry, realized = _mesh_pricing(torch, future, ys,
                                                  test_x.shape[-1])
        mesh = make_mesh((1, 2), devices=devices, backend="gloo")
        pcfg = PipelineConfig(output="samples",
                              **{**sizes["cfg"],
                                 "nsample": sizes["pricing"][3]})
        _reset_peak(torch, dev)
        t0 = time.perf_counter()
        res = price_options_batch(None, x, ys, test_x, strikes, expiry, pcfg,
                                  realized=realized, noise=noise, mesh=mesh)
        _sync(torch, dev)
        out["pricing_s"] = time.perf_counter() - t0
        out["pricing_peak_gib"] = _peak_gib(torch, dev)
        out["values"] = res["values"]
    out["launches"] = dict(native.launches)
    out["seen"] = seen
    return out


def run_mesh(torch, vt, native, dev="cuda", b=64, n=999, h=100,
             nsample=1000, iters=100, price_b=500, price_s=10000,
             profile_b=8, profile_iters=10,
             examples=(("--iters", "100"), ("--iters", "100")),
             timeout=600.0):
    """The scale-out layer on one card:

    1. a world of one process over NCCL (``multihost_initialize`` at a
       localhost address, ``make_mesh()``): ``fit_forecast_batch(mesh=)`` at
       B=64, n=999, the defaults but ``iters`` Adam steps a stage (100:
       the defaults' 300 cut to make room for the evaluation phase; the
       pricing calls too), quantiles, on given normals, against the
       unsharded call on the same normals (1e-6 of max|fan|);
    2. a world of 2 processes on the card (gloo: NCCL refuses two ranks on
       one card), spawned after the kernels were built here: each rank
       runs the unsharded call on its 32 assets (the reference, and the
       process's first-use costs), then the main path on a (2, 1) mesh;
       the gathered fan against the two references joined (1e-5 of
       max|fan|), and against step 1's B=64 fan at the pipeline's
       tolerance (rtol 2e-3, atol 1e-3: at B=32 the card's reductions sum
       in another order than at B=64, and the Adam steps carry the
       difference; printed); ``price_options_batch`` on a (1, 2) mesh at
       500 x 10k x 100, 21 strikes, 4 expiries (5k paths a rank), its
       values against the unsharded call's on the same normals (1e-5 of
       the largest value);
    3. a checkpoint round trip: a Volt state fitted on the card (one SABR
       series, n=999, its true vol path, 100 steps a model), saved,
       restored, and the same forecast from both on the same draws;
    4. ``profiling.trace`` over one warm ``fit_forecast_batch`` at B=8,
       n=999 (10 steps a stage): the Chrome trace must name K1's and S1's
       kernels;
    5. ``graft_entry.entry()``'s step on the card, K1 and S1 launched;
    6. the ``live_serving`` and ``option_pricing`` examples on the card
       with ``examples``' flags (their defaults but ``--iters 100``, from
       300); the warm refit's seconds per tick printed.

    Every K1 and S1 launch of the phase, in this process and in the
    ranks, must be at a shape that the kernels phase holds against the
    plain version."""
    import datetime
    import socket
    import tempfile

    import torch.distributed as dist

    from volt_tpu_torch import graft_entry
    from volt_tpu_torch.examples import live_serving, option_pricing
    from volt_tpu_torch.models import BMGP, VoltGP, make_mean
    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         make_mesh, multihost_initialize,
                                         price_options_batch, spawn_world)
    from volt_tpu_torch.rollouts import rollouts
    from volt_tpu_torch.train import train_vol_model, train_volt_magpie
    from volt_tpu_torch.utils import (restore_volt_state, save_volt_state,
                                      trace)

    cfg_kw = dict(gpcv_iters=iters, vol_iters=iters, data_iters=iters,
                  nsample=nsample)
    cfg = PipelineConfig(output="quantiles", **cfg_kw)
    sizes = {"main": (b, n, h, nsample, 21),
             "pricing": (price_b, n, h, price_s, 22), "cfg": cfg_kw}
    result, seen = {}, set()
    mesh_launches = {}

    def item(name, seconds, launches):
        peak = _peak_gib(torch, dev)
        result[name] = {"s": seconds, "peak_gib": peak, "launches": launches}
        print(f"   {name}: {seconds:.3f} s, peak {peak:.2f} GiB allocated, "
              f"launches {launches} ({CARD})")

    with _launch_shapes(native, seen):
        # ---- 1: a world of one over NCCL --------------------------------
        x, test_x, ys, _, noise = _mesh_inputs(torch, vt, dev, *sizes["main"])
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if not multihost_initialize(
                f"127.0.0.1:{port}", 1, 0,
                backend="nccl" if dev == "cuda" else "gloo",
                timeout=datetime.timedelta(seconds=timeout)):
            fail("mesh: a process group was already initialised")
        try:
            mesh = make_mesh(devices=[dev])
            _reset_peak(torch, dev)
            (fan1, _), secs, launches = _timed(
                torch, dev, native, lambda: fit_forecast_batch(
                    None, x, ys, test_x, cfg, noise=noise, mesh=mesh))
        finally:
            dist.destroy_process_group()
        print(f"   world of 1: backend {mesh.backend}, mesh {mesh.shape}")
        item("world_of_1", secs, launches)
        mesh_launches = dict(launches)
        t0 = time.perf_counter()
        want, _ = fit_forecast_batch(None, x, ys, test_x, cfg, noise=noise)
        _sync(torch, dev)
        one_s = time.perf_counter() - t0
        scale = want.abs().max().item()
        err1 = (fan1 - want).abs().max().item()
        print(f"   world of 1 against the unsharded call ({one_s:.3f} s): "
              f"max abs diff {err1:.3e} (tol 1e-6 x max|fan| = "
              f"{1e-6 * scale:.3e})")
        if not err1 <= 1e-6 * scale:
            fail("mesh: the world of 1 differs from the unsharded call")
        del noise

        # ---- 2: a world of 2 processes on the card -----------------------
        px, ptx, pys, pfuture, pnoise = _mesh_inputs(torch, vt, dev,
                                                     *sizes["pricing"])
        strikes, expiry, realized = _mesh_pricing(torch, pfuture, pys, h)
        pcfg = PipelineConfig(output="samples", **{**cfg_kw,
                                                   "nsample": price_s})
        _reset_peak(torch, dev)
        t0 = time.perf_counter()
        want_v = price_options_batch(None, px, pys, ptx, strikes, expiry,
                                     pcfg, realized=realized,
                                     noise=pnoise)["values"]
        _sync(torch, dev)
        print(f"   unsharded price_options_batch B={price_b}, {price_s} "
              f"paths: {time.perf_counter() - t0:.3f} s, peak "
              f"{_peak_gib(torch, dev):.2f} GiB allocated")
        del pnoise
        if dev == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_world(_mesh_rank, 2, (dev, sizes), timeout=timeout)
        world_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            print(f"   rank {r} of 2: the unsharded call on its block "
                  f"{res['block_want_s']:.3f} s (the process's first), the "
                  f"main path {res['main_s']:.3f} s (peak "
                  f"{res['main_peak_gib']:.2f} GiB), pricing "
                  f"{res['pricing_s']:.3f} s (peak "
                  f"{res['pricing_peak_gib']:.2f} GiB); launches "
                  f"{res['launches']}")
            seen |= res["seen"]
            for sym, count in res["launches"].items():
                mesh_launches[sym] = mesh_launches.get(sym, 0) + count
        fan2 = ranks[0]["fan"].to(dev)
        want2 = torch.cat([r["block_want"] for r in ranks]).to(dev)
        err_blocks = (fan2 - want2).abs().max().item()
        err2 = (fan2 - fan1).abs().max().item()
        values = ranks[0]["values"].to(dev)
        vscale = want_v.abs().max().item()
        err_v = (values - want_v).abs().max().item()
        print(f"   world of 2, (2, 1) mesh: the gathered fan against the "
              f"unsharded calls on each rank's {b // 2} assets, joined: max "
              f"abs diff {err_blocks:.3e} (tol 1e-5 x max|fan| = "
              f"{1e-5 * scale:.3e}); against the world of 1's B={b}: max "
              f"abs diff {err2:.3e} ({err2 / scale:.2e} of max|fan|; tol "
              f"rtol 2e-3, atol 1e-3, the pipeline's: the card's reductions "
              f"take another order at another batch size, and 900 Adam "
              f"steps carry it)")
        print(f"   (1, 2) mesh: values against the unsharded call: max abs "
              f"diff {err_v:.3e} (tol 1e-5 x the largest value = "
              f"{1e-5 * vscale:.3e}); the world took {world_s:.3f} s, "
              f"spawning included ({CARD})")
        if not all(torch.equal(r["fan"], ranks[0]["fan"])
                   and torch.equal(r["values"], ranks[0]["values"])
                   for r in ranks):
            fail("mesh: the ranks gathered different results")
        if not err_blocks <= 1e-5 * scale:
            fail("mesh: the world of 2's fan differs from the unsharded "
                 "calls on the ranks' assets")
        if not torch.allclose(fan2, fan1, rtol=2e-3, atol=1e-3):
            fail("mesh: the world of 2's fan differs from the world of 1's")
        if not err_v <= 1e-5 * vscale:
            fail("mesh: the world of 2's option values differ from the "
                 "unsharded call's")
        result["world_of_2"] = {
            "s": world_s, "main_s": [r["main_s"] for r in ranks],
            "pricing_s": [r["pricing_s"] for r in ranks],
            "peak_gib": [max(r["main_peak_gib"], r["pricing_peak_gib"])
                         for r in ranks],
            "block_want_s": [r["block_want_s"] for r in ranks],
            "unsharded_b64_s": one_s}
        result.update(fan_err_world_of_1=err1, fan_err_blocks=err_blocks,
                      fan_err_world_of_2=err2, values_err=err_v)

        # ---- 3: a checkpoint round trip on the card ----------------------
        f, v_true = vt.data.sabr_paths(steps=n + 1, seed=23)
        x1, test_x1 = grids(torch, n, h, dev)
        y1 = torch.tensor(f, device=dev)
        vol1 = torch.tensor(v_true[1:], device=dev)
        _reset_peak(torch, dev)

        def checkpoint():
            vol_state = train_vol_model(x1, vol1, train_iters=100)
            model = train_volt_magpie(x1, y1[1:], vol_state, vol1,
                                      train_iters=100, k=300)
            with tempfile.TemporaryDirectory() as tmp:
                path = str(Path(tmp) / "volt.pt")
                save_volt_state(path, model)
                restored = restore_volt_state(
                    path, VoltGP(mean=make_mean("ewma", k=300)), BMGP())
            return [rollouts(torch.Generator(device=dev).manual_seed(24), st,
                             x1, y1, test_x1, nsample=nsample)
                    for st in (model, restored)]

        (s_a, s_b), secs, launches = _timed(torch, dev, native, checkpoint)
        item("checkpoint", secs, launches)
        if not torch.equal(s_a, s_b) or not torch.isfinite(s_a).all():
            fail("mesh: the restored state forecasts differently")

        # ---- 4: a profiler trace of one warm call -------------------------
        px8, ptx8, pys8, _, _ = _mesh_inputs(torch, vt, dev, profile_b, n, h,
                                             1, 25)
        pcfg8 = PipelineConfig(output="quantiles", gpcv_iters=profile_iters,
                               vol_iters=profile_iters,
                               data_iters=profile_iters, nsample=nsample)
        g8 = torch.Generator(device=dev).manual_seed(26)
        fit_forecast_batch(g8, px8, pys8, ptx8, pcfg8)  # warm
        _reset_peak(torch, dev)

        def traced():
            with tempfile.TemporaryDirectory() as tmp:
                with trace(tmp):
                    fit_forecast_batch(g8, px8, pys8, ptx8, pcfg8)
                    _sync(torch, dev)
                text = (Path(tmp) / "trace.json").read_text()
            return text

        text, secs, launches = _timed(torch, dev, native, traced)
        item("profiled_call", secs, launches)
        named = {k: k in text for k in ("ewma_filter_kernel",
                                         "kalman_forward_kernel",
                                         "kalman_backward_kernel")}
        print(f"   the Chrome trace ({len(text) / 2 ** 20:.1f} MiB) names "
              f"{named}")
        if dev == "cuda" and not all(named.values()):
            fail("mesh: the profiler trace does not name K1's and S1's "
                 "kernels")

        # ---- 5: the graft entry's step on the card -----------------------
        step, args = graft_entry.entry(dev)
        _reset_peak(torch, dev)
        (mll, paths), secs, launches = _timed(torch, dev, native,
                                              lambda: step(*args))
        item("entry", secs, launches)
        if not bool(torch.isfinite(mll)) or \
                not bool(torch.isfinite(paths).all()):
            fail("mesh: entry() gave non-finite outputs")
        if dev == "cuda" and (launches.get(K1_SYM, 0) < 1
                              or launches.get(S1_SYMS[0], 0) < 1):
            fail(f"mesh: entry() launched {launches}")

        # ---- 6: two examples at their defaults ---------------------------
        _reset_peak(torch, dev)
        live, secs, launches = _timed(
            torch, dev, native,
            lambda: live_serving.main(["--device", dev, *examples[0]]))
        item("live_serving", secs, launches)
        result["live_serving"]["refit_s_per_tick"] = live["refit_s"]
        print(f"   live_serving warm refit seconds per tick: "
              f"{[round(v, 4) for v in live['refit_s']]} ({CARD})")
        if not bool(live["ok"].all()):
            fail("mesh: live_serving flagged a failed asset")
        _reset_peak(torch, dev)
        _, secs, launches = _timed(
            torch, dev, native,
            lambda: option_pricing.main(["--device", dev, *examples[1]]))
        item("option_pricing_example", secs, launches)

    unchecked = sorted(seen - _checked_shapes())
    print(f"   K1 and S1 launch shapes in the phase: {sorted(seen)}")
    if dev == "cuda":
        if unchecked:
            fail(f"mesh: K1 or S1 launched at shapes that the kernels phase "
                 f"does not hold against their plain versions: {unchecked}")
        for sym in (K1_SYM, *S1_SYMS):
            if mesh_launches.get(sym, 0) < 1:
                fail(f"mesh: {sym} was not launched by the sharded path")
    result["launches"] = mesh_launches
    return mesh_launches, result


def _flat_rows(tool, out):
    """A tool's ``main`` result as ``{(universe, lane): {metric: value}}``,
    the layout of ``jax_reference.json``'s items."""
    if tool == "eval_compare":
        return {(u, lane): m for u, rows in out.items()
                for lane, m in rows.items()}
    if tool == "eval_options":
        return {("GBM", lane): m for lane, m in out.items()}
    return {("CORRVOL", lane): {f"{part}.{k}": v
                                for part in ("marginal", "gust_energy")
                                for k, v in out[lane][part].items()}
            for lane in ("independent", "multitask")}


def run_evaluation(torch, vt, native, dev="cuda"):
    """The evaluation tools (``volt_tpu_torch/tools``) on the card at the
    evaluation's widths (ntrain 252 for the price universes and 400 for
    the wind one, H=20, S=256 (1024 for options), 300 Adam steps a stage,
    400 for the basic GPs, an LSTM of hidden 64 for 40 epochs), with the
    number of windows cut to fit the time:

    (a) ``eval_compare``'s volt lane on GBM and SABR, then WINDGUST, W=32;
    (b) its Matérn, spectral-mixture and LSTM lanes on GBM, W=4;
    (c) ``eval_options`` on GBM, the volt lane and ``oracle-mc``, W=16;
    (d) ``eval_multitask``, W=1, T=4 stations (at the tool's 8 the item
        alone took 53.5 s: its independent lane's per-station fits run 600
        host-bound vol-GP steps each), both lanes.

    Each item runs the tool's ``main`` with the flags that
    ``volt_tpu_torch/tools/jax_reference.json`` records, at PyTorch's
    default precision as the CLIs run.  Every metric must lie within its
    band of the JAX package's key-0 value (``max(3 x spread over keys,
    floor)``, written there before the phase's first run on the card);
    the ones marked not gated are printed.  Every volt window must be
    ``ok`` (the volt lane raises otherwise), K1 and S1 must be launched,
    and every K1 and S1 launch must be at a shape that the kernels phase
    checks."""
    import importlib
    import io

    ref = json.loads((Path(vt.__file__).parent / "tools"
                      / "jax_reference.json").read_text())
    groups = {}
    for it in ref["items"]:
        groups.setdefault((it["tool"], tuple(it["argv"])), []).append(it)
    seen, items, launches, rows, outside = set(), {}, {}, [], []
    _reset_peak(torch, dev)
    t_phase = time.perf_counter()
    with _launch_shapes(native, seen), _default_precision(torch):
        for (tool, argv), its in groups.items():
            mod = importlib.import_module(f"volt_tpu_torch.tools.{tool}")
            name = f"{tool} {' '.join(argv)}"
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    out, secs, counts = _timed(torch, dev, native, lambda: (
                        mod.main(["--device", dev, *argv])))
            except AssertionError as exc:
                fail(f"evaluation: {name}: {exc}")
            items[name] = {"s": secs, "launches": counts}
            for sym, c in counts.items():
                launches[sym] = launches.get(sym, 0) + c
            print(f"   {name}: {secs:.3f} s; launches {counts} ({CARD})",
                  flush=True)
            got_rows = _flat_rows(tool, out)
            for it in its:
                got = got_rows[(it["universe"], it["lane"])]
                for metric, m in it["metrics"].items():
                    val = float(got[metric])
                    diff = abs(val - m["key0"])
                    rows.append({"tool": tool, "universe": it["universe"],
                                 "lane": it["lane"], "metric": metric,
                                 "card": val, "jax_key0": m["key0"],
                                 "diff": diff, "band": m.get("band"),
                                 "gated": m["gated"]})
                    within = m["gated"] and diff <= m["band"]
                    print(f"   {tool} {it['universe']} {it['lane']} "
                          f"{metric}: card {val:.6g}, JAX key 0 "
                          f"{m['key0']:.6g}, |diff| {diff:.4g} "
                          + (f"(band {m['band']:.4g}"
                             f"{'' if within else ', OUTSIDE'})"
                             if m["gated"] else f"(not gated: {m['why']})"))
                    if not math.isfinite(val):
                        outside.append(f"{it['lane']} {metric} not finite")
                    elif m["gated"] and not within:
                        outside.append(f"{tool} {it['universe']} "
                                       f"{it['lane']} {metric}: {val} "
                                       f"against {m['key0']} +- {m['band']}")
    secs = time.perf_counter() - t_phase
    peak = _peak_gib(torch, dev)
    print(f"   evaluation: {secs:.3f} s, peak {peak:.2f} GiB allocated "
          f"({CARD})")
    unchecked = sorted(seen - _checked_shapes())
    print(f"   K1 and S1 launch shapes in the phase: {sorted(seen)}")
    if dev == "cuda":
        if unchecked:
            fail(f"evaluation: K1 or S1 launched at shapes that the kernels "
                 f"phase does not hold against their plain versions: "
                 f"{unchecked}")
        _check_launched("evaluation", launches, dev)
    if outside:
        fail("evaluation: metrics outside their band of the JAX package's: "
             + "; ".join(outside))
    return launches, {"items": items, "metrics": rows, "s": secs,
                      "peak_gib": peak, "launch_shapes": sorted(seen)}


# The timing phase's items: (tool, its flags, the environment it reads).
# Every tool runs at its published width; only iterations, repeats and
# the list of sizes are cut from the tools' defaults (in brackets), to
# keep the phase within 45 s of a smoke that runs near its 300 s (the
# phase took 7.1 s on an H100 before ``bench_compile``, whose child
# process, build and first call were expected to take about 20 s)
TIMING_ITEMS = [
    ("ablate_stages", ["64", "1000"],
     {"ABLATE_ITERS": "5", "ABLATE_NSAMPLE": "1000",  # (300)
      "BENCH_OUTPUT": "samples"}),
    ("bench_refit", ["--assets", "64", "--ntrain", "1000", "--iters", "20",
                     "--warm-iters", "2", "--reps", "1"], {}),  # (300, 30, 3)
    ("bench_refit_multitask", ["--tasks", "505", "--ntrain", "1000",
                               "--iters", "10", "--warm-iters", "2",
                               "--reps", "1"], {}),  # (300, 30, 3)
    ("bench_multitask", ["--tasks", "1", "64", "--n", "1000", "--iters",
                         "5", "--repeats", "1"], {}),  # (64..505; 50, 3)
    ("bench_scaling", ["--sizes", "400,25000", "--iters", "5", "--reps",
                       "1"], {}),  # (400..25000; 300, 3)
    ("scaling_study", [], {"SCALE_ASSETS": "16", "SCALE_NTRAIN": "400,8000",
                           "SCALE_ITERS": "5", "SCALE_NSAMPLE": "1000",
                           "BENCH_OUTPUT": "samples"}),  # (400..8000; 300)
    ("bench_fbm", ["--ntrain", "1000", "--assets", "8", "--iters", "5",
                   "--repeats", "1"], {}),  # (400, 1000, 2000; 300, 2)
    ("bench_voltcov", ["--batch", "64", "--n", "999", "--reps", "30"], {}),
    ("bench_compile", ["--assets", "64", "--ntrain", "1000", "--iters", "5",
                       "--nsample", "1000", "--reps", "1"],
     {}),  # (64 and 500; 300, 3)
]
# The bound that tests/test_tools.py::test_bench_refit holds the JAX
# tool's vol_rel_err_mean to
REFIT_VOL_ERR_BOUND = 1.0


def _finite_numbers(out):
    """Every number in a tool's result (nested dicts and lists)."""
    stack, nums = [out], []
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, (int, float)) and not isinstance(item, bool):
            nums.append(float(item))
    return all(math.isfinite(v) for v in nums)


def run_timing(torch, vt, native, dev="cuda"):
    """The timing tools (``volt_tpu_torch/tools``) on the card, each
    through its ``main`` at its published width with the depth cut
    (``TIMING_ITEMS``): the stage split, the warm refits, the Kronecker
    chain at T=1 and 64, the n-scaling of one asset (n=400 and 25000) and
    of B=16 (ntrain 400 and 8000), the FBM pipeline at 8 x 1000, K2
    against its twin at (64, 999) and the time to first forecast at 64 x
    1000 in a fresh child.  Each tool's lines are printed with the card;
    checks: every ``ok`` and finite number the tools print, K2
    bit-identical to its twin, ``bench_refit``'s ``vol_rel_err_mean``
    under ``REFIT_VOL_ERR_BOUND``, ``bench_compile``'s child built the
    kernels, K1, S1 and K2 launched, and every K1 and S1 launch at a
    shape that the kernels phase checks (the child's launches are its
    own: at (64, 999) with k=100, shapes that phase checks)."""
    import importlib
    import io
    from unittest import mock

    seen, results, launches = set(), {}, {}
    _reset_peak(torch, dev)
    t_phase = time.perf_counter()
    with _launch_shapes(native, seen):
        for tool, argv, env in TIMING_ITEMS:
            mod = importlib.import_module(f"volt_tpu_torch.tools.{tool}")
            buf = io.StringIO()
            try:
                with mock.patch.dict(os.environ, env), \
                        contextlib.redirect_stdout(buf):
                    out, secs, counts = _timed(torch, dev, native, lambda: (
                        mod.main(["--device", dev, *argv])))
            except (AssertionError, SystemExit) as exc:
                fail(f"timing: {tool}: {exc}\n{buf.getvalue()}")
            for line in buf.getvalue().strip().splitlines():
                print(f"   {tool}: {line} ({CARD})")
            print(f"   {tool}: {secs:.3f} s; launches {counts} ({CARD})",
                  flush=True)
            results[tool] = {"s": secs, "launches": counts, "out": out}
            for sym, c in counts.items():
                launches[sym] = launches.get(sym, 0) + c
            if not _finite_numbers(out):
                fail(f"timing: {tool} printed a non-finite number")
    secs = time.perf_counter() - t_phase
    peak = _peak_gib(torch, dev)
    print(f"   timing: {secs:.3f} s, peak {peak:.2f} GiB allocated ({CARD})")

    refit = results["bench_refit"]["out"]
    err = refit["vol_rel_err_mean"]
    print(f"   bench_refit vol_rel_err_mean {err} (bound "
          f"{REFIT_VOL_ERR_BOUND})")
    if not (refit["ok"] and err < REFIT_VOL_ERR_BOUND):
        fail(f"timing: bench_refit ok {refit['ok']}, vol_rel_err_mean {err}")
    if not results["bench_refit_multitask"]["out"]["ok"]:
        fail("timing: bench_refit_multitask's warm refit failed a task")
    for rec in results["bench_fbm"]["out"]:
        if not (rec["finite"] and rec["ok_frac"] == 1.0):
            fail(f"timing: bench_fbm at ntrain {rec['ntrain']}: finite "
                 f"{rec['finite']}, ok_frac {rec['ok_frac']}")
    if not results["bench_voltcov"]["out"]["bit_identical"]:
        fail("timing: K2 differs from its plain twin")
    for rec in results["bench_compile"]["out"]:
        if "error" in rec:
            fail(f"timing: bench_compile's child failed: {rec['error']}")
        if dev == "cuda" and not rec["build_s"] > 0:
            fail("timing: bench_compile's child built nothing (build_s 0)")
    print(f"   K1 and S1 launch shapes in the phase: {sorted(seen)}")
    if dev == "cuda":
        unchecked = sorted(seen - _checked_shapes())
        if unchecked:
            fail(f"timing: K1 or S1 launched at shapes that the kernels "
                 f"phase does not hold against their plain versions: "
                 f"{unchecked}")
        _check_launched("timing", launches, dev)
        if launches.get("volt_covariance", 0) < 1:
            fail("timing: K2 (volt_covariance) was not launched")
    return launches, {"items": {k: {"s": v["s"], "launches": v["launches"]}
                                for k, v in results.items()},
                      "outputs": {k: v["out"] for k, v in results.items()},
                      "s": secs, "peak_gib": peak,
                      "launch_shapes": sorted(seen)}


def check_small_agreement(torch, vt):
    """Card against CPU on the parity tests' small input and noise: the
    main path, the dense GPCV family (its Laplace init, compared on
    ``S = R R^T``, and the pipeline), a cv fit and ``price_options_batch``,
    each at its stated tolerance."""
    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         price_options_batch)

    b, n, h, s = 2, 72, 10, 64
    f, _ = vt.data.sabr_paths(steps=n + 1, seed=77, n_paths=b)
    cfg = PipelineConfig(gpcv_iters=60, vol_iters=60, data_iters=40, k=20,
                         nsample=s, output="quantiles")
    g = torch.Generator().manual_seed(5)
    noise = {"vol_r0": torch.randn(b, s, generator=g),
             "vol_z": torch.randn(b, s, h, generator=g),
             "zs": torch.randn(b, s, h, generator=g)}
    res = {}
    for dev in ("cpu", "cuda"):
        x, test_x = grids(torch, n, h, dev)
        res[dev] = fit_forecast_batch(
            None, x, torch.tensor(f, device=dev), test_x, cfg,
            noise={k: v.to(dev) for k, v in noise.items()})
    (fan_c, aux_c), (fan_g, aux_g) = res["cpu"], res["cuda"]
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        if not torch.allclose(aux_g[key].cpu(), aux_c[key], rtol=1e-3):
            fail(f"small input: {key} differs between card and CPU")
    err = (fan_g.cpu() - fan_c).abs().max().item()
    print(f"   small input: fan max abs diff card vs CPU {err:.3e}")
    if not torch.allclose(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3):
        fail("small input: fan differs between card and CPU")

    # the dense family's Laplace init (three Cholesky factorisations, whose
    # jitter ladders may take different steps in cuSOLVER and LAPACK at the
    # edge of float32): S = R R^T at 1e-3 of its largest entry.  On a grid
    # from one step in, as the parity tests run it: from x = 0 the root's
    # first entry starts at lr and Adam's first step leaves it near 7e-8,
    # where the KL's log|diag| amplifies the two devices' rounding
    roots = {}
    for dev in ("cpu", "cuda"):
        x, _ = grids(torch, n, h, dev, start=1)
        yy = vt.train.scaled_returns(x, torch.tensor(f, device=dev))
        m = vt.models.GPCVModel(q="full").init(x, yy, per_lane=True)
        roots[dev] = torch.tril(m.chol_variational_covar).double().cpu()
    s_c, s_g = (r @ r.mT for r in (roots["cpu"], roots["cuda"]))
    err = (s_g - s_c).abs().max().item()
    print(f"   small input: dense GPCV init S max abs diff card vs CPU "
          f"{err:.3e} (tol {1e-3 * s_c.abs().max().item():.3e})")
    if not err <= 1e-3 * s_c.abs().max().item():
        fail("small input: the dense GPCV init differs between card and CPU")

    # the pipeline with the dense family, 20 steps a stage (the parity
    # tests' gpcv_q="full" run), at rtol 1e-2: Adam's normalised step moves
    # an entry of the n x n root by about lr whatever its gradient, so the
    # devices' different rounding of the near-zero gradients (summation
    # order) becomes lr-sized moves.  Measured on the CPU: gradient noise
    # of 1e-6 of the largest gradient moves the dense family's loss by up
    # to 3.6e-3 and its vol by 2.6e-3 after 20 steps, the tridiagonal
    # family's by 3e-5
    cfg_full = PipelineConfig(gpcv_q="full", gpcv_iters=20, vol_iters=20,
                              data_iters=20, k=20, nsample=s,
                              output="quantiles")
    res = {}
    for dev in ("cpu", "cuda"):
        x, test_x = grids(torch, n, h, dev, start=1)
        res[dev] = fit_forecast_batch(
            None, x, torch.tensor(f, device=dev), test_x, cfg_full,
            noise={k: v.to(dev) for k, v in noise.items()})
    (fan_c, aux_c), (fan_g, aux_g) = res["cpu"], res["cuda"]
    rels = {key: ((aux_g[key].cpu() - aux_c[key]).abs()
                  / aux_c[key].abs()).max().item()
            for key in ("gpcv_loss", "vol_loss", "data_loss", "vol")}
    rels["fan"] = ((fan_g.cpu() - fan_c).abs() / fan_c.abs()).max().item()
    print(f"   small input, gpcv_q='full': max rel diff card vs CPU "
          f"{ {k: f'{v:.2e}' for k, v in rels.items()} } (tol 1e-2)")
    if not all(v <= 1e-2 for v in rels.values()):
        fail("small input, gpcv_q='full': the pipeline differs between card "
             "and CPU")

    # a cv fit: 5 NGVI iterations, the predicted scale at rtol 1e-3
    scales = {}
    for dev in ("cpu", "cuda"):
        x, _ = grids(torch, n, h, dev)
        scales[dev] = vt.learn_gpcv(x, torch.tensor(f[0], device=dev), 5,
                                    param="cv").cpu()
    err = ((scales["cuda"] - scales["cpu"]).abs()
           / scales["cpu"].abs()).max().item()
    print(f"   small input, cv fit: predicted scale max rel diff card vs CPU "
          f"{err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("small input: the cv fit differs between card and CPU")

    # price_options_batch on the same noise: values at the fan's
    # tolerance (rtol 2e-3, atol 1e-3 of the largest strike); a path
    # within that of the realised price may change side, so percentiles
    # within 2 / S
    cfg_s = PipelineConfig(gpcv_iters=20, vol_iters=20, data_iters=20, k=20,
                           nsample=s, output="samples")
    strikes = (float(f[:, -1].mean()) * torch.linspace(0.9, 1.1, 5)).tolist()
    expiry, realized = [1, 4, 9], f[:, -1:] * [[0.99, 1.0, 1.02]]
    out = {}
    for dev in ("cpu", "cuda"):
        x, test_x = grids(torch, n, h, dev)
        out[dev] = price_options_batch(
            None, x, torch.tensor(f, device=dev), test_x, strikes, expiry,
            cfg_s, realized=realized,
            noise={k: v.to(dev) for k, v in noise.items()})
    vc, vg = out["cpu"]["values"], out["cuda"]["values"].cpu()
    err = (vg - vc).abs().max().item()
    pct = (out["cuda"]["percentiles"].cpu()
           - out["cpu"]["percentiles"]).abs().max().item()
    print(f"   small input, price_options_batch: values max abs diff card vs "
          f"CPU {err:.3e}, percentiles {pct:.3e} (tol {2 / s:.3e})")
    if not torch.allclose(vg, vc, rtol=2e-3, atol=1e-3 * max(strikes)) or \
            not pct <= 2 / s:
        fail("small input: price_options_batch differs between card and CPU")

    check_small_agreement_slice_d(torch, vt, f, noise, n, h, s)
    check_small_agreement_baselines(torch, vt)


def check_small_agreement_slice_d(torch, vt, f, noise, n, h, s):
    """Card against CPU for the FBM pipeline, the multitask pipeline and
    the FFT projection, each at its stated tolerance."""
    from volt_tpu_torch.ops.brownian import min_kernel_project
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         PipelineConfig, fit_forecast_batch,
                                         fit_forecast_multitask)

    # the FBM pipeline, 20 steps a stage, at rtol 1e-2: it runs the dense
    # GPCV family, whose Adam turns rounding into lr-sized moves; measured
    # on the CPU, a 1e-7 relative change of the prices moves its vol by up
    # to 2.1e-3 and its GPCV loss by 5.3e-4
    cfg = PipelineConfig(kernel="fbm", gpcv_iters=20, vol_iters=20,
                         data_iters=20, k=20, nsample=s, output="quantiles")
    res = {}
    for dev in ("cpu", "cuda"):
        x, test_x = grids(torch, n, h, dev)
        res[dev] = fit_forecast_batch(
            None, x, torch.tensor(f, device=dev), test_x, cfg,
            noise={k: v.to(dev) for k, v in noise.items()})
    (fan_c, aux_c), (fan_g, aux_g) = res["cpu"], res["cuda"]
    rels = {key: ((aux_g[key].cpu() - aux_c[key]).abs()
                  / aux_c[key].abs()).max().item()
            for key in ("gpcv_loss", "vol_loss", "data_loss", "vol")}
    rels["fan"] = ((fan_g.cpu() - fan_c).abs() / fan_c.abs()).max().item()
    print(f"   small input, kernel='fbm': max rel diff card vs CPU "
          f"{ {k: f'{v:.2e}' for k, v in rels.items()} } (tol 1e-2)")
    if not all(v <= 1e-2 for v in rels.values()) or \
            not bool(aux_g["ok"].all()):
        fail("small input, kernel='fbm': the pipeline differs between card "
             "and CPU")

    # the multitask pipeline on T=3 of the same kind of series, the same
    # initial draws and normals, at the single-task pipeline's tolerances:
    # losses and vols rtol 1e-3, fan rtol 2e-3 / atol 1e-3 (measured on
    # the CPU, a 1e-7 relative change of the prices moves its GPCV loss by
    # 3.9e-5 and its fan by 2e-7)
    t = 3
    f3, _ = vt.data.sabr_paths(steps=n + 1, seed=78, n_paths=t)
    g = torch.Generator().manual_seed(6)
    mnoise = {"vol_z": torch.randn(s, n + h, t, generator=g),
              "vol_eps": torch.randn(s, n, t, generator=g),
              "zs": torch.randn(t, s, h, generator=g)}
    mcfg = MultitaskPipelineConfig(gpcv_iters=20, vol_iters=20,
                                   data_iters=20, nsample=s,
                                   output="quantiles")
    res = {}
    for dev in ("cpu", "cuda"):
        x, test_x = grids(torch, n, h, dev)
        res[dev] = fit_forecast_multitask(
            torch.Generator().manual_seed(3), x,
            torch.tensor(f3, device=dev), test_x, mcfg,
            noise={k: v.to(dev) for k, v in mnoise.items()})
    (fan_c, aux_c), (fan_g, aux_g) = res["cpu"], res["cuda"]
    rels = {key: ((aux_g[key].cpu() - aux_c[key]).abs()
                  / aux_c[key].abs()).max().item()
            for key in ("gpcv_loss", "vol_loss", "data_losses", "vols")}
    err = (fan_g.cpu() - fan_c).abs().max().item()
    print(f"   small input, multitask: max rel diff card vs CPU "
          f"{ {k: f'{v:.2e}' for k, v in rels.items()} } (tol 1e-3); fan max "
          f"abs diff {err:.3e}")
    if not all(v <= 1e-3 for v in rels.values()) or \
            not torch.allclose(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3) or \
            not bool(aux_g["ok"].all()):
        fail("small input: the multitask pipeline differs between card and "
             "CPU")

    # the FFT projection at n=16000, float32 on the card against float64
    # on the CPU: within 2e-6 of max|out|, as the CPU tests hold the
    # float32 projection against the JAX package's
    y = torch.randn(2, 16000, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    want = min_kernel_project(y)
    got = min_kernel_project(y.float().cuda()).cpu().double()
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"   projection n=16000 (FFT), card float32 vs CPU float64: max "
          f"abs diff {err:.3e} of max|out| (tol 2e-6)")
    if not err <= 2e-6:
        fail("the FFT projection on the card differs from float64")


def setup(package_root=None):
    """Phases 1 and 2: the card, then the kernels built.  ``package_root``
    is the tree whose ``volt_tpu_torch`` is imported (default: the one on
    ``sys.path``, this file's when run from its checkout)."""
    t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if package_root is not None:
        sys.path.insert(0, str(Path(package_root).resolve()))
    try:
        import volt_tpu_torch as vt
        from volt_tpu_torch import native
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repository ({exc})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    global CARD
    card = CARD = smi.stdout.strip()
    print(card)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; {Path(vt.__file__).parent}")
    # true float32 for the checks against the plain versions (the
    # baselines' items restore PyTorch's defaults, as their CLIs run)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    done(t0)

    t0 = phase("build")
    native.library()
    print(native.build_log().strip())
    done(t0)
    return torch, vt, native, card


def smoke():
    torch, vt, native, card = setup()

    t0 = phase("kernels against their plain versions")
    with kalman_references(torch, vt) as refs:
        k1 = check_ewma(torch)
        fwd_err, bwd_err = check_kalman(torch, refs)
    s1 = time_kalman(torch, vt)
    s1[0]["max_abs_err"], s1[1]["max_abs_err"] = fwd_err, bwd_err
    kernels = [k1, *s1, check_volt_cov(torch), *check_gh_ell(torch),
               check_gpcv_elbo(torch), check_bm_vol_mll(torch),
               check_mt_gpcv_elbo(torch),
               check_mt_vol_mll(torch)]
    done(t0)

    t0 = phase("main path: fit_forecast_batch, B=64, n=999, defaults")
    launches, main_path = run_main_path(torch, vt, native)
    paths = {"ewma_filter": ("fit_forecast_batch", launches),
             "kalman_forward": ("fit_forecast_batch", launches),
             "kalman_backward": ("fit_forecast_batch", launches),
             "gpcv_tridiag_elbo": ("fit_forecast_batch", launches),
             "bm_vol_spectral_mll": ("fit_forecast_batch", launches)}
    done(t0)

    t0 = phase("reference API: Volt.Train / Forecast, dense MLL and rollout")
    api_launches, api = run_reference_api(torch, vt, native)
    paths["volt_covariance"] = ("Volt reference API", api_launches)
    for name in ("ewma_filter", "kalman_forward", "kalman_backward",
                 "volt_covariance"):
        sym = next(k["symbol"] for k in kernels if k["name"] == name)
        if api_launches.get(sym, 0) < 1:
            fail(f"kernel {name} was not launched by the reference API")
    for sym in ("volt_kalman_forward", "volt_kalman_backward"):
        if api["train_launches"].get(sym, 0) < 1:
            fail(f"{sym} was not launched by Volt().Train()")
    done(t0)

    t0 = phase("fixed_cov: the fixed-covariance MLL of the main path's 64 "
               "states against the Kalman MLL, n=999")
    fc_launches, fixed_cov = run_fixed_cov(torch, vt, native)
    done(t0)

    t0 = phase("GPCV with the GH-75 term: B=64, n=999, Adam and NGVI")
    gh_launches, gh = run_gpcv_gh(torch, vt, native)
    paths["gh_ell_forward"] = ("learn_gpcv(ell_method='quadrature')",
                               gh_launches)
    paths["gh_ell_backward"] = paths["gh_ell_forward"]
    done(t0)

    t0 = phase("gpcv_full: fit_forecast_batch(gpcv_q='full'), B=64, n=999")
    _, gpcv_full = run_gpcv_full(torch, vt, native)
    done(t0)

    t0 = phase("gpcv_cv: learn_gpcv(param='cv'), B=64, n=999, NGVI and Adam")
    _, gpcv_cv = run_gpcv_cv(torch, vt, native)
    done(t0)

    t0 = phase("gpcv_sparse: learn_gpcv_sparse, n=16000, 256 inducing")
    _, gpcv_sparse = run_gpcv_sparse(torch, vt, native)
    done(t0)

    t0 = phase("option_pricing: price_options_batch, B=500, 10k x 100 paths")
    pricing_launches, pricing = run_option_pricing(torch, vt, native)
    done(t0)

    t0 = phase("fbm_path: fit_forecast_batch(kernel='fbm'), B=64, n=999")
    fbm_launches, fbm = run_fbm_path(torch, vt, native)
    done(t0)

    t0 = phase("multitask: fit_forecast_multitask, T=505, n=999, cold and "
               "warm")
    mt_launches, multitask = run_multitask(torch, vt, native)
    paths["mt_gpcv_tridiag_elbo"] = ("fit_forecast_multitask", mt_launches)
    paths["mt_vol_woodbury_mll"] = ("fit_forecast_multitask", mt_launches)
    done(t0)

    t0 = phase("long_main_path: fit_forecast_batch, B=16, n=16000")
    long_launches, long_main = run_long_main_path(torch, vt, native)
    done(t0)

    t0 = phase("baselines: the baseline GPs, the LSTM and the experiment "
               "drivers at the published backtest settings")
    base_launches, baselines = run_baselines(torch, vt, native)
    done(t0)

    t0 = phase("mesh: the sharded main path (worlds of 1 and 2), "
               "checkpoints, a profiler trace, entry() and two examples")
    mesh_launches, mesh = run_mesh(torch, vt, native)
    done(t0)

    t0 = phase("evaluation: the forecast-quality tools at the evaluation's "
               "widths, held to the JAX package's metrics")
    eval_launches, evaluation = run_evaluation(torch, vt, native)
    done(t0)

    t0 = phase("small input: card against CPU")
    check_small_agreement(torch, vt)
    done(t0)

    t0 = phase("timing: the timing tools at their published widths, depth "
               "cut")
    timing_launches, timing = run_timing(torch, vt, native)
    done(t0)

    for k in kernels:
        path, counts = paths[k["name"]]
        k["path"] = path
        sym = k.pop("symbol")
        k["launches"] = counts.get(sym, 0)
        k["launches_by_path"] = {
            "fit_forecast_batch": launches.get(sym, 0),
            "Volt().Train()": api["train_launches"].get(sym, 0),
            "fixed_cov": fc_launches.get(sym, 0),
            "price_options_batch": pricing_launches.get(sym, 0),
            "fbm_path": fbm_launches.get(sym, 0),
            "multitask": mt_launches.get(sym, 0),
            "long_main_path": long_launches.get(sym, 0),
            "baselines": base_launches.get(sym, 0),
            "mesh": mesh_launches.get(sym, 0),
            "evaluation": eval_launches.get(sym, 0),
            "timing": timing_launches.get(sym, 0)}
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched by its path ({path})")

    print(json.dumps({"card": card, "main_path": main_path,
                      "reference_api": api, "fixed_cov": fixed_cov,
                      "gpcv_gh": gh,
                      "gpcv_full": gpcv_full, "gpcv_cv": gpcv_cv,
                      "gpcv_sparse": gpcv_sparse,
                      "option_pricing": pricing, "fbm_path": fbm,
                      "multitask": multitask, "long_main_path": long_main,
                      "baselines": baselines, "mesh": mesh,
                      "evaluation": evaluation, "timing": timing}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# Phases that ``--phase`` runs alone, in any tree of the port: each takes
# (torch, vt, native) and returns what it measured.
PHASES = {
    "kalman_times": lambda torch, vt, native: time_kalman(torch, vt),
    "kernel_times": lambda torch, vt, native: {"ewma": time_ewma(torch),
                                               "gh_ell": time_gh_ell(torch)},
    "gpcv_elbo_times": lambda torch, vt, native: time_gpcv_elbo(torch),
    "bm_vol_mll_times": lambda torch, vt, native: time_bm_vol_mll(torch),
    "mt_gpcv_elbo_times": lambda torch, vt, native: time_mt_gpcv_elbo(torch),
    "mt_vol_mll_times": lambda torch, vt, native: time_mt_vol_mll(torch),
    "main_path": lambda torch, vt, native: run_main_path(torch, vt,
                                                         native)[1],
    "fixed_cov": lambda torch, vt, native: run_fixed_cov(torch, vt,
                                                         native)[1],
    "gpcv_full": lambda torch, vt, native: run_gpcv_full(torch, vt,
                                                         native)[1],
    "gpcv_cv": lambda torch, vt, native: run_gpcv_cv(torch, vt, native)[1],
    "gpcv_sparse": lambda torch, vt, native: run_gpcv_sparse(torch, vt,
                                                             native)[1],
    "option_pricing": lambda torch, vt, native: run_option_pricing(
        torch, vt, native)[1],
    "fbm_path": lambda torch, vt, native: run_fbm_path(torch, vt, native)[1],
    "multitask": lambda torch, vt, native: run_multitask(torch, vt,
                                                         native)[1],
    "long_main_path": lambda torch, vt, native: run_long_main_path(
        torch, vt, native)[1],
    "baselines": lambda torch, vt, native: run_baselines(torch, vt,
                                                         native)[1],
    "mesh": lambda torch, vt, native: run_mesh(torch, vt, native)[1],
    "evaluation": lambda torch, vt, native: run_evaluation(torch, vt,
                                                           native)[1],
    "timing": lambda torch, vt, native: run_timing(torch, vt, native)[1],
}
PHASES_TAG = "chip_smoke phases: "


def run_phases(names, package_root):
    torch, vt, native, card = setup(package_root)
    results = []
    for name in names:
        t0 = phase(name)
        results.append({"phase": name,
                        "result": PHASES[name](torch, vt, native)})
        done(t0)
    print(PHASES_TAG + json.dumps({"package": str(Path(vt.__file__).parent),
                                   "card": card, "phases": results}),
          flush=True)


def run_ab(parent, names, out):
    """The phases in fresh processes: parent, this tree, this tree, parent."""
    here = Path(__file__).resolve()
    results = []
    for label, tree in (("parent", parent), ("change", here.parent),
                        ("change", here.parent), ("parent", parent)):
        tree = Path(tree).resolve()
        proc = subprocess.run(
            [sys.executable, str(here), "--package-root", str(tree),
             *(f"--phase={name}" for name in names)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        line = next((ln for ln in reversed(proc.stdout.splitlines())
                     if ln.startswith(PHASES_TAG)), None)
        if proc.returncode != 0 or line is None:
            fail(f"the {label} run in {tree} exited {proc.returncode}:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        results.append({"tree": label, **json.loads(line[len(PHASES_TAG):])})
        print(json.dumps(results[-1]), flush=True)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only this phase (repeatable); no checks of "
                    "the other phases, no result lines")
    ap.add_argument("--package-root", metavar="DIR",
                    help="with --phase: the tree whose volt_tpu_torch runs")
    ap.add_argument("--ab", metavar="PARENT_DIR",
                    help="with --phase: run the phases in PARENT_DIR's tree "
                    "and this one, parent, change, change, parent")
    ap.add_argument("--out", default="chiprun_out/chip_ab.json",
                    help="with --ab: where the four runs' JSON goes")
    args = ap.parse_args()
    if args.ab or args.package_root:
        if not args.phase:
            ap.error("--ab and --package-root need --phase")
    if args.ab:
        run_ab(args.ab, args.phase, args.out)
    elif args.phase:
        run_phases(args.phase, args.package_root)
    else:
        smoke()


if __name__ == "__main__":
    sys.exit(main())
