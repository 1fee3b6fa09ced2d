#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``volt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root::

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 off for matmuls and cuDNN (the plain EWMA is a cuDNN
   convolution, which TF32 would round to about three digits);
2. build: compile the hand-written kernels from ``volt_tpu_torch/csrc``;
3. kernels against their plain PyTorch versions on the card, float32, at
   the main path's shapes: K1 (EWMA filter, max abs error <= 1e-5 max|y|)
   and S1 (Kalman MLL forward and adjoint: value and final state rtol
   1e-5; gradients rtol 1e-4, atol 1e-6 of the largest gradient, since
   d/dv differences neighbouring d/d(delta)), timed with CUDA events
   over back-to-back calls (the plain Kalman loop: one call per run);
4. the main path at full width: ``fit_forecast_batch`` on 64 SABR series
   of 999 returns with the ``PipelineConfig`` defaults (300/300/300 Adam
   steps, EWMA k=300, 1000 paths x 100 steps, quantile fan), then once
   with ``output="samples"``.  Checks: finite outputs of the right shape,
   every ``ok``, a fan non-decreasing across levels, the recovered vol
   within an order of magnitude of the true SABR vol, and every kernel
   launched during the run (launch counts reset just before it);
5. agreement on a small input: the card's run equals the CPU run (the
   plain versions, which the repository's tests hold against the JAX
   package) within the pipeline parity tolerances.

The second-to-last line is a JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time


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
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times[1:])


def check_ewma(torch):
    """K1 against the plain conv1d on the card."""
    from volt_tpu_torch.ops.ewma import _ewma_conv, ewma

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape, k in [((64, 999), 20), ((64, 999), 100), ((64, 999), 300),
                     ((1, 5), 300), ((2, 3, 37), 20)]:
        # log-price-like rows: a random walk around log(100)
        y = 4.6 + 0.01 * torch.cumsum(
            torch.randn(*shape, device="cuda", generator=g), dim=-1)
        got = ewma(y, k)
        want = _ewma_conv(y, k)
        err = (got - want).abs().max().item()
        tol = 1e-5 * y.abs().max().item()
        print(f"   K1 {shape} k={k}: max abs err {err:.3e} (tol {tol:.3e})")
        if got.shape != want.shape or not err <= tol:
            fail(f"K1 disagrees with its plain version at {shape}, k={k}")
        worst = max(worst, err)
    y = 4.6 + 0.01 * torch.cumsum(
        torch.randn(64, 999, device="cuda", generator=g), dim=-1)
    ms = cuda_ms(torch, lambda: ewma(y, 300))
    plain_ms = cuda_ms(torch, lambda: _ewma_conv(y, 300))
    print(f"   K1 (64, 999) k=300: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "ewma_filter", "route": "cuda",
            "source": "volt_tpu_torch/csrc/ewma_filter.cu",
            "replaces": "volt_tpu/ops/pallas/ewma_filter.py:63",
            "symbol": "volt_ewma_filter", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms}


def check_kalman(torch, vt):
    """S1 forward and adjoint against the plain loop on the card, on the
    main path's stage-3 inputs: the SABR vol integral and the residual
    of log prices from their EWMA mean."""
    from volt_tpu_torch.ops import tridiag as ttd
    from volt_tpu_torch.ops.ewma import ewma
    from volt_tpu_torch.ops.volint import vol_integral

    b, n = 64, 999
    f, v_true = vt.data.sabr_paths(steps=n + 1, seed=0, n_paths=b)
    x = torch.arange(n, dtype=torch.float32, device="cuda") / 252.0
    vol = torch.tensor(v_true[:, 1:], device="cuda")
    log_y = torch.log(torch.tensor(f[:, 1:], device="cuda"))
    v = vol_integral(x, vol)
    resid = log_y - ewma(log_y, 300)[..., :-1]
    g = torch.Generator(device="cuda").manual_seed(1)
    s2 = 10.0 ** (-4.0 + 4.0 * torch.rand(b, device="cuda", generator=g))

    def run(plain):
        ins = [t.clone().requires_grad_() for t in (v, s2, resid)]
        if plain:
            delta = torch.diff(ins[0], dim=-1,
                               prepend=torch.zeros_like(ins[0][..., :1]))
            out = ttd._kalman_plain(delta, ins[1], ins[2])
        else:
            out = ttd._kalman(*ins)
        out[0].sum().backward()
        return [o.detach() for o in out], [t.grad for t in ins]

    (ll, mean, var), grads = run(plain=False)
    (ll_p, mean_p, var_p), grads_p = run(plain=True)
    fwd_err = 0.0
    for name, a, p in [("ll/n", ll, ll_p), ("mean", mean, mean_p),
                       ("var", var, var_p)]:
        err = (a - p).abs().max().item()
        ok = torch.allclose(a, p, rtol=1e-5, atol=0.0)
        print(f"   S1 forward {name}: max abs err {err:.3e}")
        if not ok:
            fail(f"S1 forward {name} disagrees with its plain version")
        fwd_err = max(fwd_err, err)
    bwd_err = 0.0
    for name, a, p in zip(("v", "sigma2", "resid"), grads, grads_p):
        err = (a - p).abs().max().item()
        atol = 1e-6 * max(1.0, p.abs().max().item())
        ok = torch.allclose(a, p, rtol=1e-4, atol=atol)
        print(f"   S1 d/d{name}: max abs err {err:.3e} (atol {atol:.1e})")
        if not ok:
            fail(f"S1 gradient w.r.t. {name} disagrees with its plain version")
        bwd_err = max(bwd_err, err)

    # times of the kernels alone, and of the plain loop forward / backward
    delta = torch.diff(v, dim=-1, prepend=torch.zeros_like(v[..., :1]))
    delta, s2c, resid = delta.contiguous(), s2.contiguous(), resid.contiguous()
    saved = ttd.kalman_forward_cuda(delta, s2c, resid, save=True)
    ones, zeros = torch.ones_like(s2c), torch.zeros_like(s2c)
    fwd_ms = cuda_ms(torch, lambda: ttd.kalman_forward_cuda(
        delta, s2c, resid, save=True))
    bwd_ms = cuda_ms(torch, lambda: ttd.kalman_backward_cuda(
        delta, s2c, resid, saved[3], saved[4], ones, zeros, zeros))
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(
            torch, lambda: ttd._kalman_plain(delta, s2c, resid), calls=1)
    ins = [t.clone().requires_grad_() for t in (delta, s2c, resid)]
    ll_graph = ttd._kalman_plain(*ins)[0].sum()
    plain_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ll_graph, ins, retain_graph=True), calls=1)
    print(f"   S1 (64, 999): forward kernel {fwd_ms:.4f} ms, plain "
          f"{plain_fwd_ms:.2f} ms; backward kernel {bwd_ms:.4f} ms, plain "
          f"{plain_bwd_ms:.2f} ms")
    common = {"route": "cuda", "source": "volt_tpu_torch/csrc/kalman.cu",
              "replaces": "volt_tpu/ops/tridiag.py:166"}
    return [
        {"name": "kalman_forward", **common, "symbol": "volt_kalman_forward",
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms},
        {"name": "kalman_backward", **common,
         "symbol": "volt_kalman_backward", "max_abs_err": bwd_err,
         "ms": bwd_ms, "plain_ms": plain_bwd_ms},
    ]


def grids(torch, n, h, device):
    dt = 1.0 / 252
    x = torch.arange(n, dtype=torch.float32, device=device) * dt
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
    vol = aux["vol"].cpu().numpy()
    ratio = float(statistics.median(
        (vol[i].mean() / v_true[i, 1:].mean()) for i in range(b)))
    print(f"   recovered vol / true SABR vol, median over assets: {ratio:.3f}")
    if not 0.3 < ratio < 3.5:
        fail("recovered vol path off by more than an order of magnitude")

    cfg_s = PipelineConfig(output="samples")
    t1 = time.perf_counter()
    paths, aux_s = fit_forecast_batch(g, x, ys, test_x, cfg_s)
    torch.cuda.synchronize()
    print(f"   samples call: {time.perf_counter() - t1:.3f} s")
    if tuple(paths.shape) != (b, cfg_s.nsample, h) or \
            not torch.isfinite(paths).all() or not bool(aux_s["ok"].all()):
        fail("samples call: bad shape, non-finite paths or a failed asset")
    return launches, total, stages


def check_small_agreement(torch, vt):
    """Card against CPU on the parity tests' small input and noise."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

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


def main():
    t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
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
    card = smi.stdout.strip()
    print(card)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    done(t0)

    t0 = phase("build")
    native.library()
    print(native.build_log().strip())
    done(t0)

    t0 = phase("kernels against their plain versions")
    kernels = [check_ewma(torch), *check_kalman(torch, vt)]
    done(t0)

    t0 = phase("main path: fit_forecast_batch, B=64, n=999, defaults")
    launches, total, stages = run_main_path(torch, vt, native)
    for k in kernels:
        k["launches"] = launches.get(k.pop("symbol"), 0)
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched by the main path")
    done(t0)

    t0 = phase("small input: card against CPU")
    check_small_agreement(torch, vt)
    done(t0)

    print(json.dumps({"card": card, "main_path_s": total,
                      "stage_s": stages}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
