"""The fixed-covariance MLL's float32 error on the main path's 64 fitted
states, beside the JAX package's own float32 error on the same states.

The fixed-covariance form takes the exact MLL through one float32
``eigh`` of the Volt covariance (``(64, 999, 999)``), whose smallest
eigenvalues carry errors of about eps x lambda_max, near the fitted noise
(which sits at its 1e-4 floor); the Kalman form (kernel S1) has no such
step.  This script measures how far each float32 form lies from a float64
reference, per lane:

``dump OUT.npz`` (on the card; imports no JAX) runs ``chip_smoke.py``'s
main path (``fit_forecast_batch`` on ``sabr_paths(seed=0, n_paths=64)``
with the ``PipelineConfig`` defaults) and writes its fitted states (the
return grid, log prices, EWMA train mean, vol paths, raw noise) with the
port's values and gradients in the raw noise on the card: the
fixed-covariance form in float32 (``VoltGP.make_cov_cache`` /
``mll_fixed_cov``), the same with the ``eigh`` in float64, and the Kalman
MLL (S1).

``routes`` (on the card; imports no JAX) fits the same states and takes
the float32 ``eigh`` of their covariance (K2's) by each route: cuSOLVER
(torch's default on CUDA), MAGMA (``make_fixed_cov_cache``'s on CUDA),
LAPACK on the CPU; it prints each route's seconds for the batch and the
form's largest relative distance from the same form with its ``eigh`` in
float64 on the card, values and raw-noise gradients, and S1's.

``jax IN.npz`` (on the CPU) runs the JAX package's float32
``VoltGP.make_cov_cache`` / ``mll_fixed_cov`` and its ``jax.grad`` on the
same states, and the port's float32 form on the CPU (LAPACK's ``eigh``,
as JAX's), takes a float64 reference (the port's fixed-covariance form
in float64 on the CPU, the covariance built from the same vol paths), and
prints the fitted noise and each form's largest relative distance from
the reference, per lane and overall, for values and gradients.  Run from the repository root::

    python tests/torch_fixed_cov_states.py dump chiprun_out/fc_states.npz
    python tests/torch_fixed_cov_states.py routes
    JAX_PLATFORMS=cpu python tests/torch_fixed_cov_states.py jax \\
        chiprun_out/fc_states.npz

Not collected by pytest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _port_forms(torch, volt, x, log_y, vol):
    """Values and raw-noise gradients of the port's three forms."""
    from volt_tpu_torch.gp.exact import (exact_mll_fixed_cov,
                                         make_fixed_cov_cache)

    raw = volt.likelihood.raw_noise
    out = {}
    cache = volt.make_cov_cache(x, vol)
    cache64 = make_fixed_cov_cache(volt.train_cov(x, vol).double())
    resid = (log_y - volt.train_mean(x, log_y)).detach()
    forms = {
        "fixed32": lambda: volt.mll_fixed_cov(cache, x, log_y),
        "fixed_eigh64": lambda: exact_mll_fixed_cov(
            resid.double(), torch.zeros_like(resid, dtype=torch.float64),
            cache64, volt.likelihood.noise().double()),
        "kalman32": lambda: volt.mll_kalman(x, log_y, vol),
    }
    for name, fn in forms.items():
        mll = fn()
        grad, = torch.autograd.grad(mll.sum(), raw)
        out[f"{name}_value"] = mll.detach().double().cpu().numpy()
        out[f"{name}_grad"] = grad.double().cpu().numpy().reshape(-1)
    return out


def _main_states():
    """The main path's 64 fitted states on the card: ``(chip_smoke's
    setup, volt, x, log_y, vol, cfg)``."""
    import chip_smoke

    from volt_tpu_torch.convert import load_jax_params
    from volt_tpu_torch.models import VoltGP, make_mean

    env = chip_smoke.setup()
    torch, vt, native, _ = env
    chip_smoke.run_main_path(torch, vt, native)
    x, ys, aux, cfg = chip_smoke.SHARED["main_fit"]
    log_y = torch.log(ys[..., 1:])
    volt = load_jax_params(VoltGP(mean=make_mean(cfg.mean_func, k=cfg.k),
                                  integral_rule=cfg.integral_rule),
                           aux["volt_params"], "cuda")
    return env, volt, x, log_y, aux["vol"], cfg


def dump(out_path):
    import chip_smoke

    env, volt, x, log_y, vol, cfg = _main_states()
    torch, card = env[0], env[3]
    out = _port_forms(torch, volt, x, log_y, vol)
    host = {"x": x, "log_y": log_y, "vol": vol,
            "train_mean": volt.train_mean(x, log_y),
            "raw_noise": volt.likelihood.raw_noise}
    out.update({k: v.detach().cpu().numpy() for k, v in host.items()})
    out["k"] = np.asarray(cfg.k)
    out["card"] = np.asarray(card)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path} ({card})")
    try:  # the smoke's phase on the same states, its shares printed
        chip_smoke.run_fixed_cov(*env[:3])
    except SystemExit as exc:
        print(exc)


def routes():
    from volt_tpu_torch.gp.exact import FixedCovCache, exact_mll_fixed_cov

    env, volt, x, log_y, vol, _ = _main_states()
    torch, card = env[0], env[3]
    raw = volt.likelihood.raw_noise
    cov = volt.train_cov(x, vol).detach()
    resid = (log_y - volt.train_mean(x, log_y)).detach()

    def form(evals, evecs, dtype):
        cache = FixedCovCache(evals=evals.clamp(min=0.0), evecs=evecs)
        mll = exact_mll_fixed_cov(resid.to(dtype), torch.zeros_like(
            resid, dtype=dtype), cache, volt.likelihood.noise().to(dtype))
        grad, = torch.autograd.grad(mll.sum(), raw)
        return mll.detach().double(), grad.double().reshape(-1)

    def with_library(name, fn):
        backend = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library(name)
        try:
            return fn()
        finally:
            torch.backends.cuda.preferred_linalg_library(backend)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (ev64, q64), s64 = timed(lambda: torch.linalg.eigh(cov.double()))
    ref_v, ref_g = form(ev64, q64, torch.float64)
    kalman = volt.mll_kalman(x, log_y, vol)
    g_kalman, = torch.autograd.grad(kalman.sum(), raw)
    rows = {"S1 (Kalman, float32)": (None, kalman.detach().double(),
                                      g_kalman.double().reshape(-1))}
    eighs = {
        "cusolver": lambda: with_library(
            "cusolver", lambda: torch.linalg.eigh(cov)),
        "magma": lambda: with_library(
            "magma", lambda: torch.linalg.eigh(cov)),
        "lapack (CPU)": lambda: tuple(
            t.cuda() for t in torch.linalg.eigh(cov.cpu())),
    }
    for name, fn in eighs.items():
        (evals, evecs), secs = timed(fn)
        rows[f"float32 eigh, {name}"] = (secs, *form(evals, evecs,
                                                     torch.float32))
    print(f"reference: the form with its eigh in float64 on the card "
          f"({s64:.3f} s); {card}")
    summary = {}
    for name, (secs, v, g) in rows.items():
        rv = (v - ref_v).abs() / ref_v.abs()
        rg = (g - ref_g).abs() / ref_g.abs()
        summary[name] = {"s": secs, "value_rel_max": rv.max().item(),
                         "grad_rel_max": rg.max().item(),
                         "worst_lane": int(rg.argmax())}
        print(f"{name}: value rel max {rv.max().item():.3e}, gradient rel "
              f"max {rg.max().item():.3e}"
              + ("" if secs is None else f", eigh {secs:.3f} s"))
    print(json.dumps(summary))


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def jax_side(in_path):
    import jax
    import jax.numpy as jnp
    import torch

    from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make
    from volt_tpu_torch.convert import load_jax_params
    from volt_tpu_torch.models import VoltGP, make_mean

    d = dict(np.load(in_path))
    k = int(d["k"])
    x32, log_y, vol, raw = (d["x"], d["log_y"], d["vol"], d["raw_noise"])

    # the JAX package's float32 form, one lane at a time
    jv = JVolt(mean=j_make("ewma", k=k))

    def lane(r, y, v):
        p = {"mean": {}, "likelihood": {"raw_noise": r}}
        return jv.mll_fixed_cov(p, jv.make_cov_cache(jnp.asarray(x32), v),
                                jnp.asarray(x32), y)

    jval, jgrad = [], []
    vg = jax.jit(jax.value_and_grad(lane))
    for i in range(len(log_y)):
        v, g = vg(jnp.asarray(raw[i]), jnp.asarray(log_y[i]),
                  jnp.asarray(vol[i]))
        jval.append(float(v))
        jgrad.append(float(np.asarray(g)[0]))
    jval, jgrad = np.asarray(jval), np.asarray(jgrad)

    # the float64 reference: the port's fixed-covariance form in float64
    volt = load_jax_params(VoltGP(mean=make_mean("ewma", k=k)),
                           {"likelihood": {"raw_noise": raw}})
    volt = volt.double()
    t64 = {name: torch.tensor(d[name], dtype=torch.float64)
           for name in ("x", "log_y", "vol")}
    ref = _port_forms(torch, volt, t64["x"], t64["log_y"], t64["vol"])
    ref_v, ref_g = ref["fixed_eigh64_value"], ref["fixed_eigh64_grad"]

    # the port's float32 form on the CPU (LAPACK's eigh, as JAX's)
    volt32 = load_jax_params(VoltGP(mean=make_mean("ewma", k=k)),
                             {"likelihood": {"raw_noise": raw}})
    cpu = _port_forms(torch, volt32, *(torch.tensor(d[name]) for name in
                                       ("x", "log_y", "vol")))
    noise = volt32.likelihood.noise().detach().reshape(-1)
    print(f"fitted noise: {noise.min().item():.4e} to "
          f"{noise.max().item():.4e}")

    rows = {"jax_fixed32 (CPU)": (jval, jgrad),
            "port fixed32 (CPU)": (cpu["fixed32_value"], cpu["fixed32_grad"]),
            "port fixed32 (card)": (d["fixed32_value"], d["fixed32_grad"]),
            "port fixed, eigh in float64 (card)": (
                d["fixed_eigh64_value"], d["fixed_eigh64_grad"]),
            "port Kalman S1 (card)": (d["kalman32_value"],
                                      d["kalman32_grad"])}
    summary = {}
    print(f"float64 reference: the fixed-covariance form in float64 on the "
          f"CPU; states from {d['card']}")
    for name, (v, g) in rows.items():
        rv, rg = _rel(v, ref_v), _rel(g, ref_g)
        summary[name] = {"value_rel_max": float(rv.max()),
                         "grad_rel_max": float(rg.max()),
                         "grad_rel_median": float(np.median(rg))}
        print(f"{name}: value rel max {rv.max():.3e}, gradient rel max "
              f"{rg.max():.3e} (median {np.median(rg):.3e})")
        print("   gradient rel per lane: "
              + " ".join(f"{e:.1e}" for e in rg))
    print(json.dumps(summary))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("dump", "routes", "jax"))
    ap.add_argument("path", nargs="?")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if a.mode == "routes":
        routes()
    elif a.path is None:
        ap.error(f"{a.mode} needs a path")
    elif a.mode == "dump":
        dump(a.path)
    else:
        jax_side(a.path)


if __name__ == "__main__":
    main()
