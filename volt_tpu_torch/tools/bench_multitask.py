"""Multitask scaling per ``(T, n)`` (port of the JAX package's
``tools/bench_multitask.py``): the stages of the Kronecker chain timed at
each task count.

* ``mt_vol_fit``: the Kronecker multitask vol-GP fit (the spectral MLL
  with the low-rank task blocks, as ``train_volt_multitask`` fits it),
  ms per Adam step;
* ``mt_gpcv_fit``: the multitask GPCV ELBO fit, per variational family,
  ms per Adam step;
* ``mt_vol_forecast``: the correlated forecast sampling
  (``sample_forecast``, Matheron's rule), ms a call.

Each time is the least of ``--repeats`` calls after a first call, whose
time is printed beside it (``first_call_ms``); a fit's call runs its
``--iters`` Adam steps from the same initial values.  Prints one JSON
line per ``(T, stage)``.

Run::

    python -m volt_tpu_torch.tools.bench_multitask [--tasks 64 128 256 505]
        [--n 1000] [--iters 50] [--nsample 50] [--horizon 100]
        [--repeats 3] [--stages vol,gpcv,rollout] [--gpcv-q full]
        [--device cuda]
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

from ..convert import load_jax_params
from ..likelihoods import VolatilityGaussianLikelihood
from ..models.multitask import MultitaskBMGP, MultitaskVariationalGP
from ..train import adam_loop
from ..utils.profiling import timed_cold_best
from ._common import DT, check_finite, f32, parser, seeded

__all__ = ["inputs", "vol_model", "fit_vol", "gpcv_model", "fit_gpcv",
           "main"]


def inputs(rng, n: int, t: int):
    """The log vols and the scaled returns ``(n, t)`` float32 of task
    count ``t``, drawn from ``rng`` in that order."""
    log_vols_nt = (np.log(0.2) + 0.1 * rng.standard_normal((n, t))).astype(
        np.float32)
    yy = (0.2 * rng.standard_normal((n, t))).astype(np.float32)
    return log_vols_nt, yy


def vol_model(t: int, device, init_params=None) -> MultitaskBMGP:
    """The multitask vol GP of ``t`` tasks, rank 1, at its initial values
    (``init_params``, a JAX tree, replaces the random ones)."""
    mt = MultitaskBMGP(num_tasks=t, rank=1)
    if init_params is None:
        return mt.init(torch.float32, device)
    return load_jax_params(mt, init_params, device)


def fit_vol(mt, train_x, log_vols_nt, iters: int):
    """Adam (lr 0.01) on the spectral MLL from a copy of ``mt``: the
    per-step losses ``(iters,)``."""
    mt = copy.deepcopy(mt)
    n, t = log_vols_nt.shape
    cache = mt.spectral_cache(train_x, log_vols_nt)
    return adam_loop(mt, lambda: -mt.mll_spectral(cache, n, t), iters, 0.01)


def gpcv_model(train_x, yy, q: str, init_params=None):
    """The multitask variational GP of family ``q`` (rank 1) after its
    random init and the Laplace init of its variational parameters, and
    the exp likelihood (``init_params``, a JAX tree of the model,
    replaces both inits)."""
    lik = VolatilityGaussianLikelihood(param="exp")
    mvg = MultitaskVariationalGP(num_tasks=yy.shape[-1], rank=1, q=q)
    if init_params is not None:
        return load_jax_params(mvg, init_params, yy.device), lik
    mvg.init(train_x, yy.dtype)
    mvg.initialize_variational_parameters(lik, train_x, yy)
    return mvg, lik


def fit_gpcv(mvg, lik, train_x, yy, iters: int):
    """Adam (lr 0.01) on the negative ELBO from a copy of ``mvg``: the
    per-step losses ``(iters,)``."""
    mvg = copy.deepcopy(mvg)
    return adam_loop(mvg, lambda: -mvg.elbo(train_x, yy, lik), iters, 0.01)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--tasks", type=int, nargs="+",
                   default=[64, 128, 256, 505])
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--nsample", type=int, default=50)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--stages", type=str, default="vol,gpcv,rollout")
    p.add_argument("--gpcv-q", type=str, default="full",
                   help="comma list of variational families for the gpcv "
                        "stage: full,tridiag")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    stages = set(a.stages.split(","))

    n = a.n - 1
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * DT
    test_x = train_x[-1] + DT * torch.arange(1, a.horizon + 1,
                                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    records = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        records.append(rec)

    for t in a.tasks:
        log_vols, yy = (f32(v, dev) for v in inputs(rng, n, t))

        if "vol" in stages:
            mt = vol_model(t, dev)
            losses, el, first = timed_cold_best(
                lambda: fit_vol(mt, train_x, log_vols, a.iters)[-1],
                a.repeats)
            check_finite(losses, f"vol fit at T={t}")
            emit({"stage": "mt_vol_fit", "T": t, "n": n,
                  "ms_per_iter": round(1e3 * el / a.iters, 3),
                  "fit_sec_400iter": round(el / a.iters * 400, 2),
                  "first_call_ms": round(1e3 * first, 1)})

        if "gpcv" in stages:
            for fam in a.gpcv_q.split(","):
                mvg, lik = gpcv_model(train_x, yy, fam)
                loss, el, first = timed_cold_best(
                    lambda: fit_gpcv(mvg, lik, train_x, yy, a.iters)[-1],
                    a.repeats)
                check_finite(loss, f"gpcv at T={t}")
                emit({"stage": "mt_gpcv_fit", "T": t, "n": n, "q": fam,
                      "ms_per_iter": round(1e3 * el / a.iters, 3),
                      "first_call_ms": round(1e3 * first, 1)})

        if "rollout" in stages:
            state = vol_model(t, dev).fit_state(train_x, log_vols)
            vols, el, first = timed_cold_best(
                lambda: state.sample_forecast(test_x, a.nsample,
                                              generator=seeded(dev, 0)),
                a.repeats)
            check_finite(vols, f"forecast at T={t}")
            emit({"stage": "mt_vol_forecast", "T": t, "n": n,
                  "S": a.nsample, "H": a.horizon,
                  "ms_total": round(1e3 * el, 2),
                  "first_call_ms": round(1e3 * first, 1)})
    return records


if __name__ == "__main__":
    main()
