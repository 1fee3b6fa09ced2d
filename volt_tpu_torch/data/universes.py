"""Known-dynamics synthetic evaluation universes (a numpy copy of
:mod:`volt_tpu.data.universes`: the same generators, the same values for
a seed).

All generators return ``(w, ntrain + h)`` float32 *prices/levels*: the
first ``ntrain`` points train, the last ``h`` are the realized truth.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DT", "corrvol_windows", "gbm_windows", "gusty_wind_windows",
           "sabr_windows", "wind_windows"]

DT = 1.0 / 252


def gbm_windows(rng, w, ntrain, h, vol=0.25, s0=50.0):
    """Constant-vol zero-drift GBM — well-specified for the model."""
    z = rng.standard_normal((w, ntrain + h - 1))
    logp = np.concatenate(
        [np.zeros((w, 1)), np.cumsum(vol * np.sqrt(DT) * z, axis=1)], axis=1
    )
    return (s0 * np.exp(logp)).astype(np.float32)


def sabr_windows(w, ntrain, h, seed=11, return_vol=False):
    """Stochastic-vol SABR paths (the tutorial's harder generator).

    ``return_vol=True`` additionally returns the true latent vol paths
    — hidden state the models must infer; used by oracle constructions
    (e.g. ``tools/eval_options.py`` continues the true SDE from each
    window's final ``(F, V)``)."""
    from .synthetic import sabr_paths

    f, v = sabr_paths(steps=ntrain + h, seed=seed, n_paths=w)
    f = np.asarray(f, np.float32).reshape(w, ntrain + h)
    if return_vol:
        return f, np.asarray(v, np.float32).reshape(w, ntrain + h)
    return f


def wind_windows(rng, w, ntrain, h, rho=0.02, sig=0.25):
    """Squared-OU wind-speed surrogate: mean-reverting, heteroscedastic,
    strictly positive after the reference's ``+1`` shift
    (``GPGenerator.py:49,56``: ``-99 -> 0`` then ``data + 1``)."""
    n = ntrain + h
    x = np.empty((w, n))
    x[:, 0] = 0.5 * rng.standard_normal(w)
    z = rng.standard_normal((w, n))
    for t in range(1, n):
        x[:, t] = (1.0 - rho) * x[:, t - 1] + sig * z[:, t]
    return (1.0 + 2.0 * x * x).astype(np.float32)


def corrvol_windows(rng, w, tasks, ntrain, h, base_vol=0.25, rho_v=0.01,
                    xi=0.10, idio=0.35, s0=50.0):
    """Multi-asset stochastic-vol GBM with a *shared* log-vol gust factor.

    Station ``i`` in window ``b`` follows a zero-drift log-price walk
    whose innovation scale is ``base_vol * exp(v_t + u_{i,t})``: ``v_t``
    is one slow log-OU factor common to every station in the window
    (persistence ``~1/rho_v = 100`` steps, stationary std ``~0.7`` at
    the defaults — calm/gusty market-wide episodes spanning a ~4x scale
    range) and ``u_{i,t}`` an idiosyncratic log-OU scaled by ``idio``.
    Price innovations themselves stay independent across stations, so
    the *only* cross-station structure is in volatility — exactly the
    coupling the reference's Kronecker multitask vol GP
    (``BMGP.py:30-56``, the mtwind experiment) is built to capture, and
    the cleanest universe for measuring what that coupling buys over
    independent per-station fits.

    Returns ``(w, tasks, ntrain + h)`` float32 prices.
    """
    n = ntrain + h
    z = rng.standard_normal((w, tasks, n - 1))
    zv = rng.standard_normal((w, n - 1))
    zu = rng.standard_normal((w, tasks, n - 1))
    logp = np.zeros((w, tasks, n))
    v = np.zeros(w)
    u = np.zeros((w, tasks))
    for t in range(1, n):
        v = (1.0 - rho_v) * v + xi * zv[:, t - 1]
        u = (1.0 - rho_v) * u + idio * xi * zu[:, :, t - 1]
        scale = base_vol * np.exp(v[:, None] + u)
        logp[:, :, t] = logp[:, :, t - 1] + scale * np.sqrt(DT) * z[:, :, t - 1]
    return (s0 * np.exp(logp)).astype(np.float32)


def gusty_wind_windows(rng, w, ntrain, h, rho=0.02, sig=0.25,
                       rho_v=0.01, xi=0.085):
    """Squared-OU wind surrogate with stochastic log-volatility *bursts*.

    Same mean-reverting speed process as :func:`wind_windows`, but the
    innovation scale is itself a slow log-OU process
    (``sig_t = sig * exp(v_t)``, stationary ``std(v) ~ 0.6`` at the
    defaults, i.e. calm/gusty episodes spanning a ~3x scale range with
    ~``1/rho_v = 100``-step persistence).  Real subhourly surface wind is
    intermittent in exactly this sense (gust fronts / convective
    episodes), which is the regime the Volt paper targets — the plain
    squared-OU surrogate is the *stationary* end of the bracket, this is
    the *heteroscedastic* end; neither is USCRN data, together they
    bracket it.
    """
    n = ntrain + h
    x = np.empty((w, n))
    x[:, 0] = 0.5 * rng.standard_normal(w)
    z = rng.standard_normal((w, n))
    zv = rng.standard_normal((w, n))
    v = np.zeros(w)
    for t in range(1, n):
        v = (1.0 - rho_v) * v + xi * zv[:, t]
        x[:, t] = (1.0 - rho) * x[:, t - 1] + sig * np.exp(v) * z[:, t]
    return (1.0 + 2.0 * x * x).astype(np.float32)
