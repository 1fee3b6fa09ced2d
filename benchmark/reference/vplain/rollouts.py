"""Monte-Carlo forecasting (port of :mod:`volt_tpu.rollouts`).

The volatility kernel's min-index structure makes the autoregressive
conditional Markov: given the sampled history, the next log price is
``m(t) + (y_prev - m_prev)`` plus noise whose variance is one increment
of the running vol integral.  So the rollout is one loop over the horizon,
vectorised over assets and paths, with the Magpie means advanced in O(1)
per step.  The one-shot predictions sample the same Markov conditional
over the whole horizon.  The ``*_dense`` twins restate the reference's
dense algebra (the joint covariance through kernel K2 on CUDA, a Cholesky
and a solve per step); they are the oracle the Markov forms are held to.
The baselines' stationary kernels have no Markov structure: their
rollout (:func:`nonvol_rollouts`) grows the Cholesky factor of the joint
kernel matrix by one row a step, held to the dense re-factorising loop
:func:`nonvol_rollouts_dense`.

``generator`` takes the place of the JAX ``key``; each function also takes
the standard normals it would draw (``noise`` / ``zs``), so a run can be
given exactly the JAX package's draws.
"""

from __future__ import annotations

import torch
from .kernels import BMKernel
from .models.volt import VoltState


def sample_vol_paths(vol_state, test_x, nsample: int, generator=None,
                     noise=None, assume_future: bool | None = None):
    """``exp`` of ``nsample`` joint forecasts of the log-vol GP at
    ``test_x``: ``(..., nsample, H)``.

    On a strictly-future grid (checked on the host unless
    ``assume_future`` is given) the BM kernel's filtered-state closed form
    (``noise``: ``(r0 (..., S), z (..., S, H))``); otherwise, or with
    ``assume_future=False``, the dense posterior sampler (``noise``: its
    standard normals ``(S, ..., H)``).  With ``assume_future=True`` a
    violating grid comes back NaN."""
    fast = (isinstance(vol_state.module.kernel, BMKernel)
            and assume_future is not False
            and (assume_future is True
                 or _strictly_future(test_x, vol_state.train_x)))
    if fast:
        return torch.exp(vol_state.sample_forecast(test_x, nsample, generator,
                                                   noise))
    log_paths = vol_state.sample(test_x, (nsample,), generator, noise)
    return torch.exp(log_paths.movedim(0, -2))


def _rollout_volt_scan(model: VoltState, latent_mean, test_x, pred_vol, zs,
                       use_theta: bool, theta: float):
    """The Markov rollout core: log-price paths ``(..., S, H)`` from the
    vol paths ``pred_vol`` and standard normals ``zs`` ``(..., S, H)``.
    With ``use_theta``, each step's mean reverts by ``theta`` toward
    ``latent_mean`` ``(...)``."""
    mean_mod = model.module.mean
    y = model.train_y  # (..., n) log prices on the model grid
    dx = model.train_x[..., 1] - model.train_x[..., 0]
    h = test_x.shape[-1]
    nsample = pred_vol.shape[-2]

    # (..., S, H) conditional std devs: one increment of the running vol
    # integral under the kernel's quadrature rule
    if model.module.kernel.integral_rule == "trapezoid":
        pv2 = pred_vol * pred_vol
        v_last2 = torch.exp(2.0 * model.log_vol_path[..., -1])
        prev2 = torch.cat([v_last2[..., None, None].expand(*pv2.shape[:-1], 1),
                           pv2[..., :-1]], dim=-1)
        sds = torch.sqrt(0.5 * dx * (pv2 + prev2))
    else:
        # reference CumTrapz: each appended point is the halved endpoint
        sds = torch.sqrt(0.5 * dx) * pred_vol

    def per_path(v):  # (..., *rest) -> (..., S, *rest)
        batch = v.shape[:y.dim() - 1]
        rest = v.shape[y.dim() - 1:]
        return v.reshape(*batch, 1, *rest).expand(*batch, nsample, *rest)

    hist = mean_mod.is_history_dependent
    fast = hist and mean_mod.scan_fast_supported(h)
    if fast:
        state, xs = mean_mod.scan_fast_init(y, h)
    elif hist:
        state, xs = mean_mod.scan_init(y), {}
    if hist:
        state = {key: per_path(v) for key, v in state.items()}
        m_prev = per_path(mean_mod.train_values(y)[..., -1])
    else:
        m_prev = per_path(mean_mod(model.train_x)[..., -1])
        m_det = mean_mod(test_x)

    y_prev = per_path(y[..., -1])
    out = []
    for t in range(h):
        if fast:
            m_t = mean_mod.scan_fast_value(state)
        elif hist:
            m_t = mean_mod.scan_value(state)
        else:
            m_t = m_det[..., t, None].expand_as(y_prev)
        pred_mean = m_t + (y_prev - m_prev)
        if use_theta:
            pred_mean = pred_mean - theta * (pred_mean - latent_mean[..., None])
        y_t = pred_mean + sds[..., t] * zs[..., t]
        if fast:
            x_t = {key: v[..., t, None] for key, v in xs.items()}
            state = mean_mod.scan_fast_append(state, x_t, y_t)
        elif hist:
            state = mean_mod.scan_append(state, y_t)
        out.append(y_t)
        y_prev, m_prev = y_t, m_t
    return torch.stack(out, dim=-1)
