"""Monte-Carlo forecasting (port of the slice's part of
:mod:`volt_tpu.rollouts`).

The volatility kernel's min-index structure makes the autoregressive
conditional Markov: given the sampled history, the next log price is
``m(t) + (y_prev - m_prev)`` plus noise whose variance is one increment
of the running vol integral.  So the rollout is one loop over the horizon,
vectorised over assets and paths, with the EWMA mean advanced in O(1) per
step.
"""

from __future__ import annotations

import torch

from .models.volt import VoltState

__all__ = ["sample_vol_paths", "_rollout_volt_scan"]


def sample_vol_paths(vol_state, test_x, nsample: int, generator=None,
                     noise=None):
    """``exp`` of ``nsample`` joint forecasts of the log-vol GP at
    strictly-future ``test_x`` (the BM kernel's filtered-state closed form;
    other grids come back NaN).  ``(..., nsample, H)``."""
    return torch.exp(vol_state.sample_forecast(test_x, nsample, generator,
                                               noise))


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
