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
from .means import MeanRevertingEMAMean
from .models.volt import VoltState
from .ops.chol import psd_safe_cholesky, solve_lower_triangular
from .ops.mvn import conditional, sample_mvn
from .utils.profiling import annotate

__all__ = [
    "sample_vol_paths",
    "rollouts",
    "generate_prediction",
    "sample_prediction",
    "mean_prediction",
    "volt_posterior",
    "nonvol_rollouts",
    "rollouts_multitask",
    "generate_prediction_dense",
    "rollouts_dense",
    "nonvol_rollouts_dense",
    "_rollout_volt_scan",
]


def _strictly_future(test_x, train_x) -> bool:
    """Host-side check of the forecast contract: ``test_x`` increasing and
    strictly after the train grid."""
    with annotate("sync:future"):
        tx, tr = test_x.detach().cpu(), train_x.detach().cpu()
    return bool(torch.all(torch.diff(tx, dim=-1) > 0)
                and torch.all(tx[..., 0] > tr[..., -1]))


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


# ---------------------------------------------------------------------------
# Autoregressive rollout — Markov fast path
# ---------------------------------------------------------------------------


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


def _rollout(model: VoltState, train_y, test_x, pred_vol, zs, theta):
    """:func:`_rollout_volt_scan`, each step's mean reverting by ``theta``
    (unless ``None``) toward ``mean(log(train_y))``."""
    latent = (None if theta is None else
              torch.mean(torch.log(train_y.to(model.train_y.dtype)), dim=-1))
    return _rollout_volt_scan(model, latent, test_x, pred_vol, zs,
                              theta is not None, theta or 0.0)


def _draw(generator, like, *shape):
    return torch.randn(*shape, dtype=like.dtype, device=like.device,
                       generator=generator)


def rollouts(generator, model: VoltState, train_x, train_y, test_x,
             nsample: int = 50, method: str = "volt", theta=None,
             assume_future: bool | None = None, noise=None):
    """Autoregressive MC forecast (reference ``Rollouts``): log-price
    samples ``(..., nsample, H)``.

    ``train_y`` is the full price series (one longer than the model grid);
    it gives only the mean-reversion target ``mean(log(train_y))`` when
    ``theta`` is set.  ``noise`` optionally gives the standard normals
    ``{"vol_r0": (..., S), "vol_z": (..., S, H), "zs": (..., S, H)}``
    (the vol forecast's and the rollout's); otherwise they are drawn from
    ``generator``."""
    del train_x  # the model state carries its grid; kept for API parity
    if method != "volt":
        raise NotImplementedError(
            "non-volt rollouts live in volt_tpu_torch.rollouts.nonvol_rollouts")
    with torch.no_grad():
        y = model.train_y
        vol_noise = None if noise is None else (noise["vol_r0"],
                                                noise["vol_z"])
        pred_vol = sample_vol_paths(model.vol_state, test_x, nsample,
                                    generator, vol_noise, assume_future)
        zs = (_draw(generator, y, *pred_vol.shape) if noise is None
              else noise["zs"])
        return _rollout(model, train_y, test_x, pred_vol, zs, theta)


# ---------------------------------------------------------------------------
# Non-volatility autoregressive rollouts (baseline exact GPs)
# ---------------------------------------------------------------------------


def _nonvol_parts(model):
    """``(kernel, mean, noise)`` of a fitted baseline."""
    module = model.module
    return module.kernel, module.mean, module.likelihood.noise()[..., 0]


def nonvol_rollouts(generator, model, train_x, train_y, test_x,
                    nsample: int = 50, zs=None):
    """Autoregressive MC forecast of a fitted baseline
    (:class:`~volt_tpu_torch.models.basic.BasicGPState`, log prices;
    reference ``nonvol_rollouts``): log samples ``(nsample, H)``.
    ``train_x`` and ``train_y`` (the raw prices) are kept for the
    reference's call signature and not read.  ``zs`` ``(nsample, H)``
    optionally gives the per-step standard normals.

    The kernel matrix of the joint grid is built once (the
    hyperparameters are fixed), and the Cholesky factor of ``K + noise I``
    grows by one row a step: one triangular solve shared by the paths,
    O((n + t)^2), then O(S (n + t)) per path, where the reference
    re-factorises O((n + t)^3) a step.  The conditional variance
    ``k_tt - w.w`` is a cancellation: it needs true float32 products
    (TF32 off on the card)."""
    del train_x, train_y
    with torch.no_grad():
        kern, mean_mod, noise = _nonvol_parts(model)
        tx, ty = model.train_x, model.train_y
        n, h = tx.shape[-1], test_x.shape[-1]
        k_joint = kern(torch.cat([tx, test_x], -1))  # (n+H, n+H)
        a_diag = torch.diagonal(k_joint) + noise
        state = None
        if mean_mod.is_history_dependent:
            # the Magpie mean's window scan state, one per path
            state = {key: v.expand(nsample, *v.shape)
                     for key, v in mean_mod.scan_init(ty).items()}
            m_train = mean_mod.train_values(ty)
        else:
            m_train, m_det = mean_mod(tx), mean_mod(test_x)
        eye = torch.eye(n, dtype=ty.dtype, device=ty.device)
        chol = torch.zeros(n + h, n + h, dtype=ty.dtype, device=ty.device)
        chol[:n, :n] = psd_safe_cholesky(k_joint[:n, :n] + noise * eye)
        # u = L^{-1} (y - m), extended per path as the paths grow
        u = torch.zeros(nsample, n + h, dtype=ty.dtype, device=ty.device)
        u[:, :n] = solve_lower_triangular(chol[:n, :n],
                                          (ty - m_train)[:, None])[:, 0]
        if zs is None:
            zs = torch.randn(nsample, h, dtype=ty.dtype, device=ty.device,
                             generator=generator)
        out = []
        for t in range(h):
            nt = n + t
            k_col = k_joint[:nt, nt]
            w = solve_lower_triangular(chol[:nt, :nt], k_col[:, None])[:, 0]
            ww = torch.dot(w, w)
            resid = u[:, :nt] @ w  # (S,) conditional mean of the residual
            m_t = m_det[t] if state is None else mean_mod.scan_value(state)
            sd = torch.sqrt(torch.clamp(k_joint[nt, nt] - ww, min=1e-12))
            y_t = m_t + resid + sd * zs[:, t]
            # the factor's new row [w, sqrt(A_tt - w.w)], and u's new entry
            diag = torch.sqrt(torch.clamp(a_diag[nt] - ww, min=1e-12))
            chol[nt, :nt] = w
            chol[nt, nt] = diag
            u[:, nt] = (y_t - m_t - resid) / diag
            if state is not None:
                state = mean_mod.scan_append(state, y_t)
            out.append(y_t)
        return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Correlated multi-asset rollouts (multitask vol GP)
# ---------------------------------------------------------------------------


def rollouts_multitask(generator, volt_state: VoltState, mt_vol_state,
                       train_ys, test_x, nsample: int = 50, theta=None,
                       assume_future: bool | None = None, noise=None):
    """Autoregressive rollouts of ``T`` correlated assets: ``(T, nsample,
    H)`` log-price paths.  The vol forecasts are joint across assets
    through the Kronecker task covariance (on a strictly-future grid the
    Matheron sampler, else the dense posterior through the ``(H T, H T)``
    covariance); each asset's prices then follow the Markov scan.

    ``volt_state`` carries the task axis as its batch
    (:func:`~volt_tpu_torch.train.train_volt_multitask`); ``train_ys`` the
    full ``(T, n+1)`` prices, read only for the mean-reversion target when
    ``theta`` is set.  ``assume_future`` as :func:`sample_vol_paths`.
    ``noise`` optionally gives the standard normals: ``{"vol_z": (S, n+H,
    T), "vol_eps": (S, n, T)}`` for the Matheron sampler or ``{"vol": (S,
    H T)}`` for the dense one, and ``"zs": (T, S, H)``."""
    with torch.no_grad():
        y = volt_state.train_y
        num_tasks, h = y.shape[0], test_x.shape[-1]
        fast = (isinstance(mt_vol_state.module.data_kernel, BMKernel)
                and assume_future is not False
                and (assume_future is True
                     or _strictly_future(test_x, mt_vol_state.train_x)))
        if fast:
            log_vols = mt_vol_state.sample_forecast(
                test_x, nsample, generator,
                None if noise is None else (noise["vol_z"], noise["vol_eps"]))
        else:
            log_vols = mt_vol_state.sample(
                test_x, (nsample,), generator,
                None if noise is None else noise["vol"])
        pred_vol = torch.exp(log_vols.movedim(-1, 0))  # (T, S, H)
        zs = (_draw(generator, y, num_tasks, nsample, h) if noise is None
              else noise["zs"])
        return _rollout(volt_state, train_ys, test_x, pred_vol, zs, theta)


# ---------------------------------------------------------------------------
# One-shot prediction (non-autoregressive), deterministic means
# ---------------------------------------------------------------------------


def _joint_integral_increments(model: VoltState, test_x, pred_vol):
    """Per-test-point increments of the vol integral on the joint grid:
    ``dx`` everywhere except the joint grid's halved last point under the
    reference rule; ``dx (v_t^2 + v_{t-1}^2) / 2`` under the trapezoid
    rule (``v_{-1}`` the last train vol)."""
    dx = model.train_x[..., 1] - model.train_x[..., 0]
    if model.module.kernel.integral_rule == "trapezoid":
        pv2 = pred_vol * pred_vol
        v_last2 = torch.exp(2.0 * model.log_vol_path[..., -1])
        prev2 = torch.cat([v_last2[..., None].expand(*pv2.shape[:-1], 1),
                           pv2[..., :-1]], dim=-1)
        return 0.5 * dx * (pv2 + prev2)
    w = dx * torch.ones(test_x.shape[-1], dtype=pred_vol.dtype,
                        device=pred_vol.device)
    w[-1] = 0.5 * dx
    return w * pred_vol * pred_vol


def _markov_mean(model: VoltState, test_x, latent_mean, theta):
    """``m(test) + r_last``, reverted toward ``latent_mean`` if given."""
    mean_mod = model.module.mean
    if mean_mod.is_history_dependent:
        raise ValueError(
            "one-shot prediction requires a deterministic mean (the "
            "reference routes Magpie means through Rollouts; "
            "GenerateMultiMeanPreds.py:110-119)")
    r_last = model.train_y[..., -1] - mean_mod(model.train_x)[..., -1]
    pred_mean = mean_mod(test_x) + r_last[..., None]
    if latent_mean is not None:
        pred_mean = pred_mean - theta * (pred_mean - latent_mean)
    return pred_mean


def generate_prediction(generator, model: VoltState, test_x, pred_vol,
                        n_sample: int = 1, latent_mean=None,
                        theta: float = 0.5, noise=None):
    """One-shot conditional sampling over the whole horizon (reference
    ``GeneratePrediction``): ``(..., n_sample, H)`` log-price samples,
    time-changed Brownian increments around the Markov conditional mean.
    ``pred_vol``: ``(..., H)``; ``noise``: the standard normals
    ``(..., n_sample, H)``."""
    with torch.no_grad():
        pred_mean = _markov_mean(model, test_x, latent_mean, theta)
        incs = _joint_integral_increments(model, test_x, pred_vol)
        batch = torch.broadcast_shapes(pred_vol.shape[:-1],
                                       pred_mean.shape[:-1])
        if noise is None:
            noise = _draw(generator, pred_vol, *batch, n_sample,
                          test_x.shape[-1])
        return pred_mean[..., None, :] + torch.cumsum(
            torch.sqrt(incs)[..., None, :] * noise, dim=-1)


def sample_prediction(generator, model: VoltState, test_x, n_sample: int = 1,
                      return_vol: bool = False, noise=None):
    """One dense vol-path draw, then ``n_sample`` price paths (reference
    ``VoltronGP.SamplePrediction``).  ``noise``: ``{"vol": (..., H),
    "z": (..., n_sample, H)}`` standard normals."""
    with torch.no_grad():
        pred_vol = torch.exp(model.vol_state.sample(
            test_x, (), generator, None if noise is None else noise["vol"]))
    pred = generate_prediction(generator, model, test_x, pred_vol, n_sample,
                               noise=None if noise is None else noise["z"])
    return (pred, pred_vol) if return_vol else pred


def mean_prediction(generator, model: VoltState, test_x, n_sample: int = 1,
                    return_vol: bool = False, noise=None):
    """Like :func:`sample_prediction` with the posterior-mean vol path
    (reference ``VoltronGP.MeanPrediction``); ``noise``: ``(..., n_sample,
    H)``."""
    with torch.no_grad():
        pred_vol = torch.exp(model.vol_state.posterior(test_x)[0])
    pred = generate_prediction(generator, model, test_x, pred_vol, n_sample,
                               noise=noise)
    return (pred, pred_vol) if return_vol else pred


def volt_posterior(model: VoltState, test_x, pred_vol, latent_mean=None,
                   theta: float = 0.5):
    """The closed-form conditional over the horizon that
    :func:`generate_prediction` samples: ``(mean (..., H), cov (..., H,
    H))`` with ``cov[s, t]`` the integral increments summed up to
    ``min(s, t)``."""
    with torch.no_grad():
        pred_mean = _markov_mean(model, test_x, latent_mean, theta)
        cum = torch.cumsum(_joint_integral_increments(model, test_x, pred_vol),
                           dim=-1)
        idx = torch.arange(test_x.shape[-1], device=cum.device)
        cov = torch.where(idx[:, None] <= idx[None, :], cum[..., :, None],
                          cum[..., None, :])
        return pred_mean, cov


# ---------------------------------------------------------------------------
# Dense reference restatements (the oracle of the Markov forms)
# ---------------------------------------------------------------------------


def _blocks(cov, n):
    return cov[..., :n, :n], cov[..., :n, n:], cov[..., n:, n:]


def generate_prediction_dense(generator, model: VoltState, test_x, pred_vol,
                              n_sample: int = 1, latent_mean=None,
                              theta: float = 0.5, noise=None):
    """Literal dense restatement of ``rollout_utils.GeneratePrediction``:
    the joint covariance (kernel K2 on CUDA), psd-safe Cholesky with jitter
    1e-4, the conditional, Cholesky sampling.  ``pred_vol``: ``(..., H)``;
    ``noise``: the sampler's standard normals ``(n_sample, ..., H)``.
    Returns ``(..., n_sample, H)``."""
    with torch.no_grad():
        mean_mod = model.module.mean
        n = model.train_x.shape[-1]
        full_x = torch.cat([model.train_x, test_x], -1)
        vol = torch.exp(model.log_vol_path)
        batch = pred_vol.shape[:-1]
        full_vol = torch.cat([vol.expand(*batch, n), pred_vol], -1)
        k_tr, k_tr_te, k_te = _blocks(model.module.kernel(full_x, full_vol), n)
        if mean_mod.is_history_dependent:
            if test_x.shape[-1] != 1:
                raise ValueError("dense path supports Magpie means only for "
                                 "single-point queries (as in Rollouts)")
            train_mean = mean_mod.train_values(model.train_y)
            m_test = mean_mod.last_value(model.train_y)[..., None]
        else:
            train_mean = mean_mod(model.train_x)
            m_test = mean_mod(test_x)
        resid = (model.train_y - train_mean).expand(*batch, n)
        cond_mean, cond_cov = conditional(k_tr, k_tr_te, k_te, resid,
                                          jitter=1e-4)
        pred_mean = cond_mean + m_test
        if latent_mean is not None:
            pred_mean = pred_mean - theta * (pred_mean - latent_mean)
        samples = sample_mvn(torch.zeros_like(pred_mean), cond_cov,
                             (n_sample,), jitter=1e-4, generator=generator,
                             noise=noise)
        return samples.movedim(0, -2) + pred_mean[..., None, :]


def rollouts_dense(generator, model: VoltState, train_x, train_y, test_x,
                   nsample: int = 50, theta=None, pred_vol=None, zs=None):
    """Literal dense restatement of the reference's autoregressive loop:
    at every step the joint covariance of the grown series (kernel K2 on
    CUDA, ``(..., S, n+t+1, n+t+1)``), the psd-safe factor (jitter 1e-4),
    the conditional and one draw.  ``pred_vol`` and ``zs`` ``(..., S, H)``
    pin the vol paths and the per-step standard normals, so the result can
    be held per path against :func:`_rollout_volt_scan` on the same
    inputs.  Returns ``(..., S, H)``."""
    del train_x  # the model state carries its grid; kept for API parity
    with torch.no_grad():
        kernel = model.module.kernel
        mean_mod = model.module.mean
        y0 = model.train_y
        latent = (torch.mean(torch.log(train_y.to(y0.dtype)), dim=-1)
                  [..., None, None] if theta is not None else None)
        # the meanrevert latent mean is frozen at the construction-time
        # series mean (reference EWMA.py:124)
        mr_latent = (torch.mean(y0, dim=-1, keepdim=True)[..., None, :]
                     if isinstance(mean_mod, MeanRevertingEMAMean) else None)
        if pred_vol is None:
            pred_vol = sample_vol_paths(model.vol_state, test_x, nsample,
                                        generator)
        n0 = y0.shape[-1]
        xs = model.train_x
        ys = y0[..., None, :].expand(*y0.shape[:-1], nsample, n0)
        vols = torch.exp(model.log_vol_path)[..., None, :].expand_as(ys)
        out = []
        for t in range(test_x.shape[-1]):
            n = xs.shape[-1]
            full_x = torch.cat([xs, test_x[t:t + 1]], -1)
            full_vol = torch.cat([vols, pred_vol[..., t:t + 1]], -1)
            k_tr, k_tr_te, k_te = _blocks(kernel(full_x, full_vol), n)
            if mean_mod.is_history_dependent:
                extra = () if mr_latent is None else (mr_latent,)
                train_mean = mean_mod.train_values(ys, *extra)
                m_test = mean_mod.last_value(ys, *extra)[..., None]
            else:
                train_mean = mean_mod(xs)
                m_test = mean_mod(test_x[t:t + 1])
            cond_mean, cond_cov = conditional(k_tr, k_tr_te, k_te,
                                              ys - train_mean, jitter=1e-4)
            pred_mean = cond_mean + m_test
            if latent is not None:
                pred_mean = pred_mean - theta * (pred_mean - latent)
            if zs is None:
                y_t = sample_mvn(pred_mean, cond_cov, jitter=1e-4,
                                 generator=generator)[..., 0]
            else:
                sd = torch.sqrt(torch.clamp(cond_cov[..., 0, 0], min=0.0))
                y_t = pred_mean[..., 0] + sd * zs[..., t]
            out.append(y_t)
            xs, vols = full_x, full_vol
            ys = torch.cat([ys, y_t[..., None]], -1)
        return torch.stack(out, dim=-1)


def nonvol_rollouts_dense(generator, model, test_x, nsample: int = 50,
                          zs=None):
    """Dense per-step restatement of the reference's baseline loop (the
    oracle of :func:`nonvol_rollouts`): at every step the kernel matrix
    of the grown grid, its factor, the conditional and one draw per path.
    ``zs`` ``(nsample, H)`` pins the per-step standard normals.  Returns
    ``(nsample, H)``."""
    with torch.no_grad():
        kern, mean_mod, noise = _nonvol_parts(model)
        xs = model.train_x
        ys = model.train_y.expand(nsample, model.train_y.shape[-1])
        out = []
        for t in range(test_x.shape[-1]):
            x_t = test_x[t:t + 1]
            eye = torch.eye(xs.shape[-1], dtype=ys.dtype, device=ys.device)
            k_tr = kern(xs) + noise * eye
            if mean_mod.is_history_dependent:
                train_mean = mean_mod.train_values(ys)
                m_test = mean_mod.last_value(ys)[..., None]
            else:
                train_mean = mean_mod(xs)
                m_test = mean_mod(x_t)
            cond_mean, cond_cov = conditional(k_tr, kern(xs, x_t), kern(x_t),
                                              ys - train_mean)
            if zs is None:
                y_t = sample_mvn(cond_mean + m_test, cond_cov,
                                 generator=generator)[..., 0]
            else:
                sd = torch.sqrt(torch.clamp(cond_cov[..., 0, 0], min=0.0))
                y_t = (cond_mean + m_test)[..., 0] + sd * zs[:, t]
            out.append(y_t)
            xs = torch.cat([xs, x_t], -1)
            ys = torch.cat([ys, y_t[:, None]], -1)
        return torch.stack(out, dim=-1)
