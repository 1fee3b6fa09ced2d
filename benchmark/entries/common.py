"""What the entries share: nested parameter trees, the comparison's
numbers, and seeds for the per-call draws."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import counts

# float64 on the card; the control passes its own
REF_DTYPE = torch.float64


def grids(n: int, horizon: int, dt: float, dtype, device):
    """The return grid of ``n`` steps of ``dt`` from 0 and the ``horizon``
    steps after it (the timing tools' grids)."""
    train_x = torch.arange(n, dtype=dtype, device=device) * dt
    test_x = torch.arange(horizon, dtype=dtype, device=device) * dt \
        + train_x[-1] + dt
    return train_x, test_x


class Base:
    """What both entries do alike: the settings at a number of Adam steps,
    the call, the warm start, the delivery to the host, the stage clock
    and the operations of a call.  A subclass sets ``_config``, ``_fit``,
    ``_warm``, ``cfg``, ``assets``, ``n``, ``horizon``, ``nsample``,
    ``generator``, ``train_x`` and ``test_x``.

    The interface that the loops and the harness use: ``settings``,
    ``call``, ``warm_start``, ``noise``, ``deliver``, ``keep``,
    ``stages``, ``ops``; for the check ``watch``, ``reference``,
    ``numbers``, ``as_kept`` and ``state``."""

    def pipeline(self, iters: int | None = None) -> dict:
        """The configuration's settings, with ``iters`` Adam steps a stage
        in place of its own where given."""
        p = dict(self.cfg["pipeline"])
        if iters is not None:
            p.update(gpcv_iters=iters, vol_iters=iters, data_iters=iters)
        return p

    def settings(self, iters: int | None = None):
        return self._config(**self.pipeline(iters))

    def ops(self, iters: int | None = None) -> float:
        """Floating-point operations of one call (``counts.call_ops``)."""
        p = self.pipeline(iters)
        return counts.call_ops(self.assets, self.n, self.horizon,
                               self.nsample, (p["gpcv_iters"],
                                              p["vol_iters"],
                                              p["data_iters"]))

    def stages(self, aux) -> dict:
        """Seconds of each stage of a call, by the program's stage clock,
        which waits for the card at each mark."""
        return dict(aux["stage_seconds"])

    def call(self, prices, config, init, noise):
        return self._fit(self.generator, self.train_x, prices, self.test_x,
                         config, init_params=init, noise=noise)

    def warm_start(self, aux, shift: int):
        return self._warm(aux, shift=shift, n=self.n)

    def deliver(self, out, aux) -> dict:
        """The forecast on the host: the fan, its mean and std, and the
        per-asset ``ok`` flags."""
        return {"fan": out.cpu().numpy(),
                "mean": aux["forecast_mean"].cpu().numpy(),
                "std": aux["forecast_std"].cpu().numpy(),
                "ok": aux["ok"].cpu().numpy()}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def call_seed(seed: int, index: int) -> int:
    """The seed of call ``index``'s draws: distinct for every call of a
    run and every run's seed, within a generator's 64 bits."""
    return (seed * 1_000_003 + 7919 * index + 1) % (2**63 - 1)


def _np(a):
    return (a.detach().double().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float64))


def max_gap(got, want, scale=None) -> float:
    """The largest ``|got - want|``, over ``scale`` (a number) if given;
    ``inf`` where ``got`` is not finite and ``want`` is; entries where
    both fail are left out."""
    got, want = _np(got), _np(want)
    fine = np.isfinite(want)
    if not fine.any():
        return 0.0
    if not np.isfinite(got[fine]).all():
        return float("inf")
    gap = float(np.max(np.abs(got[fine] - want[fine])))
    return gap / scale if scale else gap


def rel_rows(got, want) -> float:
    """The largest gap of each row (leading axis) over that row's largest
    ``|want|``, the largest over the rows."""
    got, want = _np(got), _np(want)
    out = 0.0
    for g, w in zip(got, want):
        fine = np.isfinite(w)
        if fine.any():
            out = max(out, max_gap(g, w, float(np.max(np.abs(w[fine])))
                                   or 1.0))
    return out


def leaves(tree, prefix=""):
    """``(path, tensor)`` of every tensor of a nested parameter tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif torch.is_tensor(tree):
        yield prefix[:-1], tree


def param_gap(got, want) -> float:
    """The largest gap of fitted parameters, leaf by leaf and entry by
    entry, over ``max(1, |want|)``: raw (unconstrained) parameters of
    order one by their distance, larger ones by their relative one."""
    want = dict(leaves(want))
    return max((loss_gap(g, want[k]) for k, g in leaves(got)), default=0.0)


def loss_gap(got, want) -> float:
    """The largest ``|got - want| / max(1, |want|)`` of final losses: per
    datum losses of order one by their distance, summed joint losses by
    their relative one."""
    got, want = np.atleast_1d(_np(got)), np.atleast_1d(_np(want))
    fine = np.isfinite(want)
    if not fine.any():
        return 0.0
    if not np.isfinite(got[fine]).all():
        return float("inf")
    return float(np.max(np.abs(got[fine] - want[fine])
                        / np.maximum(1.0, np.abs(want[fine]))))


@contextlib.contextmanager
def stored_steps(store):
    """The reference's Adam with its parameters passed through ``store``
    after every step (the control's lower precision), while open."""
    if store is None:
        yield
        return
    from reference.vplain.optim import Adam

    step = Adam.step

    def rounded(self):
        step(self)
        with torch.no_grad():
            for p in self.params:
                p.copy_(store(p))

    Adam.step = rounded
    try:
        yield
    finally:
        Adam.step = step
