"""High-level convenience API (port of :mod:`volt_tpu.models.volt_api`):
construct, ``Train()``, ``Forecast()``, as the reference's ``Volt`` class.

The constructor takes the full log-price series and a mean name;
``Train`` runs GPCV -> vol GP -> data model (or skips GPCV for a supplied
``vol_path``); ``Forecast`` runs the Markov rollout.  ``(T, n)`` data
(the reference's ``TRAIN_Y: T X N``) take the Kronecker multitask chain:
the multitask GPCV, per-task price models and one multitask vol GP, and
:func:`~volt_tpu_torch.rollouts.rollouts_multitask`.
"""

from __future__ import annotations

from ..rollouts import rollouts, rollouts_multitask
from ..train import (learn_gpcv, learn_gpcv_multitask, train_vol_model,
                     train_volt_magpie, train_volt_multitask)

__all__ = ["Volt"]


class Volt:
    def __init__(self, train_x, log_data, mean: str = "constant",
                 vol_path=None, k: int = 25, rank: int = 1):
        """``train_x`` ``(n,)`` is the full grid and ``log_data`` ``(n,)``
        or ``(T, n)`` the log prices; ``vol_path`` ``(n-1,)`` or ``(T,
        n-1)`` optionally supplies the volatility path, skipping the GPCV
        stage; ``rank`` is the multitask task covariance's."""
        self.train_x = train_x
        self.log_data = log_data
        self.mean_name = mean
        self.k = k
        self.rank = rank
        self.vol_path = vol_path
        self.batched = log_data.dim() > 1
        self.model = None
        self.vol_model = None

    def Train(self, gpcv_iters: int = 400, vol_mod_iters: int = 1000,
              data_mod_iters: int = 400, display: bool = False,
              generator=None):
        """GPCV (NGVI) -> vol GP -> data model (reference ``Volt.Train``);
        ``generator`` draws the random initial values (the linear means',
        and for ``(T, n)`` data the multitask models')."""
        x = self.train_x
        data = self.log_data.exp()
        vol = self.vol_path
        if self.batched:
            if vol is None:
                vol = learn_gpcv_multitask(x[1:], data, gpcv_iters,
                                           rank=self.rank,
                                           generator=generator)
            self.model, self.vol_model = train_volt_multitask(
                x[1:], data[:, 1:], vol, train_iters=data_mod_iters,
                vol_iters=vol_mod_iters, k=self.k, mean_func=self.mean_name,
                rank=self.rank, printing=display, generator=generator)
            return self.model
        if vol is None:
            vol = learn_gpcv(x[1:], data, gpcv_iters, printing=display)
        vol_state = train_vol_model(x[1:], vol, vol_mod_iters,
                                    printing=display)
        self.model = train_volt_magpie(
            x[1:], data[1:], vol_state, vol, train_iters=data_mod_iters,
            printing=display, k=self.k, mean_func=self.mean_name,
            generator=generator)
        return self.model

    def Forecast(self, test_x, nsample: int = 50, mean_revert: bool = False,
                 theta: float = 0.05, generator=None, noise=None):
        """MC forecast samples of log prices ``(nsample, H)``, or ``(T,
        nsample, H)`` for ``(T, n)`` data; ``noise`` as
        :func:`~volt_tpu_torch.rollouts.rollouts` (or
        :func:`~volt_tpu_torch.rollouts.rollouts_multitask`) takes it."""
        if self.model is None:
            raise RuntimeError("call Train() first")
        theta = theta if mean_revert else None
        if self.batched:
            return rollouts_multitask(generator, self.model, self.vol_model,
                                      self.log_data.exp(), test_x,
                                      nsample=nsample, theta=theta,
                                      noise=noise)
        return rollouts(generator, self.model, self.train_x[1:],
                        self.log_data.exp(), test_x, nsample=nsample,
                        theta=theta, noise=noise)
