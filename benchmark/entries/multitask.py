"""The multitask entry: ``volt_tpu_torch.parallel.fit_forecast_multitask``
over the coupled universe (``warm_start_multitask`` for the refits), and
its reference: the frozen copy's ``fit_forecast_multitask`` of every
task, in float64 on the card."""

from __future__ import annotations

import numpy as np
import torch

from entries.common import (REF_DTYPE, Base, grids, loss_gap, max_gap,
                            param_gap, rel_rows, stored_steps, tree_map)

PARAMS = ("gpcv_params", "vol_params", "volt_params")


class Entry(Base):
    """The program's entry at one configuration, with its draws and the
    check of its outputs against the reference."""

    def __init__(self, cfg: dict, device, seed: int):
        from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                             fit_forecast_multitask,
                                             warm_start_multitask)
        self._config, self._fit, self._warm = (MultitaskPipelineConfig,
                                               fit_forecast_multitask,
                                               warm_start_multitask)
        self.device = torch.device(device)
        self.cfg, self.seed = cfg, seed
        self.assets, self.n = cfg["assets"], cfg["ntrain"] - 1
        self.horizon = cfg["horizon"]
        self.nsample = cfg["pipeline"]["nsample"]
        self.train_x, self.test_x = grids(self.n, self.horizon, cfg["dt"],
                                          torch.float32, self.device)
        # the cold fit's random initial values come from a CPU generator,
        # so that the reference draws the same ones
        self.generator = torch.Generator().manual_seed(seed)
        self.watch = np.arange(self.assets)

    def noise(self, seed: int) -> dict:
        """The Matheron sampler's and the rollout's normals of one call."""
        g = torch.Generator(self.device).manual_seed(seed)
        kw = dict(dtype=torch.float32, device=self.device, generator=g)
        t, s, n, h = self.assets, self.nsample, self.n, self.horizon
        return {"vol_z": torch.randn(s, n + h, t, **kw),
                "vol_eps": torch.randn(s, n, t, **kw),
                "zs": torch.randn(t, s, h, **kw)}

    def keep(self, delivered: dict, aux) -> dict:
        """What the check reads of a call: the joint state is whole."""
        return {"vol": aux["vols"],
                "losses": [aux["gpcv_loss"], aux["vol_loss"],
                           aux["data_losses"]],
                "params": {k: aux[k] for k in PARAMS},
                **{k: delivered[k] for k in ("fan", "mean", "std")}}

    # ---- the check ------------------------------------------------------

    def reference(self, items: list, dtype=REF_DTYPE, store=None):
        """The frozen copy's fit and forecast of each item (one call: all
        its tasks, ``rows`` is ignored), cold from the seed's initial
        values or from ``prev``'s state shifted by ``shift``, with
        ``iters`` Adam steps a stage (``None``: the configuration's own;
        ``0``: a forecast from ``prev``'s state as it is)."""
        from reference.vplain.parallel.pipeline_multitask import (
            MultitaskPipelineConfig, fit_forecast_multitask,
            warm_start_multitask)

        def cast(t):
            t = t.to(self.device, dtype)
            return store(t) if store else t

        train_x, test_x = grids(self.n, self.horizon, self.cfg["dt"], dtype,
                                self.device)
        outs, auxs = [], []
        for it in items:
            p = self.pipeline(it["iters"])
            init = None
            if it["prev"] is not None:
                init = warm_start_multitask(
                    tree_map(cast, it["prev"]["params"]), shift=it["shift"],
                    n=self.n)
            draws = self.noise(it["seed"])
            with stored_steps(store):
                out, aux = fit_forecast_multitask(
                    torch.Generator().manual_seed(self.seed), train_x,
                    cast(it["prices"]), test_x,
                    MultitaskPipelineConfig(**p), init_params=init,
                    noise={k: cast(v) for k, v in draws.items()})
            outs.append(out)
            auxs.append({"vols": aux["vols"],
                         "losses": [aux["gpcv_loss"], aux["vol_loss"],
                                    aux["data_losses"]],
                         "params": {k: aux[k] for k in PARAMS},
                         "mean": aux["forecast_mean"],
                         "std": aux["forecast_std"]})
        return outs, auxs

    def as_kept(self, items: list, ref) -> list:
        """The items with a reference run's outputs in the program's
        place (the control)."""
        outs, auxs = ref
        return [{**it, "kept": {"vol": aux["vols"], "losses": aux["losses"],
                                "params": aux["params"],
                                "fan": out.float().cpu().numpy(),
                                "mean": aux["mean"].float().cpu().numpy(),
                                "std": aux["std"].float().cpu().numpy()}}
                for it, out, aux in zip(items, outs, auxs)]

    def state(self, items: list, ref) -> dict:
        """A reference run's fitted state, as ``prev`` of the next call
        (``items`` holds one call)."""
        return {"params": ref[1][0]["params"]}

    def numbers(self, items: list, ref) -> dict:
        """As the batched entry's, over every task of every item; the
        joint losses (GPCV, vol GP) by their relative gap."""
        gaps = {"vol_gap": 0.0, "loss_gap": 0.0, "data_gap": 0.0,
                "fan_gap": 0.0, "std_gap": 0.0}
        for it, out, aux in zip(items, *ref):
            k = it["kept"]
            fan = np.concatenate([k["fan"], k["mean"][:, None]], axis=1)
            ref_fan = torch.cat([out, aux["mean"][:, None]], dim=1)
            now = {"vol_gap": max_gap(torch.log(k["vol"].double()),
                                      torch.log(aux["vols"].double())),
                   "loss_gap": max(loss_gap(a, b) for a, b in
                                   zip(k["losses"], aux["losses"])),
                   "data_gap": param_gap(k["params"]["volt_params"],
                                         aux["params"]["volt_params"]),
                   "fan_gap": rel_rows(fan, ref_fan),
                   "std_gap": rel_rows(k["std"], aux["std"])}
            gaps = {name: max(gaps[name], now[name]) for name in gaps}
        return gaps
