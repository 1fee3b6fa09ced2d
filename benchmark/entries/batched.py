"""The batched entry: ``volt_tpu_torch.parallel.fit_forecast_batch`` over
the whole universe (``warm_start`` for the refits), and its reference:
the frozen copy's ``fit_forecast_batch`` over the watched assets, in
float64 on the card."""

from __future__ import annotations

import numpy as np
import torch

from entries.common import (REF_DTYPE, Base, grids, loss_gap, max_gap,
                            param_gap, rel_rows, stored_steps, tree_map)

STAGES = ("gpcv", "vol", "data")
PARAMS = ("gpcv_params", "vol_params", "volt_params")


class Entry(Base):
    """The program's entry at one configuration, with its draws and the
    check of its outputs against the reference."""

    def __init__(self, cfg: dict, device, seed: int):
        from volt_tpu_torch.parallel import (PipelineConfig,
                                             fit_forecast_batch, warm_start)
        self._config, self._fit, self._warm = (PipelineConfig,
                                               fit_forecast_batch, warm_start)
        self.device = torch.device(device)
        self.cfg = cfg
        self.assets, self.n = cfg["assets"], cfg["ntrain"] - 1
        self.horizon = cfg["horizon"]
        self.nsample = cfg["pipeline"]["nsample"]
        self.train_x, self.test_x = grids(self.n, self.horizon, cfg["dt"],
                                          torch.float32, self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # the assets whose outputs the check reads, drawn from the seed
        rng = np.random.default_rng(seed)
        self.watch = np.sort(rng.choice(
            self.assets, min(cfg["check_assets"], self.assets),
            replace=False))
        self._watch = torch.as_tensor(self.watch, device=self.device)

    def noise(self, seed: int) -> dict:
        """The Monte-Carlo normals of one call, from its seed."""
        g = torch.Generator(self.device).manual_seed(seed)
        kw = dict(dtype=torch.float32, device=self.device, generator=g)
        b, s, h = self.assets, self.nsample, self.horizon
        return {"vol_r0": torch.randn(b, s, **kw),
                "vol_z": torch.randn(b, s, h, **kw),
                "zs": torch.randn(b, s, h, **kw)}

    def keep(self, delivered: dict, aux) -> dict:
        """What the check reads of a call: the watched assets' rows."""
        w, b = self._watch, self.assets

        def take(v):
            return v[w] if torch.is_tensor(v) and v.dim() and \
                v.shape[0] == b else v

        return {"vol": aux["vol"][w],
                "losses": [aux[f"{s}_loss"][w] for s in STAGES],
                "params": {k: tree_map(take, aux[k]) for k in PARAMS},
                **{k: delivered[k][self.watch]
                   for k in ("fan", "mean", "std")}}

    # ---- the check ------------------------------------------------------

    def reference(self, items: list, dtype=REF_DTYPE, store=None):
        """The frozen copy's fit and forecast of every checked row: each
        item is one call, ``{"kept", "prev", "prices", "seed", "iters",
        "shift", "rows"}`` (``rows``: positions in the watched assets;
        ``prev``: the record whose state the call starts from, shifted by
        ``shift``, or ``None`` for a cold fit; ``iters``: Adam steps a
        stage, ``None`` for the configuration's own, ``0`` for a forecast
        from ``prev``'s state as it is).  ``store`` rounds the inputs,
        the initial state and every Adam step's parameters (the
        control)."""
        from reference.vplain.parallel.pipeline import (PipelineConfig,
                                                        fit_forecast_batch,
                                                        warm_start)
        def cast(t):
            t = t.to(self.device, dtype)
            return store(t) if store else t

        prices, noise, prev = [], {}, []
        for it in items:
            draws = self.noise(it["seed"])
            for p in it["rows"]:
                a = int(self.watch[p])
                prices.append(it["prices"][a])
                for k, v in draws.items():
                    noise.setdefault(k, []).append(v[a])
                if it["prev"] is not None:
                    prev.append(tree_map(
                        lambda v, p=p: _rows(v, slice(p, p + 1),
                                             len(self.watch)),
                        it["prev"]["params"]))
        init = None
        if prev:
            joined = {k: _cat([q[k] for q in prev]) for k in PARAMS}
            init = warm_start(tree_map(cast, joined),
                              shift=items[0]["shift"], n=self.n)
        train_x, test_x = grids(self.n, self.horizon, self.cfg["dt"], dtype,
                                self.device)
        p = self.pipeline(items[0]["iters"])
        gen = torch.Generator(self.device).manual_seed(0)
        with stored_steps(store):
            return fit_forecast_batch(
                gen, train_x, cast(torch.stack(prices)), test_x,
                PipelineConfig(**p), init_params=init,
                noise={k: cast(torch.stack(v)) for k, v in noise.items()})

    def as_kept(self, items: list, ref) -> list:
        """The items with a reference run's outputs in the program's
        place (the control), its rows numbered afresh."""
        (out, aux), done, start = ref, [], 0
        for it in items:
            end = start + len(it["rows"])
            cut = slice(start, end)
            kept = {"vol": aux["vol"][cut],
                    "losses": [aux[f"{s}_loss"][cut] for s in STAGES],
                    "params": {k: tree_map(lambda v: _rows(v, cut, len(
                        out)), aux[k]) for k in PARAMS},
                    "fan": out[cut].float().cpu().numpy(),
                    "mean": aux["forecast_mean"][cut].float().cpu().numpy(),
                    "std": aux["forecast_std"][cut].float().cpu().numpy()}
            done.append({**it, "kept": kept,
                         "rows": list(range(end - start))})
            start = end
        return done

    def state(self, items: list, ref) -> dict:
        """A reference run's fitted state, as ``prev`` of the next call of
        its rows (``items`` holds one call)."""
        return {"params": {k: ref[1][k] for k in PARAMS}}

    def numbers(self, items: list, ref) -> dict:
        """The numbers compared, the program's rows against the
        reference's: the vol path (largest gap of log vol), the final loss
        of each stage, the data model's fitted parameters, the fan with
        the mean (over each row's largest value) and the std (over each
        row's largest std)."""
        out, aux = ref
        rows = [(it["kept"], p) for it in items for p in it["rows"]]
        vol = torch.stack([k["vol"][p] for k, p in rows])
        losses = [torch.stack([k["losses"][i][p] for k, p in rows])
                  for i in range(len(STAGES))]
        fan = np.stack([np.concatenate([k["fan"][p], k["mean"][p][None]])
                        for k, p in rows])
        std = np.stack([k["std"][p] for k, p in rows])
        ref_fan = torch.cat([out, aux["forecast_mean"][:, None]], dim=1)
        return {
            "vol_gap": max_gap(torch.log(vol.double()),
                               torch.log(aux["vol"].double())),
            "loss_gap": max(loss_gap(losses[i], aux[f"{s}_loss"])
                            for i, s in enumerate(STAGES)),
            "data_gap": param_gap(_cat([tree_map(
                lambda v, k=k, p=p: _rows(v, slice(p, p + 1),
                                          len(k["vol"])),
                k["params"]["volt_params"]) for k, p in rows]),
                aux["volt_params"]),
            "fan_gap": rel_rows(fan, ref_fan),
            "std_gap": rel_rows(std, aux["forecast_std"]),
        }


def _rows(v, cut: slice, count: int):
    """Rows ``cut`` of a leaf with a leading axis of ``count`` rows; any
    other leaf as it is."""
    return v[cut] if torch.is_tensor(v) and v.dim() and \
        v.shape[0] == count else v


def _cat(trees):
    """Join per-row trees along their leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _cat([t[k] for t in trees]) for k in first}
    if torch.is_tensor(first) and first.dim():
        return torch.cat(trees)
    return first
