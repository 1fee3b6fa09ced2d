"""The FBM entry: ``volt_tpu_torch.parallel.fit_forecast_batch`` with the
FBM vol kernel over the whole book (``warm_start`` for the refits), as
the batched entry drives it (its draws, ``keep``, ``numbers`` and control
are the batched entry's, imported), and its reference: the frozen copy
``reference.vfbm``'s ``fit_forecast_batch`` over the watched assets, in
float64 on the card, its jitter ladders from the rung of the
configuration's precision (``reference/vfbm/pipeline.py`` says why).  Its
operations add the dense GPCV family's lower bound (``counts_fbm``) to the
batched count."""

from __future__ import annotations

import torch

import counts_fbm
from entries.batched import PARAMS, Entry as Batched, _cat, _rows
from entries.common import (REF_DTYPE, grids, param_gap, stored_steps,
                            tree_map)


class Entry(Batched):
    """The program's entry at an FBM configuration, with its draws and the
    check of its outputs against the reference."""

    def ops(self, iters: int | None = None) -> float:
        """Floating-point operations of one call (``counts_fbm.call_ops``)."""
        p = self.pipeline(iters)
        return counts_fbm.call_ops(self.assets, self.n, self.horizon,
                                   self.nsample, (p["gpcv_iters"],
                                                  p["vol_iters"],
                                                  p["data_iters"]))

    def reference(self, items: list, dtype=REF_DTYPE, store=None):
        """The frozen FBM copy's fit and forecast of every checked row, with
        the items and the control's ``store`` as the batched entry's
        :meth:`~entries.batched.Entry.reference` takes them."""
        from reference.vfbm.chol import default_jitter
        from reference.vfbm.pipeline import (PipelineConfig,
                                             fit_forecast_batch, warm_start)

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
        gen = torch.Generator(self.device).manual_seed(0)
        with stored_steps(store):
            return fit_forecast_batch(
                gen, train_x, cast(torch.stack(prices)), test_x,
                PipelineConfig(**self.pipeline(items[0]["iters"]),
                               jitter=default_jitter(
                                   getattr(torch, self.cfg["dtype"]))),
                init_params=init,
                noise={k: cast(torch.stack(v)) for k, v in noise.items()})

    def numbers(self, items: list, ref) -> dict:
        """The batched entry's numbers, with the vol GP's fitted parameters
        (the Hurst exponent and the noise, which set the dense forecast) in
        ``data_gap`` beside the data model's: the fan, which shows them in
        the BM cells, reads here as far from float64 as the control does,
        through the float32 dense sampler (PERF.md §2)."""
        out = super().numbers(items, ref)
        rows = [(it["kept"], p) for it in items for p in it["rows"]]
        got = _cat([tree_map(lambda v, k=k, p=p: _rows(
            v, slice(p, p + 1), len(k["vol"])), k["params"]["vol_params"])
            for k, p in rows])
        out["data_gap"] = max(out["data_gap"],
                              param_gap(got, ref[1]["vol_params"]))
        return out
