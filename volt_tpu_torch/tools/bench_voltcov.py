"""Kernel K2 (the dense Volt covariance, ``csrc/volt_cov.cu``) against its
plain twin (port of the JAX package's ``tools/bench_voltcov.py``).

Times ``ops.volt_cov.volt_covariance`` (the vol integral, then K2 through
its wrapper) and the plain ``ops.volint.min_index_covariance(vol_integral
(...))`` at bench-like shapes, each the least of ``--reps`` calls after a
first call, whose time is printed beside it, and requires the two to be
bit-identical: it exits non-zero otherwise.  The keys are the JAX tool's:
``pallas_ms`` is the kernel's time (K2 replaces the Pallas kernel) and
``xla_ms`` the plain twin's.  With ``--device cpu`` both are the plain
version (a CPU tensor takes it): ``route`` says which ran.

Run::

    python -m volt_tpu_torch.tools.bench_voltcov [--batch 64] [--n 999]
        [--reps 30] [--device cuda]
"""

from __future__ import annotations

import json

import torch

from ..ops.volint import min_index_covariance, vol_integral
from ..ops.volt_cov import volt_covariance
from ..utils.profiling import timed_cold_best
from ._common import DT, backend, parser, seeded

__all__ = ["main"]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n", type=int, default=999)
    p.add_argument("--reps", type=int, default=30)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    x = torch.arange(a.n, dtype=torch.float32, device=dev) * DT
    vol = 0.2 + 0.01 * torch.randn(a.batch, a.n, device=dev,
                                   generator=seeded(dev, 0))
    got, t_kernel, kernel_first = timed_cold_best(
        lambda: volt_covariance(x, vol), a.reps)
    want, t_plain, plain_first = timed_cold_best(
        lambda: min_index_covariance(vol_integral(x, vol)), a.reps)
    identical = bool(torch.equal(got, want))
    rec = {
        "stage": "volt_cov_build", "backend": backend(dev),
        "route": "cuda" if dev.type == "cuda" else "plain",
        "batch": a.batch, "n": a.n,
        "pallas_ms": round(t_kernel * 1e3, 4),
        "xla_ms": round(t_plain * 1e3, 4),
        "bit_identical": identical,
        "pallas_first_ms": round(kernel_first * 1e3, 4),
        "xla_first_ms": round(plain_first * 1e3, 4),
    }
    print(json.dumps(rec))
    if not identical:
        raise SystemExit("K2's output differs from its plain twin")
    return rec


if __name__ == "__main__":
    main()
