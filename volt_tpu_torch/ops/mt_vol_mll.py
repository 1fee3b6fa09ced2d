"""The multitask vol GP's spectral Woodbury MLL by kernel G4
(``csrc/mt_vol_mll.cu``).

:meth:`volt_tpu_torch.models.MultitaskBMGP.mll_spectral` composes it from
plain ops (:func:`..gp.kronecker.kron_mvn_log_prob_blockdiag_lowrank`):
``N`` blocks ``B_i = ld_i K_t + s I`` with ``K_t = F F^T + diag(v)``, each
by Woodbury through an ``r x r`` capacitance whose Cholesky climbs a jitter
ladder that waits for the card, and the rank-``T`` offset coupling by a
``T x T`` solve whose error check waits too and a log-determinant that
factors the same matrix again: about 300 kernel launches a step with
autograd's reverse, two LUs and two host waits.

G4 computes the same MLL and its gradient with respect to ``vol``, ``F``,
``v`` and the noise ``s`` in one call, and no wait: the block algebra in
two C calls of the kernel (float64 inside), and between them the coupling
by plain large products and one LU (:func:`_coupling`):

* ``S = diag(sum_i w_i^2 / d_i) - sum_i w_i^2 ld_i G_i M_i^{-1} G_i^T``
  (``G_i = D_i^{-1} F``, ``M_i = I + ld_i F^T D_i^{-1} F``), one product;
* ``m = I + S c K_t``, one product, factored once;
* ``[W | m^{-1} S] = m^{-1} [c K_t | S]``, one solve on that factor;
* ``Y = W G`` for every block, one product.

With ``Sigma = blockdiag(B_i) + c (w w^T) (x) K_t`` the log-density's
gradient is ``Sigma^{-1} - alpha alpha^T`` (``alpha = Sigma^{-1} r``), so

* ``d/dB_i = B_i^{-1} - alpha_i alpha_i^T - w_i^2 B_i^{-1} W B_i^{-1}``,
  ``alpha_i = z_i - w_i B_i^{-1} g``, ``z_i = B_i^{-1} r_i``, ``g = W v``;
* ``d/d(c K_t) = m^{-1} S - a a^T``, ``a = v - S g``;

and ``B_i``, ``K_t``, ``r_i`` and ``c`` depend on the parameters in closed
form.  :func:`mt_vol_mll_reference` is that computation in plain float64
PyTorch, phase by phase as the kernel runs it; the CPU tests hold it to
autograd of the composition, and the composition stays the CPU's path
(``native.on_card``: on the card G4 runs or its wrapper raises).
"""

from __future__ import annotations

import math

import torch

from .. import native

__all__ = ["G4_MAX_RANK", "mt_vol_mll", "mt_vol_mll_cuda",
           "mt_vol_mll_reference"]

# The largest rank of the task factor that G4 takes (``RMAX`` in the
# kernel's source).
G4_MAX_RANK = 4
_LOG_2PI = math.log(2.0 * math.pi)


def _coupling(gm, jm, bmat, m):
    """The ``T x T`` coupling between G4's two C calls, on the buffers
    the first one wrote: ``gm``, ``jm`` ``(N, r, T)`` (``G_i^T`` and
    ``w_i^2 ld_i (G_i M_i^{-1})^T``), ``bmat (T, 2T) = [c K_t | diag(S)]``
    and ``m = I``.  Completes ``S`` in ``bmat``'s right half and ``m = I +
    S c K_t`` in place, factors ``m`` once (its ``info`` is never read: a
    singular or non-finite ``m`` gives a non-finite MLL, not a wait) and
    returns the factor, ``[W | m^{-1} S]`` and ``Y (N r, T)``, row ``(i,
    k)`` the column ``k`` of ``W G_i``."""
    t = m.shape[-1]
    g2, j2 = gm.flatten(0, 1), jm.flatten(0, 1)
    s_mat = bmat[:, t:]
    s_mat.addmm_(j2.mT, g2, alpha=-1.0)
    m.addmm_(s_mat, bmat[:, :t])
    lu, piv, _ = torch.linalg.lu_factor_ex(m)
    sol = torch.linalg.lu_solve(lu, piv, bmat)
    return lu, sol, g2 @ sol[:, :t].mT


def mt_vol_mll_reference(p_y, p_x, mu, w, dx, x0, vol, factor, task_diag,
                         noise):
    """G4's MLL ``/ (N T)`` and its gradients with respect to ``(vol,
    factor, task_diag, noise)``, in plain PyTorch in the inputs' dtype (the
    tests' is float64), as ``csrc/mt_vol_mll.cu`` computes them: the
    spectral cache ``p_y (N, T)``, ``p_x``, ``mu``, ``w`` ``(N,)``,
    ``dx``, ``x0`` (0-dim), ``vol (1,)``, ``factor (T, r)``, ``task_diag
    (T,)`` and ``noise (1,)``.  Returns ``(mll, (g_vol, g_factor,
    g_task_diag, g_noise))``."""
    n, t = p_y.shape
    r = factor.shape[-1]
    f, v = factor, task_diag
    vol_, s = vol.reshape(()), noise.reshape(())
    c = vol_ * (x0 - dx)
    eye_r = torch.eye(r, dtype=f.dtype, device=f.device)
    # (1) the rows: each block's capacitance, its inverse, z_i's weights
    ld = vol_ * dx * mu
    diag_b = torch.sum(f * f, dim=-1) + v
    rt = p_y + (0.5 * vol_ ** 2 * p_x)[:, None] * diag_b
    d = ld[:, None] * v + s
    dinv = 1.0 / d
    cap = eye_r + ld[:, None, None] * torch.einsum("nt,ta,tb->nab", dinv, f,
                                                    f)
    chol = torch.linalg.cholesky_ex(cap)[0]  # cap >= I: no check
    minv = torch.cholesky_inverse(chol)
    fu = torch.einsum("ta,nt->na", f, dinv * rt)
    sol = torch.einsum("nab,nb->na", minv, fu)
    quad = torch.sum(dinv * rt * rt, dim=-1) - ld * torch.sum(fu * sol, -1)
    logdet = torch.sum(torch.log(d), dim=-1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    gm = dinv[:, None, :] * f.mT  # (N, r, T): G_i^T
    jm = (w * w * ld)[:, None, None] * torch.einsum("nlk,nlt->nkt", minv,
                                                     gm)
    # (2) the columns: v = sum_i w_i z_i and S's diagonal
    z = dinv * rt - ld[:, None] * dinv * (sol @ f.mT)
    vv = torch.sum(w[:, None] * z, dim=0)
    k_t = f @ f.mT + torch.diag(v)
    bmat = torch.cat([c * k_t, torch.diag(torch.sum((w * w)[:, None] * dinv,
                                                    dim=0))], dim=1)
    m = torch.eye(t, dtype=f.dtype, device=f.device)
    # the coupling
    lu, sol_c, y0 = _coupling(gm, jm, bmat, m)
    w_mat, ms = sol_c[:, :t], sol_c[:, t:]
    # (3) the coupling's vectors and traces
    g = w_mat @ vv
    a = vv - bmat[:, t:] @ g
    msf = 0.5 * (ms + ms.mT) @ f
    tr_kms = torch.sum(k_t * ms.mT)
    logdet_m = torch.sum(torch.log(torch.abs(torch.diagonal(lu))))
    af = f.mT @ a
    aka = torch.sum(af * af) + torch.sum(v * a * a)
    # (4) each block's d/dB_i, by its diagonal and its product with F
    y = y0.reshape(n, r, t)
    mg = torch.einsum("nkl,nl->nk", minv, torch.einsum("nkt,t->nk", gm, g))
    phi = torch.einsum("nkt,nlt->nkl", gm, y)
    mpm = minv @ phi @ minv
    alpha = z - w[:, None] * (dinv * g - ld[:, None] * dinv * (mg @ f.mT))
    gmm = torch.einsum("nlt,nlk->nkt", gm, minv)  # (G_i M_i^{-1})^T
    ym = torch.einsum("nlt,nlk->nkt", y, minv)  # (Y_i M_i^{-1})^T
    gmpm = torch.einsum("nlt,nlk->nkt", gm, mpm)
    diag_binv = dinv - ld[:, None] * torch.sum(gm * gmm, dim=1)
    diag_bwb = dinv * dinv * torch.diagonal(w_mat) \
        - 2.0 * ld[:, None] * dinv * torch.sum(ym * gm, dim=1) \
        + (ld * ld)[:, None] * torch.sum(gmpm * gm, dim=1)
    w2 = (w * w)[:, None]
    db_diag = diag_binv - alpha * alpha - w2 * diag_bwb
    a_f = sol - w[:, None] * mg
    dbf = gmm - alpha[:, None, :] * a_f[:, :, None] \
        - w2[:, None] * (dinv[:, None, :] * ym - ld[:, None, None] * gmpm)
    # (5) the gradient of Phi = -2 N T mll
    grad_ld = torch.einsum("tk,nkt->n", f, dbf) + db_diag @ v
    d_diag_b = vol_ ** 2 * (p_x @ alpha)
    kbf = torch.einsum("n,nkt->tk", ld, dbf) + c * (msf - a[:, None] * af) \
        + d_diag_b[:, None] * f
    kbd = ld @ db_diag + c * (torch.diagonal(ms) - a * a) + d_diag_b
    d_c = tr_kms - aka
    phi_val = torch.sum(quad) + torch.sum(logdet) + logdet_m - vv @ g \
        + n * t * _LOG_2PI
    d_vol = grad_ld @ (dx * mu) + d_c * (x0 - dx) \
        + 2.0 * vol_ * (p_x @ (alpha @ diag_b))
    scale = -0.5 / (n * t)
    grads = (scale * d_vol.reshape(vol.shape), scale * 2.0 * kbf,
             scale * kbd, scale * torch.sum(db_diag).reshape(noise.shape))
    return scale * phi_val, grads


def mt_vol_mll_cuda(p_y, p_x, mu, w, dx, x0, vol, factor, task_diag, noise):
    """Kernel G4 over contiguous float32 CUDA tensors (the shapes of
    :func:`mt_vol_mll_reference`): returns ``(mll, grads)``, the MLL ``/
    (N T)`` (a scalar) and its gradients with respect to ``(vol, factor,
    task_diag, noise)`` in their shapes.  Two C calls and, between them,
    :func:`_coupling`'s products, LU and solve; nothing waits for the
    card."""
    ins = (p_y, p_x, mu, w, dx, x0, vol, factor, task_diag, noise)
    native.check_tensors("mt_vol_woodbury_mll", *ins)
    n, t = p_y.shape if p_y.dim() == 2 else (0, 0)
    r = factor.shape[-1] if factor.dim() == 2 else 0
    want = {"p_y": (n, t), "p_x": (n,), "mu": (n,), "w": (n,), "dx": (),
            "x0": (), "vol": (1,), "factor": (t, r), "task_diag": (t,),
            "noise": (1,)}
    got = {k: tuple(a.shape) for k, a in zip(want, ins)}
    if n < 1 or t < 1 or not 1 <= r <= G4_MAX_RANK or got != want:
        raise ValueError(f"mt_vol_woodbury_mll: expected {want} with N, T "
                         f">= 1 and 1 <= r <= {G4_MAX_RANK}, got {got}")
    gm = p_y.new_empty(n, r, t)
    jm = p_y.new_empty(n, r, t)
    bmat = p_y.new_empty(t, 2 * t)
    m = p_y.new_empty(t, t)
    ws = torch.empty(native.size("volt_mt_vol_woodbury_workspace_len", n, t,
                                 r), dtype=torch.float64, device=p_y.device)
    native.launch("volt_mt_vol_woodbury_blocks", *ins, gm, jm, bmat, m, ws,
                  ws.numel(), n, t, r, device=p_y.device)
    lu, sol, y0 = _coupling(gm, jm, bmat, m)
    out = p_y.new_empty(())
    grads = tuple(torch.empty_like(a) for a in (vol, factor, task_diag,
                                                noise))
    # the factor and the solution by their strides (LAPACK's column-major)
    native.launch("volt_mt_vol_woodbury_mll", *ins, bmat, lu,
                  lu.stride(0) + lu.stride(1), sol, sol.stride(0),
                  sol.stride(1), y0, out, *grads, ws, ws.numel(), n, t, r,
                  device=p_y.device)
    return out, grads


class _MtVolMLL(torch.autograd.Function):
    """G4's forward, keeping its gradients; the backward scales them."""

    @staticmethod
    def forward(ctx, p_y, p_x, mu, w, dx, x0, vol, factor, task_diag, noise):
        out, grads = mt_vol_mll_cuda(p_y, p_x, mu, w, dx, x0, vol, factor,
                                     task_diag, noise)
        ctx.save_for_backward(*grads)
        return out

    @staticmethod
    def backward(ctx, g):
        # one multi-tensor launch for the four
        grads = torch._foreach_mul(list(ctx.saved_tensors), g)
        return (None,) * 6 + tuple(t if need else None for t, need in
                                   zip(grads, ctx.needs_input_grad[6:]))


def mt_vol_mll(p_y, p_x, mu, w, dx, x0, vol, factor, task_diag, noise):
    """The MLL ``/ (N T)`` of ``MultitaskBMGP.mll_spectral`` by G4, for
    the card's tensors: gradients reach ``vol (1,)``, the task factor, its
    diagonal and ``noise (1,)``.  Raises on what G4 does not take: a batch,
    a task factor of rank above :data:`G4_MAX_RANK`, a tensor not float32,
    and a gradient wanted for the spectral cache (``p_y`` ... ``x0``)."""
    ins = tuple(a.contiguous() for a in (p_y, p_x, mu, w, dx, x0, vol,
                                         factor, task_diag, noise))
    grad = torch.is_grad_enabled()
    if grad and any(a.requires_grad for a in ins[:6]):
        raise ValueError("mt_vol_woodbury_mll: G4 gives no gradient for "
                         "the spectral cache")
    if grad and any(a.requires_grad for a in ins[6:]):
        return _MtVolMLL.apply(*ins)
    return mt_vol_mll_cuda(*ins)[0]
