"""Batched BFGS: `jax.scipy.optimize.minimize(method='BFGS')` for a batch
of independent problems that advance in lock step.

The algorithm is JAX's (`jax/_src/scipy/optimize/bfgs.py` and
`line_search.py`: Nocedal & Wright's Algorithm 6.1 with the strong-Wolfe
line search of Algorithm 3.5 and its zoom, Algorithm 3.6), copied so that
each row follows exactly the path an unbatched JAX BFGS takes on it, and
so `jax.vmap` of it. The three nested loops of the JAX code (BFGS
iterations, line-search iterations, zoom iterations) keep their nesting;
each runs while any row is still in it, every row not in it keeps its
state, and every loop iteration makes one batched call of the objective.
So the number of calls depends on the slowest row, not on the sum over
rows; deciding whether a loop goes on costs one host sync an iteration.

Under `jax.vmap` the JAX code runs both zoom branches for every row; the
rows here run the one zoom they take, so evaluation counts are not
comparable with JAX's ``nfev``, though every row's iterates, status and
iteration count are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

C1 = 1e-4               # the line search's sufficient-decrease constant
C2 = 0.9                # its curvature constant
ZOOM_MAXITER = 30       # zoom iterations before the zoom counts as failed


class BFGSResult(NamedTuple):
    """Per row: ``x_k`` [B, K], ``f_k`` [B], ``g_k`` [B, K], ``status`` [B]
    (0 converged, 1 maxiter reached, 2 + the line search's status when it
    failed: 3 its zoom failed, 5 it reached its own maxiter; -1 otherwise)
    and ``k`` [B] BFGS iterations; ``n_evals``: the batched calls of the
    objective made, the initial one included."""
    x_k: torch.Tensor
    f_k: torch.Tensor
    g_k: torch.Tensor
    status: torch.Tensor
    k: torch.Tensor
    n_evals: int


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2_0 = fb - fa - C * db
    d2_1 = fc - fa - C * dc
    A = (dc ** 2 * d2_0 + (-db ** 2) * d2_1) / denom
    B = (-dc ** 3 * d2_0 + db ** 3 * d2_1) / denom
    radical = B * B - 3. * A * C
    return a + (-B + torch.sqrt(radical)) / (3. * A)


def _quadmin(a, fa, fpa, b, fb):
    """The minimiser of the quadratic through (a, fa, fpa), (b, fb)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2. * B)


class _Search:
    """What the line search and its zoom share: the row's start point and
    direction, the objective along it, and the Wolfe tests."""

    def __init__(self, evaluate, xk, pk, phi_0, dphi_0):
        self.evaluate, self.xk, self.pk = evaluate, xk, pk
        self.phi_0, self.dphi_0 = phi_0, dphi_0

    def at(self, t, rows):
        """(phi, dphi, g) at xk + t pk for ``rows``; the other rows are
        evaluated at xk (a finite point) and their values are not used."""
        x = torch.where(rows[:, None], self.xk + t[:, None] * self.pk,
                        self.xk)
        phi, g = self.evaluate(x)
        return phi, (g * self.pk).sum(-1), g

    def wolfe_one(self, a, phi):
        """The negation of the sufficient-decrease condition."""
        return phi > self.phi_0 + C1 * a * self.dphi_0

    def wolfe_two(self, dphi):
        return dphi.abs() <= -C2 * self.dphi_0


def _zoom(search, rows, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi, g_0):
    """JAX's `_zoom` for ``rows`` [B] at once: returns (failed, a_star,
    phi_star, dphi_star, g_star), each row's own result on ``rows``."""
    finfo = torch.finfo(a_lo.dtype)
    threshold = 1e-5 if finfo.bits < 64 else 1e-10
    done = torch.zeros_like(rows)
    failed = torch.zeros_like(rows)
    a_rec = (a_lo + a_hi) / 2.
    phi_rec = (phi_lo + phi_hi) / 2.
    a_star = torch.ones_like(a_lo)
    phi_star, dphi_star, g_star = phi_lo, dphi_lo, g_0
    active = rows
    j = 0
    while bool(active.any()):
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = 0.2 * dalpha
        qchk = 0.1 * dalpha
        # the step is as small as it can get: the search stops, and as the
        # Wolfe conditions do not hold the minimisation stops too
        failed = failed | (active & (dalpha <= threshold))
        # the cubic is sometimes NaN; its bounds test then fails
        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = (j > 0) & (a_j_cubic > a + cchk) & (a_j_cubic < b - cchk)
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = ~use_cubic & (a_j_quad > a + qchk) & (a_j_quad < b - qchk)
        use_bisection = ~use_cubic & ~use_quad
        a_j = torch.where(use_cubic, a_j_cubic, a_rec)
        a_j = torch.where(use_quad, a_j_quad, a_j)
        a_j = torch.where(use_bisection, (a_lo + a_hi) / 2., a_j)

        phi_j, dphi_j, g_j = search.at(a_j, active)
        hi_to_j = search.wolfe_one(a_j, phi_j) | (phi_j >= phi_lo)
        star_to_j = search.wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0.) & ~hi_to_j & ~star_to_j
        lo_to_j = ~hi_to_j & ~star_to_j
        hi_to_j, star_to_j, hi_to_lo, lo_to_j = (
            m & active for m in (hi_to_j, star_to_j, hi_to_lo, lo_to_j))

        # the updates in JAX's order, each on its own rows
        a_rec = torch.where(hi_to_j, a_hi, a_rec)
        phi_rec = torch.where(hi_to_j, phi_hi, phi_rec)
        a_hi = torch.where(hi_to_j, a_j, a_hi)
        phi_hi = torch.where(hi_to_j, phi_j, phi_hi)
        dphi_hi = torch.where(hi_to_j, dphi_j, dphi_hi)

        done = done | star_to_j
        a_star = torch.where(star_to_j, a_j, a_star)
        phi_star = torch.where(star_to_j, phi_j, phi_star)
        dphi_star = torch.where(star_to_j, dphi_j, dphi_star)
        g_star = torch.where(star_to_j[:, None], g_j, g_star)

        a_rec = torch.where(hi_to_lo, a_hi, a_rec)
        phi_rec = torch.where(hi_to_lo, phi_hi, phi_rec)
        a_hi = torch.where(hi_to_lo, a_lo, a_hi)
        phi_hi = torch.where(hi_to_lo, phi_lo, phi_hi)
        dphi_hi = torch.where(hi_to_lo, dphi_lo, dphi_hi)

        rec_to_lo = lo_to_j & ~hi_to_lo
        a_rec = torch.where(rec_to_lo, a_lo, a_rec)
        phi_rec = torch.where(rec_to_lo, phi_lo, phi_rec)

        a_lo = torch.where(lo_to_j, a_j, a_lo)
        phi_lo = torch.where(lo_to_j, phi_j, phi_lo)
        dphi_lo = torch.where(lo_to_j, dphi_j, dphi_lo)

        j += 1
        if j >= ZOOM_MAXITER:
            failed = failed | active
        active = active & ~done & ~failed
    return failed, a_star, phi_star, dphi_star, g_star


def _line_search(evaluate, xk, pk, old_fval, old_old_fval, gfk, rows,
                 maxiter):
    """JAX's `line_search` for ``rows`` [B] at once, from the value and
    gradient at ``xk``: returns (failed, status, a_k, f_k, g_k) per row."""
    dphi_0 = (gfk * pk).sum(-1)
    search = _Search(evaluate, xk, pk, old_fval, dphi_0)
    candidate_start = 1.01 * 2 * (old_fval - old_old_fval) / dphi_0
    start_value = torch.where(candidate_start > 1, 1.0, candidate_start)

    done = torch.zeros_like(rows)
    failed = torch.zeros_like(rows)
    # the search starts at i = 1, as in Nocedal & Wright
    i = torch.ones_like(rows, dtype=torch.int64)
    a_i1 = torch.zeros_like(old_fval)
    phi_i1, dphi_i1 = old_fval, dphi_0
    a_star = torch.zeros_like(old_fval)
    phi_star, dphi_star, g_star = old_fval, dphi_0, gfk
    active = rows
    while bool(active.any()):
        # no largest step: double, as scipy does
        a_i = torch.where(i == 1, start_value, a_i1 * 2.)
        phi_i, dphi_i, g_i = search.at(a_i, active)

        star_to_zoom1 = search.wolfe_one(a_i, phi_i) | \
            ((phi_i >= phi_i1) & (i > 1))
        star_to_i = search.wolfe_two(dphi_i) & ~star_to_zoom1
        star_to_zoom2 = (dphi_i >= 0.) & ~star_to_zoom1 & ~star_to_i
        star_to_zoom1, star_to_i, star_to_zoom2 = (
            m & active for m in (star_to_zoom1, star_to_i, star_to_zoom2))

        # zoom1 brackets [a_{i-1}, a_i], zoom2 [a_i, a_{i-1}]; a row takes
        # at most one, so one zoom runs both sets of rows
        z1 = star_to_zoom1
        zoom_failed, za, zphi, zdphi, zg = _zoom(
            search, star_to_zoom1 | star_to_zoom2,
            torch.where(z1, a_i1, a_i), torch.where(z1, phi_i1, phi_i),
            torch.where(z1, dphi_i1, dphi_i), torch.where(z1, a_i, a_i1),
            torch.where(z1, phi_i, phi_i1), torch.where(z1, dphi_i, dphi_i1),
            gfk)
        zoomed = star_to_zoom1 | star_to_zoom2
        done = done | zoomed | star_to_i
        failed = failed | (zoomed & zoom_failed)
        a_star = torch.where(zoomed, za, torch.where(star_to_i, a_i, a_star))
        phi_star = torch.where(zoomed, zphi,
                               torch.where(star_to_i, phi_i, phi_star))
        dphi_star = torch.where(zoomed, zdphi,
                                torch.where(star_to_i, dphi_i, dphi_star))
        g_star = torch.where(zoomed[:, None], zg,
                             torch.where(star_to_i[:, None], g_i, g_star))

        i = torch.where(active, i + 1, i)
        a_i1 = torch.where(active, a_i, a_i1)
        phi_i1 = torch.where(active, phi_i, phi_i1)
        dphi_i1 = torch.where(active, dphi_i, dphi_i1)
        active = active & ~done & (i <= maxiter) & ~failed

    status = torch.where(failed, 1, torch.where(i > maxiter, 3, 0))
    # steps too small leave a direction of zero below 64 bits: a floor
    a_k = a_star
    if torch.finfo(a_k.dtype).bits != 64:
        a_k = torch.where(a_k.abs() < 1e-8, torch.sign(a_k) * 1e-8, a_k)
    return failed | ~done, status, a_k, phi_star, g_star


def minimize_bfgs(fun_and_grad, x0, maxiter=None, gtol: float = 1e-5,
                  line_search_maxiter: int = 10) -> BFGSResult:
    """Minimise B independent functions by BFGS, all rows in lock step.

    ``fun_and_grad(x [B, K]) -> (f [B], g [B, K])`` evaluates every row's
    function and gradient in one batched call. ``x0`` [B, K]; ``maxiter``
    BFGS iterations a row (None: 200 K, as JAX); a row converges when the
    largest absolute entry of its gradient is below ``gtol``. Each row
    gets the iterates, status and iteration count of JAX's
    `minimize_bfgs` on that row alone."""
    B, K = x0.shape
    if maxiter is None:
        maxiter = 200 * K
    n_evals = 0

    def evaluate(x):
        nonlocal n_evals
        n_evals += 1
        f, g = fun_and_grad(x)
        return f.to(x0.dtype), g.to(x0.dtype)

    eye = torch.eye(K, dtype=x0.dtype, device=x0.device)
    x_k = x0
    f_k, g_k = evaluate(x0)
    H_k = eye.expand(B, K, K)
    converged = g_k.abs().amax(-1) < gtol
    failed = torch.zeros_like(converged)
    k = torch.zeros(B, dtype=torch.int64, device=x0.device)
    ls_status = torch.zeros_like(k)
    old_old_fval = f_k + torch.linalg.vector_norm(g_k, dim=-1) / 2
    while True:
        active = ~converged & ~failed & (k < maxiter)
        if not bool(active.any()):
            break
        p_k = -(H_k @ g_k[..., None])[..., 0]
        ls_failed, status, a_k, f_kp1, g_kp1 = _line_search(
            evaluate, x_k, p_k, f_k, old_old_fval, g_k, active,
            line_search_maxiter)
        s_k = a_k[:, None] * p_k
        y_k = g_kp1 - g_k
        rho_k = 1.0 / (y_k * s_k).sum(-1)
        w = eye - rho_k[:, None, None] * (s_k[:, :, None] * y_k[:, None, :])
        H_kp1 = w @ H_k @ w.transpose(-1, -2) + \
            rho_k[:, None, None] * s_k[:, :, None] * s_k[:, None, :]
        H_kp1 = torch.where(torch.isfinite(rho_k)[:, None, None], H_kp1, H_k)

        failed = torch.where(active, ls_failed, failed)
        ls_status = torch.where(active, status, ls_status)
        converged = torch.where(active, g_kp1.abs().amax(-1) < gtol,
                                converged)
        k = torch.where(active, k + 1, k)
        x_k = torch.where(active[:, None], x_k + s_k, x_k)
        old_old_fval = torch.where(active, f_k, old_old_fval)
        f_k = torch.where(active, f_kp1, f_k)
        g_k = torch.where(active[:, None], g_kp1, g_k)
        H_k = torch.where(active[:, None, None], H_kp1, H_k)

    status = torch.where(converged, 0, torch.where(
        k == maxiter, 1, torch.where(failed, 2 + ls_status, -1)))
    return BFGSResult(x_k, f_k, g_k, status, k, n_evals)
