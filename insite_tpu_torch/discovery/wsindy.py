"""Weak-form SINDy (A-WSINDy): integrate the candidate library against
compactly supported test functions, so no derivative estimate is needed.

Weak form on a window [a, b] with phi(a) = phi(b) = 0:
    integral(phi * x') = -integral(phi' * x)
so each (trajectory, window) pair gives one linear equation
    -<phi', x> = sum_j c_j <phi, theta_j(x)>.
The window integrals of every trajectory at once are two contractions
against precomputed quadrature weights, on the device of the tensors; the
sparse solve and the candidate selection run on the host in float64.

The per-seed path of `insite_tpu.discovery.wsindy`: `_test_functions`,
`_hat_weights`, `weak_system`, `weak_system_segments`, `weak_stlsq_host`
(one pair of `weak_candidates_host`, the solve over a grid) and
`weak_select_host`; `weak_sindy_fit_select`, the threshold-grid fit
of the vectorized seed columns, on the same host pieces; and
`weak_sindy_fit`, one threshold by that host STLSQ or by `sr3_l1`, the
SR3 relax-and-split solve on the device. The window starts
come from numpy's `RandomState`, so a seed gives the JAX package's
windows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _test_functions(n_windows: int, window_len: int, t_len: int, seed=0,
                    p: int = 2, all_starts: bool = False):
    """phi and phi' sampled on the grid for K windows placed over
    [0, t_len). Returns (starts [K], phi [K, w], dphi [K, w]) in grid
    units.

    ``all_starts=True`` places one window at every grid start (K =
    t_len - window_len + 1; n_windows and seed are ignored): needed when a
    constant-treatment-segment mask decides per (trajectory, window) which
    windows count. ``p`` is the exponent of phi = (1 - s^2)^p; windows of 3
    or 4 points need p = 1 (with p = 2, phi' vanishes at every grid point
    of a 3-point window)."""
    if all_starts:
        starts = np.arange(max(t_len - window_len + 1, 1))
        n_windows = len(starts)
    else:
        rng = np.random.RandomState(seed)
        starts = rng.randint(0, max(t_len - window_len, 1), size=n_windows)
    s = np.linspace(-1.0, 1.0, window_len)
    phi = (1 - s ** 2) ** p
    dphi_ds = -2 * p * s * (1 - s ** 2) ** (p - 1)
    # d/dt = d/ds * ds/dt, ds/dt = 2 / (window_len - 1 grid steps)
    scale = 2.0 / (window_len - 1)
    phi_k = np.broadcast_to(phi, (n_windows, window_len))
    dphi_k = np.broadcast_to(dphi_ds * scale, (n_windows, window_len))
    return starts, phi_k, dphi_k


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """The trapezoid sum of `np.trapezoid(y, x)` (numpy >= 2.0 only),
    with its arithmetic: sum(dx * (y[1:] + y[:-1]) / 2)."""
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


@functools.lru_cache(maxsize=None)
def _hat_weights(window_len: int, p: int):
    """Exact quadrature weights for the weak integrals against the
    piecewise-linear interpolant of the grid samples.

    W[i] = integral(phi(s) * hat_i(s) ds) and Wd[i] = integral(phi'(s) *
    hat_i(s) ds), on a fine grid (float64, host), so that sum_i g_i * W[i]
    is exact for any piecewise-linear g; sampling phi at the grid and
    applying the trapezoid rule is biased on coarse windows (at 3 points,
    p = 1, every recovered coefficient doubles).

    Returns (W [w], Wd [w]) in s units over [-1, 1]:
      integral(phi * g dt)    = (window_len - 1) * dt / 2 * sum_i g_i W[i]
      integral(phi'_t * g dt) = sum_i g_i Wd[i]   (ds/dt and dt/ds cancel)
    """
    M = 4001
    s = np.linspace(-1.0, 1.0, M)
    phi = (1 - s ** 2) ** p
    dphi = -2 * p * s * (1 - s ** 2) ** (p - 1)
    h = 2.0 / (window_len - 1)
    nodes = np.linspace(-1.0, 1.0, window_len)
    W = np.zeros(window_len)
    Wd = np.zeros(window_len)
    for i, si in enumerate(nodes):
        hat = np.clip(1.0 - np.abs(s - si) / h, 0.0, None)
        W[i] = _trapezoid(phi * hat, s)
        Wd[i] = _trapezoid(dphi * hat, s)
    W.flags.writeable = Wd.flags.writeable = False
    return W, Wd


def weak_system(volumes, statics, lengths, library, dt,
                n_windows: int = 100, window_len: int = 30,
                trajectory_mask=None, seed: int = 0,
                step_arms=None, arm=None, all_starts: bool = False,
                p: int = 2):
    """The flattened weak-form linear system (A [B*K, F], b [B*K],
    sample_weight [B*K]), on the device of ``volumes``.

    volumes: [B, T] padded; statics: [B, S] (whatever the library takes
    beside the state, constant along a trajectory); lengths: [B] valid
    volume points (a window [s, s+w) is kept iff s + w <= lengths).
    trajectory_mask: [B] bool, the trajectories that feed this system
    (EQ_4: a whole trajectory runs one arm). step_arms / arm: [B, T-1]
    integer arm per transition and the target arm; a window is kept iff
    every transition it spans (s .. s+w-2) ran ``arm`` (tumor family:
    trajectories are chains of short constant-treatment segments).
    all_starts / p: see `_test_functions`.
    """
    B, T = volumes.shape
    dev, dtype = volumes.device, volumes.dtype
    window_len = min(window_len, T)
    starts_np, _, _ = _test_functions(n_windows, window_len, T, seed=seed,
                                      p=p, all_starts=all_starts)
    n_windows = len(starts_np)
    starts = torch.as_tensor(starts_np, dtype=torch.int64, device=dev)
    # the phi weight carries the dt-measure factor; the phi' weight needs
    # none
    W_np, Wd_np = _hat_weights(window_len, p)
    wphi = torch.as_tensor(W_np * ((window_len - 1) * dt / 2.0), dtype=dtype,
                           device=dev)
    wdphi = torch.tensor(Wd_np, dtype=dtype, device=dev)

    # windows fully inside the valid region only
    ok_win = (starts[None, :] + window_len) <= lengths[:, None]     # [B, K]
    if trajectory_mask is not None:
        ok_win = ok_win & trajectory_mask[:, None]
    if step_arms is not None:
        if step_arms.ndim != 2:
            raise ValueError(
                'weak_system takes step_arms as an integer arm per '
                f'transition, [B, T-1]; got shape {tuple(step_arms.shape)} '
                '(multilabel treatment columns have no single arm)')
        # transitions spanned by the volume window [s, s+w): s .. s+w-2
        tr_idx = torch.clamp(
            starts[:, None] + torch.arange(window_len - 1, device=dev)[None],
            0, step_arms.shape[1] - 1)                              # [K, w-1]
        ok_win = ok_win & (step_arms[:, tr_idx] == arm).all(dim=-1)

    idx = starts[:, None] + torch.arange(window_len, device=dev)[None]
    x_win = volumes[:, idx]                                         # [B,K,w]
    X = torch.cat(
        [x_win[..., None],
         statics[:, None, None, :].expand(B, n_windows, window_len,
                                          statics.shape[-1])], dim=-1)
    theta = library(X)                                              # [B,K,w,F]

    lhs = -torch.einsum('bkw,w->bk', x_win, wdphi)
    rhs = torch.einsum('bkwf,w->bkf', theta, wphi)
    return (rhs.reshape(-1, rhs.shape[-1]), lhs.reshape(-1),
            ok_win.reshape(-1).to(dtype))


def weak_system_segments(volumes, statics, n_volume_points, library, dt,
                         step_arms, arm, window_lens=(8, 5, 3)):
    """Multi-scale weak system for one arm of a segmented trajectory
    (tumor family): constant-treatment segments are 1-11 steps long, so
    one all-starts weak system per window scale, each window kept only
    when every transition it spans ran ``arm``, stacked into one (A, b, w).
    Scales of at most 4 points use the p = 1 test function.

    n_volume_points: [B] valid volume samples per trajectory
    (sequence_lengths + 1: that many transitions pair one more point)."""
    parts = [weak_system(volumes, statics, n_volume_points, library, dt,
                         window_len=int(w), all_starts=True,
                         step_arms=step_arms, arm=arm,
                         p=(1 if w <= 4 else 2))
             for w in window_lens]
    return tuple(torch.cat([part[i] for part in parts]) for i in range(3))


def _normal_equations(A, b, sample_weight):
    """What the solves of one weak system share, float64: the Gram matrix
    and right-hand side of the unit-norm columns (G, rhs) and of the raw
    columns (Gw, rhs_raw)."""
    w64 = np.asarray(sample_weight, np.float64)
    A64 = np.asarray(A, np.float64) * w64[:, None]
    b64 = np.asarray(b, np.float64) * w64
    norms = np.sqrt((A64 * A64).sum(0))
    norms[norms == 0] = 1.0
    An = A64 / norms
    bn = b64 / max(np.linalg.norm(b64), 1e-300)
    return An.T @ An, An.T @ bn, A64.T @ A64, A64.T @ b64


def _stlsq_on(normal, threshold, alpha, max_iter, refit_ridge=1e-12):
    G, rhs, Gw, rhs_raw = normal
    F = G.shape[0]
    eye = np.eye(F)
    mask = np.ones(F, bool)
    for _ in range(max_iter):
        m = mask.astype(np.float64)
        Gm = G * np.outer(m, m) + np.diag(1.0 - m) + alpha * eye
        c = np.linalg.solve(Gm, rhs * m)
        mask = np.abs(c) > threshold
    m = mask.astype(np.float64)
    Gr = Gw * np.outer(m, m) + np.diag(1.0 - m) + \
        refit_ridge * np.trace(Gw) / F * eye
    c_raw = np.linalg.solve(Gr, rhs_raw * m)
    return np.where(mask, c_raw, 0.0)


def weak_candidates_host(A, b, sample_weight, thresholds, alphas,
                         max_iter: int = 20, refit_ridge: float = 1e-12):
    """One sparse solve of the weak system per (threshold, alpha) pair,
    [G, F], from one set of normal equations: sequential hard thresholding
    in correlation units, then an unbiased raw-space refit on the support;
    numpy float64 on the host (the whitened normal equations are too
    ill-conditioned for float32).

    Columns and b are scaled to unit norm, so the ridge ``alpha`` and the
    threshold are scale-free: the weak system's time-constant columns are
    near-parallel, and a plain least squares puts large cancelling
    coefficients on them. The refit's ridge is ``refit_ridge`` times the
    mean diagonal of the raw normal matrix."""
    normal = _normal_equations(A, b, sample_weight)
    return np.stack([_stlsq_on(normal, t, al, max_iter, refit_ridge)
                     for t, al in zip(thresholds, alphas)])


def weak_stlsq_host(A, b, sample_weight, threshold, alpha: float = 0.5,
                    max_iter: int = 20):
    """`weak_candidates_host` for one (threshold, alpha) pair: [F]."""
    return weak_candidates_host(A, b, sample_weight, [threshold], [alpha],
                                max_iter)[0]


def weak_select_host(cands, flat_theta, flat_y, sample_w,
                     select_tol: float = 0.05):
    """Candidate selection on the host: the sparsest model whose
    strong-form training residual is within ``select_tol`` of the best;
    among equal supports the later grid index (the larger threshold, then
    the smaller alpha); an all-zero candidate only if no other is
    admissible. Returns (coefficients [F], index)."""
    cands = np.asarray(cands, np.float64)              # [G, F]
    th = np.asarray(flat_theta, np.float64)
    y = np.asarray(flat_y, np.float64)
    w = np.asarray(sample_w, np.float64)
    resid = th @ cands.T - y[:, None]
    rmse = np.sqrt((resid * resid * w[:, None]).sum(0) / max(w.sum(), 1.0))
    nnz = (np.abs(cands) > 1e-12).sum(-1)
    admissible = rmse <= rmse.min() * (1.0 + select_tol)
    G = len(cands)
    order = np.lexsort((-np.arange(G), np.where(nnz > 0, nnz, 10**9)))
    g = next(int(i) for i in order if admissible[i])
    return cands[g], g


def weak_sindy_fit_select(volumes, statics, lengths, library, dt,
                          thresholds, flat_theta, flat_y, sample_w,
                          alphas=None, select_tol: float = 0.05,
                          n_windows: int = 100, window_len: int = 30,
                          trajectory_mask=None, seed: int = 0):
    """`insite_tpu.discovery.wsindy.weak_sindy_fit_select`: the weak
    system of one arm (float64 on the tensors' device), one sparse solve
    per (threshold, alpha) of the grid and the strong-form selection over
    this arm's design (``flat_theta`` [N, F], ``flat_y`` [N], ``sample_w``
    [N]), in float64 on the host. ``alphas`` default to 0.5. The refit's
    ridge is the JAX function's, 1e-8 of the mean diagonal. Returns numpy
    coefficients [F]."""
    A, b, w = weak_system(volumes.double(), statics.double(), lengths,
                          library, dt, n_windows=n_windows,
                          window_len=window_len,
                          trajectory_mask=trajectory_mask, seed=seed)
    thresholds = np.asarray(thresholds, np.float64)
    alphas = (np.full_like(thresholds, 0.5) if alphas is None
              else np.asarray(alphas, np.float64))
    cands = weak_candidates_host(A.cpu().numpy(), b.cpu().numpy(),
                                 w.cpu().numpy(), thresholds, alphas,
                                 refit_ridge=1e-8)
    return weak_select_host(cands, flat_theta.cpu().numpy(),
                            flat_y.cpu().numpy(), sample_w.cpu().numpy(),
                            select_tol=select_tol)[0]


def weak_sindy_fit(volumes, statics, lengths, library, dt,
                   threshold: float, n_windows: int = 100,
                   window_len: int = 30, sr3_iters: int = 1000,
                   trajectory_mask=None, seed: int = 0,
                   solver: str = 'stlsq'):
    """`insite_tpu.discovery.wsindy.weak_sindy_fit`: the weak system of
    one arm (float64 on the tensors' device) solved at one threshold, by
    the host STLSQ of `weak_candidates_host` (ridge 0.5, the refit ridge
    1e-8 of the mean diagonal, as the JAX `weak_stlsq`) or, with
    ``solver='sr3'``, by `sr3_l1` on the device. Returns numpy
    coefficients [F], float64."""
    if solver not in ('stlsq', 'sr3'):
        raise ValueError(f"solver={solver!r}; expected 'stlsq' or 'sr3'")
    A, b, w = weak_system(volumes.double(), statics.double(), lengths,
                          library, dt, n_windows=n_windows,
                          window_len=window_len,
                          trajectory_mask=trajectory_mask, seed=seed)
    if solver == 'sr3':
        return sr3_l1(A, b, w, threshold, max_iter=sr3_iters).cpu().numpy()
    return weak_candidates_host(A.cpu().numpy(), b.cpu().numpy(),
                                w.cpu().numpy(), [threshold], [0.5],
                                refit_ridge=1e-8)[0]


def sr3_l1(A, b, sample_weight, threshold: float, nu: float = 1.0,
           max_iter: int = 1000):
    """SR3 with l1 relax-and-split (pysindy ``SR3(thresholder='l1',
    normalize_columns=True)``): minimise
        0.5 ||b - A w||^2 + threshold |u|_1 + (0.5 / nu) ||w - u||^2
    over the weighted rows with unit-norm columns, ``max_iter`` steps of
    (w: one solve with the Cholesky factor of G + I / nu, taken once;
    u: soft thresholding of w), then an unbiased refit on u's support and
    the columns' scale undone. In float64 on the device of ``A``, whatever
    its dtype, as the weak systems are (`models/sindy.py::
    _weak_precision`). A [N, F], b [N], sample_weight [N] -> [F]."""
    A, b, wgt = A.double(), b.double(), sample_weight.double()
    Aw = A * wgt[:, None]
    norms = torch.sqrt((Aw * Aw).sum(0))
    norms = torch.where(norms > 0, norms, 1.0)
    An = Aw / norms[None, :]
    bw = b * wgt
    G = An.T @ An
    rhs0 = An.T @ bw
    F = A.shape[1]
    eye = torch.eye(F, dtype=A.dtype, device=A.device)
    chol = torch.linalg.cholesky(G + (1.0 / nu) * eye)
    u = torch.cholesky_solve(
        rhs0[:, None], torch.linalg.cholesky(G + 1e-10 * eye))[:, 0]
    for _ in range(max_iter):
        w = torch.cholesky_solve((rhs0 + u / nu)[:, None], chol)[:, 0]
        u = torch.sign(w) * torch.clamp(w.abs() - threshold * nu, min=0.0)
    support = u.abs() > 1e-12
    m = support.to(A.dtype)
    Gm = G * torch.outer(m, m) + torch.diag(1.0 - m) + 1e-12 * eye
    coef = torch.linalg.solve(Gm, rhs0 * m)
    return torch.where(support, coef, 0.0) / norms
