"""Plain reference of INSITE on the EQ_4 PKPD family (one-compartment
decay, the arm switching the decay constant), written from the model's
equations and the paper's method, in plain PyTorch and numpy.

It imports nothing of the program. Every function takes a compute
``dtype``: float64 for the reference itself, bfloat16 for the
lower-precision control. Operations that PyTorch offers in no bfloat16
form (the linear solves) run in float32 on operands rounded to bfloat16,
and their results are rounded back.

Layers:

- `simulate`: the factual cohort of a seed, drawn from a
  ``torch.Generator`` on the given device in the program's draw order and
  draw type, then integrated by explicit Euler sub-steps.
- `fit`: smoothed fourth-order finite differences, the degree-2
  interaction-only library over ``[y, c0, c1]`` and one sequentially
  thresholded ridge regression per arm with the unbiased refit.
- `finetune`: the per-patient Levenberg-Marquardt fine-tune of the active
  coefficients, its Jacobian from the forward sensitivities of the Euler
  rollout, and the fine-tuned rollout.
- `factual_rmse`: the normalised factual RMSEs in %.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

MAX_VALUE = 50.0
MAX_TIME_HORIZON = 10.0
SUBSTEPS = 5
OBSERVATION_NOISE = 0.01
RECOVERY_MULTIPLIER = 5.8e11
EDGE = 1e-5
VARIANTS = ('EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')


def _solve(A, b, dtype):
    """``A x = b`` batched, without raising: a singular system gives a
    non-finite row. bfloat16 operands are solved in float32 and the result
    rounded to bfloat16."""
    if dtype == torch.bfloat16:
        return torch.linalg.solve_ex(A.float(), b.float())[0].to(dtype)
    return torch.linalg.solve_ex(A.to(dtype), b.to(dtype))[0]


def _lstsq(A, b, dtype):
    if dtype == torch.bfloat16:
        return torch.linalg.lstsq(A.float().cpu(), b.float().cpu()
                                  ).solution.to(dtype).to(A.device)
    return torch.linalg.lstsq(A.cpu(), b.cpu()).solution.to(A.device)


# ---------------------------------------------------------------------------
# collection

def simulate(n: int, seed: int, variant: str = 'EQ_4_D',
             conf_coeff: float = 2.0, seq_length: int = 60, *, device,
             dtype=torch.float64, draw_dtype=torch.float32,
             with_edges: bool = False):
    """The factual cohort: (volumes [n, T], statics [n, 2], treatment
    [n, T] (the arm, then 0 in the last column), lengths [n]). The
    patients' constants, the recovery uniforms, the treatment uniforms and
    the observation noise are drawn in this order from a generator seeded
    with ``seed``, in ``draw_dtype``, as the program draws them. A patient
    recovers (volume 0 from then on) at the first step whose recovery
    uniform falls below exp(-volume x 5.8e11), and dies (volume held at
    the threshold) at the first step above it. With ``with_edges`` also a
    mask [n] of the patients whose arm or length rests on a comparison
    within `EDGE` (relative) of its threshold, where rounding in the
    program's type may decide either way."""
    if variant not in VARIANTS:
        raise ValueError(f'EQ_4 variant {variant!r}')
    gen, s, k, v0 = _patients(n, seed, variant, device, dtype, draw_dtype)
    T = seq_length
    recovery = torch.rand((n, T), generator=gen, device=device,
                          dtype=draw_dtype).to(dtype)
    arm, edge = _arm(gen, v0, conf_coeff, draw_dtype)
    rows = torch.arange(n, device=device)
    vol = torch.cat([v0[:, None], _euler(v0, k[rows, arm],
                                         MAX_TIME_HORIZON / T, T - 1)], 1)
    t = torch.arange(T, device=device)
    lengths = torch.full((n,), T - 1, dtype=torch.int64, device=device)
    first = _first(recovery < torch.exp(-vol * RECOVERY_MULTIPLIER))
    lengths = torch.where(first < T, first + 1, lengths)
    vol = torch.where(t[None] >= first[:, None], 0.0, vol)
    edge = edge | ((vol - MAX_VALUE).abs() < EDGE * MAX_VALUE).any(1)
    first = _first(vol > MAX_VALUE)
    lengths = torch.where(first < T, first + 1, lengths)
    vol = torch.where(t[None] >= first[:, None], MAX_VALUE, vol)
    vol = _noisy(vol, gen, variant, draw_dtype)
    treat = torch.zeros((n, T), dtype=dtype, device=device)
    treat[:, :T - 1] = arm[:, None].to(dtype)
    cohort = (vol, s, treat, lengths)
    return cohort + (edge,) if with_edges else cohort


def _first(cond):
    """Index of the first True of each row, or the row's width."""
    T = cond.shape[1]
    idx = torch.arange(T, device=cond.device).expand_as(cond)
    return torch.where(cond, idx, T).min(dim=1).values


# ---------------------------------------------------------------------------
# library and fit

def exponents(n_inputs: int, degree: int = 2,
              interaction_only: bool = True) -> np.ndarray:
    """Exponent table [F, n_inputs]: the constant, then the inputs, then
    the products of each degree in lexicographic order of the inputs."""
    rows = [np.zeros(n_inputs, np.int64)]
    comb = (itertools.combinations if interaction_only
            else itertools.combinations_with_replacement)
    for deg in range(1, degree + 1):
        for idx in comb(range(n_inputs), deg):
            e = np.zeros(n_inputs, np.int64)
            np.add.at(e, list(idx), 1)
            rows.append(e)
    return np.stack(rows)


def features(X, exps: np.ndarray):
    """X [..., n_inputs] -> [..., F]: the product of X_i ** e_i."""
    out = []
    for e in exps:
        f = torch.ones_like(X[..., 0])
        for i, p in enumerate(e):
            for _ in range(int(p)):
                f = f * X[..., i]
        out.append(f)
    return torch.stack(out, dim=-1)


def _window_weights(window: int, polyorder: int, deriv: int) -> np.ndarray:
    """W[r, k]: weight of sample k of a unit-spaced window for the value
    (deriv 0) or first derivative (deriv 1) at in-window position r of the
    least-squares polynomial of degree ``polyorder`` through the window."""
    x = np.arange(window, dtype=np.float64)
    V = np.vander(x, polyorder + 1, increasing=True)          # [w, p+1]
    pinv = np.linalg.pinv(V)                                   # [p+1, w]
    if deriv == 0:
        return V @ pinv
    powers = np.arange(polyorder + 1)
    dV = powers * np.where(powers > 0, x[:, None] ** np.maximum(powers - 1,
                                                                 0), 0.0)
    return dV @ pinv


def _windowed(x, lengths, W):
    """For each position j of each row, W[j - s] applied to x[s:s+w] with
    the window start s = clip(j - (w-1)//2, 0, max(length, w) - w)."""
    w = W.shape[0]
    B, T = x.shape
    j = torch.arange(T, device=x.device)[None]
    top = torch.clamp(lengths, min=w)[:, None] - w
    s = torch.minimum(torch.clamp(j - (w - 1) // 2, min=0), top)
    r = torch.clamp(j - s, max=w - 1)
    Wt = torch.as_tensor(W, device=x.device).to(x.dtype)
    out = torch.zeros_like(x)
    for k in range(w):
        out = out + torch.gather(x, 1, torch.clamp(s + k, max=T - 1)) * \
            Wt[r, k]
    return out


def derivative(vol, lengths, dt):
    """Savitzky-Golay smoothing (window 5, cubic, polynomial edges), then
    the fourth-order finite difference (5-point stencils, one-sided at the
    edges): dy/dt [B, T]; entries at or past ``lengths`` are not used."""
    smooth = _windowed(vol, lengths, _window_weights(5, 3, 0))
    return _windowed(smooth, lengths, _window_weights(5, 4, 1)) / dt


def stlsq(X, y, threshold: float, alpha: float, dtype, max_iter: int = 100):
    """Sequentially thresholded ridge regression with the unbiased refit:
    coefficients [F] (0 off the support)."""
    F = X.shape[1]
    gram = (X.T @ X).to(dtype)
    rhs = (X.T @ y).to(dtype)
    eye = torch.eye(F, dtype=dtype, device=X.device)
    mask = torch.ones(F, dtype=torch.bool, device=X.device)
    coefs = torch.zeros(F, dtype=dtype, device=X.device)
    for _ in range(max_iter):
        if not mask.any():
            break
        idx = mask.nonzero()[:, 0]
        c = _solve(gram[idx][:, idx] + alpha * eye[:len(idx), :len(idx)],
                   rhs[idx], dtype)
        full = torch.zeros(F, dtype=dtype, device=X.device)
        full[idx] = c
        new = (full.abs() >= threshold) & mask
        coefs = torch.where(new, full, 0.0)
        done = bool((new == mask).all())
        mask = new
        if done:
            break
    if mask.any():
        idx = mask.nonzero()[:, 0]
        c = _lstsq(X[:, idx], y[:, None], dtype)[:, 0]
        coefs = torch.zeros(F, dtype=dtype, device=X.device)
        coefs[idx] = c
    return coefs


def design(vol, statics, treat, lengths, dt, dtype):
    """(theta [N, F], dy/dt [N], arm [N]) over the samples t < max(L - 1,
    2) of every patient, L its length."""
    vol, statics = vol.to(dtype), statics.to(dtype)
    eff = torch.clamp(lengths - 1, min=2)
    B, T = vol.shape
    xdot = derivative(vol, eff, dt)
    X = torch.cat([vol[..., None], statics[:, None, :].expand(B, T, -1)], -1)
    theta = features(X, exponents(1 + statics.shape[1]))
    ok = torch.arange(T, device=vol.device)[None] < eff[:, None]
    arm = treat[:, :1].to(torch.int64).expand(B, T)
    return theta[ok], xdot[ok], arm[ok]


def fit(vol, statics, treat, lengths, threshold: float, alpha: float,
        seq_length: int = 60, dtype=torch.float64, n_arms: int = 2,
        max_iter: int = 100):
    """Global coefficients [n_arms, F], one regression per arm."""
    theta, xdot, arm = design(vol, statics, treat, lengths,
                              MAX_TIME_HORIZON / seq_length, dtype)
    return torch.stack([stlsq(theta[arm == a], xdot[arm == a], threshold,
                              alpha, dtype, max_iter)
                        for a in range(n_arms)])


# ---------------------------------------------------------------------------
# prediction

def collapse(coefs, statics, exps: np.ndarray):
    """The model as a polynomial in y per row and arm: coefs [1 or B, A,
    F] over features y^e0 * g(statics) -> [B, A, D + 1], the coefficient
    of y^k at k, D the largest exponent of y."""
    B = statics.shape[0]
    D = int(exps[:, 0].max())
    g = features(torch.cat([torch.ones_like(statics[:, :1]), statics], 1),
                 np.concatenate([np.zeros_like(exps[:, :1]), exps[:, 1:]],
                                1))                              # [B, F]
    onehot = torch.as_tensor(
        (exps[:, 0][:, None] == np.arange(D + 1)[None]).astype(np.float64),
        device=statics.device).to(statics.dtype)                  # [F, D+1]
    return (coefs.expand(B, *coefs.shape[1:]) * g[:, None, :]) @ onehot


def rollout(coefs, y0, statics, arms, dt, exps, y_clip=None):
    """Explicit Euler with SUBSTEPS sub-steps a step of dy/dt = c[arm] .
    theta(y, statics), evaluated by Horner's rule on the polynomial in y
    (`collapse`); coefs [1 or B, A, F], arms [B, T]; with ``y_clip`` (lo,
    hi) the state is clipped after each step: [B, T] states after each
    step."""
    B, T = arms.shape
    h = dt / SUBSTEPS
    poly = collapse(coefs, statics, exps)                        # [B, A, D+1]
    rows = torch.arange(B, device=y0.device)
    y = y0
    out = []
    for t in range(T):
        p = poly[rows, arms[:, t]]                               # [B, D+1]
        for _ in range(SUBSTEPS):
            dy = p[:, -1]
            for k in range(p.shape[1] - 2, -1, -1):
                dy = dy * y + p[:, k]
            y = y + h * dy
        if y_clip is not None:
            y = torch.clamp(y, y_clip[0], y_clip[1])
        out.append(y)
    return torch.stack(out, dim=1)


def rollout_sens(coefs, y0, statics, arms, dt, exps, active, y_clip=None):
    """`rollout` and the forward sensitivities of its states to the flat
    (arm x F + feature) coefficients ``active``: ([B, T], [B, T, Kr]).
    Differentiating the Euler step y + h p(y) gives s + h (p'(y) s +
    dp/dc) at the state before the step; dp/dc_j is y^e * g_j(statics)
    on the rows whose arm at the step is coordinate j's, 0 elsewhere; a
    clipped state has sensitivity 0."""
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    h = dt / SUBSTEPS
    poly = collapse(coefs, statics, exps)                        # [B, A, D+1]
    D = poly.shape[-1] - 1
    g = features(torch.cat([torch.ones_like(statics[:, :1]), statics], 1),
                 np.concatenate([np.zeros_like(exps[:, :1]), exps[:, 1:]],
                                1))                              # [B, F]
    act = np.asarray(active, np.int64)
    act_arm = torch.as_tensor(act // F, device=y0.device)
    g_act = g[:, torch.as_tensor(act % F, device=y0.device)]      # [B, Kr]
    e_act = torch.as_tensor(exps[act % F, 0], device=y0.device)   # [Kr]
    k_pow = torch.arange(1, D + 1, device=y0.device)
    rows = torch.arange(B, device=y0.device)
    y = y0
    sens = y0.new_zeros(B, len(act))
    ys, ss = [], []
    for t in range(T):
        p = poly[rows, arms[:, t]]                               # [B, D+1]
        on = (arms[:, t][:, None] == act_arm[None]).to(y.dtype)   # [B, Kr]
        for _ in range(SUBSTEPS):
            powers = y[:, None] ** torch.arange(D + 1, device=y.device)
            f = (p * powers).sum(1)
            dfdy = (p[:, 1:] * k_pow * powers[:, :-1]).sum(1)
            drive = on * g_act * y[:, None] ** e_act[None]
            sens = sens + h * (dfdy[:, None] * sens + drive)
            y = y + h * f
        if y_clip is not None:
            inside = (y > y_clip[0]) & (y < y_clip[1])
            y = torch.clamp(y, y_clip[0], y_clip[1])
            sens = torch.where(inside[:, None], sens, 0.0)
        ys.append(y)
        ss.append(sens)
    return torch.stack(ys, dim=1), torch.stack(ss, dim=1)


def finetune(prev, statics, arms, lengths, global_coefs, lam: float,
             gn_iters: int = 12, projection_horizon: int = 1,
             dt: float = MAX_TIME_HORIZON / 60, dtype=torch.float64,
             y_clip=None, with_coefs: bool = False):
    """INSITE's per-patient fine-tune and prediction: preds [B, T], the
    state after each step from y0 = prev[:, 0]; prev [B, T] the observed
    states, arms [B, T] the arm of each step; global_coefs [A, F], or
    [B, A, F] a global model a row. With ``with_coefs`` also each row's
    model [B, A, F].

    The coordinates moved are those where any row's |global| > 1e-3; a
    row moves only its own (the others keep a zero Jacobian and stay out of
    its model). A row fits its first L - horizon one-step errors,
    minimising
        sum r^2 / (2.5 n mse0) + (lam / K) |c - g|^2
    (mse0 the global model's mean squared error on those steps, n their
    number, K = arms x features) by Levenberg-Marquardt from c = g: each
    iteration evaluates the pending step, keeps it if it lowers the
    objective (the damping then shrinks x0.3, else grows x10, inside
    [1e-8, 1e8], from 1e-3), and solves for the next step from the best
    point's Jacobian. Rows with L <= horizon keep the global model."""
    dev = prev.device
    prev, statics = prev.to(dtype), statics.to(dtype)
    g = torch.as_tensor(global_coefs, device=dev).to(dtype)
    g = g if g.ndim == 3 else g[None]                        # [1 or B, A, F]
    A, F = g.shape[1:]
    K = A * F
    exps = exponents(1 + statics.shape[1])
    B, T = prev.shape
    arms = arms.to(torch.int64)
    ph = projection_horizon
    keep = (g.abs() > 1e-3).reshape(-1, K).to(dtype)         # [1 or B, K]
    act = np.flatnonzero(keep.cpu().bool().numpy().any(0))
    skip = (lengths <= ph)[:, None, None]

    def done(coefs):
        preds = rollout(coefs, prev[:, 0], statics, arms, dt, exps, y_clip)
        return (preds, coefs.expand(B, A, F)) if with_coefs else preds

    if len(act) == 0:
        return done(torch.where(skip, g, g * keep.reshape(-1, A, F)))
    idx = torch.as_tensor(act, device=dev)
    P = torch.zeros((len(act), K), dtype=dtype, device=dev)
    P[torch.arange(len(act)), idx] = 1.0
    g_red = g.reshape(-1, K)[:, idx]                         # [1 or B, Kr]
    own = keep[:, idx]                                        # [1 or B, Kr]

    def model(c_red):                                         # [B, A, F]
        return ((c_red @ P) * keep).reshape(-1, A, F)

    prefix = torch.arange(T - 1, device=dev)[None] < (lengths - ph)[:, None]
    n = torch.clamp(prefix.sum(1).to(dtype), min=1.0)

    def resid_jac(c_red):
        """One-step errors r = prev[t + 1] - y_t on the fitted steps, 0
        elsewhere, and their Jacobian J = dr/dc = -sensitivities."""
        y, sens = rollout_sens(model(c_red), prev[:, 0], statics, arms, dt,
                               exps, act, y_clip)
        r = torch.where(prefix, prev[:, 1:] - y[:, :-1], 0.0)
        J = torch.where(prefix[..., None], -sens[:, :-1], 0.0)
        return r, J * own[:, None, :]

    reg = lam / K
    Kr = len(act)
    eye = torch.eye(Kr, dtype=dtype, device=dev)
    c0 = g_red.expand(B, Kr).clone()
    r0, J0 = resid_jac(c0)
    mse0 = (r0 ** 2).sum(1) / n
    w = 1.0 / torch.sqrt(2.5 * torch.clamp(mse0, min=1e-30) * n)

    def objective(r, c):
        return ((r * w[:, None]) ** 2).sum(1) + reg * ((c - g_red) ** 2
                                                      ).sum(1)

    def step(r, J, c, mu):
        Jw = J * w[:, None, None]
        H = Jw.transpose(1, 2) @ Jw + (reg + mu)[:, None, None] * eye
        grad = (Jw.transpose(1, 2) @ (r * w[:, None])[..., None])[..., 0] \
            + reg * (c - g_red)
        return c - _solve(H, grad[..., None], dtype)[..., 0]

    best, r_b, J_b, obj_b = c0, r0, J0, objective(r0, c0)
    mu = torch.full((B,), 1e-3, dtype=dtype, device=dev)
    cand = step(r_b, J_b, best, mu)
    for _ in range(gn_iters):
        r_c, J_c = resid_jac(cand)
        obj_c = objective(r_c, cand)
        better = torch.isfinite(obj_c) & (obj_c < obj_b)
        best = torch.where(better[:, None], cand, best)
        obj_b = torch.where(better, obj_c, obj_b)
        r_b = torch.where(better[:, None], r_c, r_b)
        J_b = torch.where(better[:, None, None], J_c, J_b)
        mu = torch.clamp(torch.where(better, mu * 0.3, mu * 10.0), 1e-8, 1e8)
        cand = step(r_b, J_b, best, mu)
    return done(torch.where(skip, g, model(best)))


def factual_rmse(preds, vol, lengths, dtype=torch.float64):
    """(orig, all) normalised factual RMSEs in %: orig the root of the mean
    over steps of each step's mean squared error, all the pooled root mean
    square; the error of step t is preds[:, t] - vol[:, t + 1] where
    t < the patient's length."""
    preds, vol = preds.to(dtype), vol.to(dtype)
    T = preds.shape[1]
    on = torch.arange(T, device=preds.device)[None] < lengths[:, None]
    err2 = torch.where(on, (preds - vol[:, 1:]) ** 2, 0.0)
    count = on.sum(0).to(dtype)
    per_step = err2.sum(0) / torch.clamp(count, min=1.0)
    orig = torch.sqrt(per_step.mean()) / MAX_VALUE * 100.0
    pooled = torch.sqrt(err2.sum() / on.sum().to(dtype)) / MAX_VALUE * 100.0
    return float(orig), float(pooled)


# ---------------------------------------------------------------------------
# the main table's collection: train and validation cohorts and the two
# counterfactual test sets, each subset from a generator seeded alike

def _patients(n, seed, variant, device, dtype, draw_dtype):
    """The patient constants of one subset and its generator, positioned
    after them: (generator, statics [n, 2], decay constants [n, 2] by arm,
    v0 [n])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device, dtype=draw_dtype)
    shift = (torch.stack([torch.randn((), **kw), torch.randn((), **kw)])
             if variant == 'EQ_4_D' else None)
    c0, c1, u = (torch.randn(n, **kw), torch.randn(n, **kw),
                 torch.rand(n, **kw))
    perm = torch.randperm(n, generator=gen, device=device)
    scale = 0.5
    s = torch.stack([c0, c1], 1).to(dtype) * (0.1 * scale) + scale
    k = s.clone()
    if variant in ('EQ_4_C', 'EQ_4_D'):
        k = k + torch.tensor([0.1, 0.3], dtype=torch.float64,
                             device=device).to(dtype) * scale
    if shift is not None:
        k = k + shift.to(dtype) * (0.5 * scale)
    v0 = u.to(dtype) * (MAX_VALUE - 1.0) + 1.0
    return gen, s[perm], k[perm], v0[perm]


def _arm(gen, v0, conf_coeff, draw_dtype):
    u = torch.rand(v0.shape[0], generator=gen, device=v0.device,
                   dtype=draw_dtype).to(v0.dtype)
    prob = torch.sigmoid(conf_coeff / MAX_VALUE * (v0 - MAX_VALUE / 2.0))
    return (u < prob).to(torch.int64), (u - prob).abs() < EDGE


def _euler(y, k, dt, steps: int):
    """``steps`` steps of dy/dt = -k y from y, SUBSTEPS Euler sub-steps
    each: the states after each step, [..., steps]."""
    h = dt / SUBSTEPS
    out = []
    for _ in range(steps):
        for _ in range(SUBSTEPS):
            y = y - k * y * h
        out.append(y)
    return torch.stack(out, dim=-1)


def _noisy(x, gen, variant, draw_dtype):
    if variant[-1] not in 'BCD':
        return x
    return x + OBSERVATION_NOISE * torch.randn(
        x.shape, generator=gen, device=x.device, dtype=draw_dtype).to(x.dtype)


def simulate_one_step(n, seed, variant='EQ_4_D', conf_coeff=2.0,
                      seq_length=60, *, device, dtype=torch.float64,
                      draw_dtype=torch.float32):
    """The one-step counterfactual test set: for every patient and prefix
    end t < T - 1, the factual row (states 0..t+1) and the row whose last
    state follows state t under the other arm; (rows dict, edge [n])."""
    gen, s, k, v0 = _patients(n, seed, variant, device, dtype, draw_dtype)
    arm, edge = _arm(gen, v0, conf_coeff, draw_dtype)
    T = seq_length
    dt = MAX_TIME_HORIZON / T
    rows = torch.arange(n, device=device)
    vol = torch.cat([v0[:, None], _euler(v0, k[rows, arm], dt, T - 1)], 1)
    flip = _euler(vol[:, :T - 1], k[rows, 1 - arm][:, None], dt, 1)[..., 0]
    t = torch.arange(T - 1, device=device)[:, None]
    j = torch.arange(T, device=device)[None]
    fact = torch.where(j <= t + 1, vol[:, None], 0.0)             # [n, T-1, T]
    cf = torch.where(j <= t, vol[:, None], 0.0)
    cf = torch.where(j == t + 1, flip[:, :, None], cf)
    a = arm.to(dtype)[:, None, None]
    fact_a = torch.where(j <= t, a, 0.0)
    cf_a = torch.where(j < t, a, torch.where(j == t, 1.0 - a, 0.0))
    vols = torch.stack([fact, cf], 2).reshape(n, 2 * (T - 1), T)
    acts = torch.stack([fact_a, cf_a], 2).reshape(n, 2 * (T - 1), T)
    vols = _noisy(vols, gen, variant, draw_dtype)
    lengths = torch.arange(1, T, device=device).repeat_interleave(2)
    return _flat(vols, acts, lengths.expand(n, -1), s), edge


def simulate_sequences(n, seed, projection_horizon=5, variant='EQ_4_D',
                       conf_coeff=2.0, seq_length=60, *, device,
                       dtype=torch.float64, draw_dtype=torch.float32):
    """The n-step test set under the sliding-treatment plans: for every
    patient, prefix end i < T - 1 and plan p (arm 1 at step p alone, then
    arm 0 at step p alone, the other steps the other arm), states 0..i+1
    then the plan's ph states from state i+1; (rows dict, edge [n])."""
    gen, s, k, v0 = _patients(n, seed, variant, device, dtype, draw_dtype)
    arm, edge = _arm(gen, v0, conf_coeff, draw_dtype)
    T, ph = seq_length, projection_horizon
    dt = MAX_TIME_HORIZON / T
    rows = torch.arange(n, device=device)
    vol = torch.cat([v0[:, None], _euler(v0, k[rows, arm], dt, T)], 1)
    eye = torch.eye(ph, dtype=torch.int64, device=device)
    plans = torch.cat([eye, 1 - eye])                             # [2ph, ph]
    y = vol[:, 1:T][:, :, None].expand(n, T - 1, 2 * ph)
    cf = []
    for step in range(ph):
        rate = k[:, plans[:, step]][:, None, :]                   # [n, 1, 2ph]
        y = _euler(y, rate, dt, 1)[..., 0]
        cf.append(y)
    cf = torch.stack(cf, -1)                                      # [n, T-1, 2ph, ph]
    W = T + ph
    i = torch.arange(T - 1, device=device)[:, None, None]
    j = torch.arange(W, device=device)[None, None]
    padded = torch.cat([vol, vol.new_zeros(n, W - T - 1)], 1)
    base = torch.where(j <= i + 1, padded[:, None, None], 0.0)
    kk = (j - i - 2).clamp(0, ph - 1).expand(T - 1, 2 * ph, W)
    in_cf = (j >= i + 2) & (j < i + 2 + ph)
    vols = torch.where(in_cf, torch.gather(
        cf, 3, kk[None].expand(n, -1, -1, -1)), base)
    ka = (j - i - 1).clamp(0, ph - 1).expand(T - 1, 2 * ph, W)
    plan_a = torch.gather(plans[None].expand(T - 1, -1, -1), 2, ka)
    in_plan = (j >= i + 1) & (j < i + 1 + ph)
    acts = torch.where(in_plan[None], plan_a[None].to(dtype),
                       torch.where(j[None] <= i[None],
                                   arm.to(dtype)[:, None, None, None], 0.0))
    R = (T - 1) * 2 * ph
    vols = _noisy(vols.reshape(n, R, W), gen, variant, draw_dtype)
    lengths = (torch.arange(T - 1, device=device) + 1 + ph
               ).repeat_interleave(2 * ph)
    return _flat(vols, acts.reshape(n, R, W), lengths.expand(n, -1), s), edge


def simulate_factual(n, seed, variant='EQ_4_D', conf_coeff=2.0,
                     seq_length=60, *, device, dtype=torch.float64,
                     draw_dtype=torch.float32):
    """A factual subset as rows: (rows dict, edge [n])."""
    vol, s, treat, lengths, edge = simulate(
        n, seed, variant, conf_coeff, seq_length, device=device, dtype=dtype,
        draw_dtype=draw_dtype, with_edges=True)
    return _flat(vol[:, None], treat[:, None], lengths[:, None], s), edge


def _flat(vols, acts, lengths, s):
    """[n, R, W] row blocks as [n R, W] rows, with each patient's
    statics repeated over its R rows."""
    R = vols.shape[1]
    return {'cancer_volume': vols.reshape(-1, vols.shape[-1]),
            'treatment_application': acts.reshape(-1, acts.shape[-1]),
            'sequence_lengths': lengths.reshape(-1),
            'observed_static_c_0': s[:, 0].repeat_interleave(R),
            'observed_static_c_1': s[:, 1].repeat_interleave(R)}


# ---------------------------------------------------------------------------
# the main table's processing

RAW_KEYS = ('cancer_volume', 'treatment_application', 'sequence_lengths',
            'observed_static_c_0', 'observed_static_c_1')
STATICS = ('observed_static_c_0', 'observed_static_c_1')
EXACT_KEYS = ('treatment_application', 'sequence_lengths')
NORM = MAX_VALUE
N_ARMS = 2
Y_CLIP = None


def subsets(sizes: dict, seed: int, variant='EQ_4_D', conf_coeff=2.0,
            seq_length=60, projection_horizon=5, *, device,
            dtype=torch.float64, draw_dtype=torch.float32) -> dict:
    """The four subsets of a main-table run: {name: (rows, edge [N],
    patient [N])}, each row's patient and its edge mask."""
    kw = dict(variant=variant, conf_coeff=conf_coeff, seq_length=seq_length,
              device=device, dtype=dtype, draw_dtype=draw_dtype)
    out = {'train_f': simulate_factual(sizes['train'], seed, **kw),
           'val_f': simulate_factual(sizes['val'], seed, **kw),
           'test_cf_one_step': simulate_one_step(sizes['test'], seed, **kw),
           'test_cf_treatment_seq': simulate_sequences(
               sizes['test'], seed, projection_horizon, **kw)}
    res = {}
    for k, (rows, edge) in out.items():
        pid = torch.arange(len(edge), device=edge.device).repeat_interleave(
            len(rows['sequence_lengths']) // len(edge))
        res[k] = (rows, edge[pid], pid)
    return res


def patient_of(name: str, data: dict, n: int):
    """The patient of each of a subset's rows: every patient has as many
    rows, one after the other."""
    N = len(np.asarray(data['sequence_lengths']))
    return torch.arange(N) // (N // n)


def scaling(train: dict, dtype=torch.float64) -> dict:
    """Means and standard deviations (population) of the training
    cohort's volumes over the steps t < length, then of each static:
    {'means': [3], 'stds': [3]}."""
    vol = torch.as_tensor(train['cancer_volume']).to(dtype)
    n = torch.as_tensor(train['sequence_lengths']).to(torch.int64)
    v = vol[torch.arange(vol.shape[1])[None] < n[:, None]]
    x = [v] + [torch.as_tensor(train[k]).to(dtype) for k in STATICS]
    return {'means': torch.stack([t.mean() for t in x]),
            'stds': torch.stack([t.std(correction=0) for t in x])}


def process(data: dict, sc: dict, projection_horizon=None,
            dtype=torch.float64) -> dict:
    """The model's view of a subset, in float64: scaled previous outputs
    [N, T-1] and statics [N, 2], the arm one-hot [N, T-1, 2], scaled
    outputs [N, T-1], the active steps t < length [N, T-1], and, with
    ``projection_horizon`` ph (the n-step set), the last ph steps of each
    row's outputs (``window_outputs`` [N, ph])."""
    f64 = dtype
    vol = torch.as_tensor(data['cancer_volume']).to(f64)
    z = (vol - sc['means'][0]) / sc['stds'][0]
    statics = torch.stack([
        (torch.as_tensor(data[k]).to(f64) - sc['means'][i + 1])
        / sc['stds'][i + 1] for i, k in enumerate(STATICS)], 1)
    app = torch.as_tensor(data['treatment_application']).to(f64)
    arms = app[:, :-1].to(torch.int64)
    n = torch.as_tensor(data['sequence_lengths']).to(torch.int64)
    T = vol.shape[1] - 1
    out = {'prev_outputs': z[:, :-1], 'statics': statics,
           'treatments': torch.nn.functional.one_hot(arms, 2).to(f64),
           'outputs': z[:, 1:],
           'active': (torch.arange(T)[None] < n[:, None]).to(f64)}
    if projection_horizon:
        win = (n - projection_horizon)[:, None] + \
            torch.arange(projection_horizon)[None]
        out['window_outputs'] = torch.gather(z[:, 1:], 1, win)
    return out


def unscaled(prev_outputs, static_features, sc: dict):
    """(prev [N, T-1], statics [N, 2]) in the data's units from a
    subset's scaled previous outputs [N, T-1] and statics [N, 2]."""
    prev = torch.as_tensor(prev_outputs).double()
    s = torch.as_tensor(static_features).double()
    return (prev * sc['stds'][0] + sc['means'][0],
            s * sc['stds'][1:] + sc['means'][1:])
