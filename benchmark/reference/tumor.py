"""Plain reference of INSITE on the cancer_sim tumour-growth family (Geng
et al. 2017: Gompertz growth, chemotherapy and radiotherapy, confounded
treatment assignment on the mean tumour diameter of the last 15 days),
written from the simulator's equations, in plain PyTorch and numpy
(scipy's truncated normal for the patients' initial diameters and chemo
sensitivities, drawn from the run's own ``RandomState``).

It imports nothing of the program. The compute ``dtype`` is float64 for
the reference and bfloat16 for the lower-precision control; the random
numbers are drawn in float64 on the host either way.

Daily update, with chemo concentration C (halving daily, plus 5 a dose),
radio dose d in {0, 2} and noise e:

    V' = V (1 + rho log(K / V) - beta_c C - (alpha d + beta d^2) + e)

The main table's four subsets draw, in order, from one
``np.random.RandomState(seed)``: each subset's patients, then its
trajectory draws (the factual cohorts array at once, the counterfactual
sets patient by patient).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import truncnorm

from benchmark.reference.eq4 import (_solve, exponents, features,  # noqa
                                     finetune, rollout, rollout_sens, stlsq)

MAX_TIME_HORIZON = 10.0                 # dt = 1/6, as the EQ_4 family
WINDOW = 15
CHEMO_AMT, RADIO_AMT = 5.0, 2.0
DRUG_DECAY = float(np.exp(-np.log(2.0)))
CELL_DENSITY = 5.8e8


def volume(diameter):
    return 4.0 / 3.0 * np.pi * (diameter / 2.0) ** 3


def diameter(vol):
    return (vol / (4.0 / 3.0 * np.pi)) ** (1.0 / 3.0) * 2.0


DEATH = volume(13.0)
NORM = DEATH
N_ARMS = 4
Y_CLIP = (0.0, float(DEATH))
RAW_KEYS = ('cancer_volume', 'chemo_application', 'radio_application',
            'sequence_lengths', 'patient_types')
EXACT_KEYS = ('chemo_application', 'radio_application', 'sequence_lengths',
              'patient_types')
EDGE = 1e-5
STAGES = {'I': (1.72, 4.70, 0.3, 5.0, 1432), 'II': (1.96, 1.63, 0.3, 13.0, 128),
          'IIIA': (1.91, 9.40, 0.3, 13.0, 1306),
          'IIIB': (2.76, 6.87, 0.3, 13.0, 7248),
          'IV': (3.86, 8.82, 0.3, 13.0, 12840)}


# ---------------------------------------------------------------------------
# patients

def patients(n: int, rs: np.random.RandomState, gamma: float) -> dict:
    """Patient constants: initial volumes from the stage's log-normal
    diameter, (alpha, rho) bivariate normal kept positive, beta = alpha /
    10, beta_c truncated normal, the patient type (1: radio-sensitive, 3:
    chemo-sensitive, 2: neither) and the confounding sigmoid's intercept
    (half the death diameter) and slope gamma / that diameter."""
    names = sorted(STAGES)
    total = sum(STAGES[s][4] for s in names)
    stage = rs.choice(names, n, p=[STAGES[s][4] / total for s in names])
    diam = []
    for s in names:
        mu, sigma, lo, hi, _ = STAGES[s]
        z = truncnorm.rvs((np.log(lo) - mu) / sigma, (np.log(hi) - mu) / sigma,
                          size=int(np.sum(stage == s)), random_state=rs)
        diam += list(np.exp(z * sigma + mu))
    mean = np.array([0.0398, 7e-5])
    sd = np.array([0.168, 7.23e-3])
    cov = np.array([[sd[0] ** 2, 0.87 * sd[0] * sd[1]],
                    [0.87 * sd[0] * sd[1], sd[1] ** 2]])
    kept = []
    while len(kept) < n:
        draw = rs.multivariate_normal(mean, cov, size=n)
        kept += [r for r in draw if r[0] > 0.0 and r[1] > 0.0]
    ptype = rs.choice([1, 2, 3], n)
    kept = np.array(kept)[:n]
    alpha = kept[:, 0] + 0.0398 * np.where(ptype > 1, 0.0, 0.1)
    beta_c = 0.028 + 0.0007 * truncnorm.rvs(-0.028 / 0.0007, np.inf, size=n,
                                            random_state=rs) \
        + 0.028 * np.where(ptype < 3, 0.0, 0.1)
    p = {'ptype': ptype, 'v0': volume(np.array(diam)), 'alpha': alpha,
         'rho': kept[:, 1], 'beta': alpha / 10.0, 'beta_c': beta_c,
         'K': np.full(n, volume(30.0))}
    order = list(range(n))
    rs.shuffle(order)
    p = {k: v[order] for k, v in p.items()}
    d_max = diameter(DEATH)
    p['intercept'] = np.full(n, d_max / 2.0)
    p['slope'] = np.full(n, gamma / d_max)
    return p


def _to(p: dict, device, dtype) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float64), device=device
                               ).to(dtype) for k, v in p.items()}


def _update(v, chemo, radio, p, eps, guard: float = 0.0):
    growth = p['rho'] * torch.log(p['K'] / torch.clamp(v + guard, min=1e-30)
                                  + guard)
    return v * (1.0 + growth - p['beta_c'] * chemo
                - (p['alpha'] * radio + p['beta'] * radio * radio) + eps)


def _assign(u, metric, p):
    """(applied, |u - probability| < EDGE) of a confounded coin."""
    prob = torch.sigmoid(p['slope'] * (metric - p['intercept']))
    return u < prob, (u - prob).abs() < EDGE


def _mean_diameter(history: list, count: int, like):
    if count <= 0:
        return torch.zeros_like(like)
    return torch.stack([diameter(v) for v in history[-count:]]).sum(0) / count


# ---------------------------------------------------------------------------
# the factual cohort (train and validation)

def factual(p: dict, rvs: dict, T: int):
    """The factual trajectories: volumes [n, T] (v0, then day t's volume at
    t = 1..T-2, then 0), the applications [n, T] (day t's at t, 0 at the
    ends), lengths [n] (the step of death or recovery + 1, else T - 1) and
    an edge mask [n]. A patient stops at death (volume above the
    threshold, kept at it) or recovery (volume 0)."""
    v = p['v0']
    n = v.shape[0]
    zero = torch.zeros_like(v)
    chemo, radio = zero, zero
    history = [v]
    alive = torch.ones(n, dtype=torch.bool, device=v.device)
    edge = torch.zeros_like(alive)
    lengths = torch.full((n,), T - 1, dtype=torch.int64, device=v.device)
    vols, c_app, r_app = [v], [zero], [zero]
    for t in range(1, T - 1):
        v_t = _update(v, chemo, radio, p, rvs['noise'][:, t])
        metric = _mean_diameter(history, min(t, WINDOW), v)
        ca, e1 = _assign(rvs['chemo_rv'][:, t], metric, p)
        ra, e2 = _assign(rvs['radio_rv'][:, t], metric, p)
        edge |= alive & (e1 | e2)
        dose_r = torch.where(ra, RADIO_AMT, 0.0).to(v.dtype)
        dose_c = chemo * DRUG_DECAY + torch.where(ca, CHEMO_AMT, 0.0
                                                  ).to(v.dtype)
        died = v_t > DEATH
        edge |= alive & ((v_t - DEATH).abs() < EDGE * DEATH)
        v_t = torch.where(died, DEATH, v_t)
        rec = ~died & (rvs['recovery'][:, t] <
                       torch.exp(-v_t * CELL_DENSITY))
        v_t = torch.where(rec, 0.0, v_t)
        lengths = torch.where(alive & (died | rec), t + 1, lengths)
        v = torch.where(alive, v_t, 0.0)
        chemo = torch.where(alive, dose_c, 0.0)
        radio = torch.where(alive, dose_r, 0.0)
        vols.append(v)
        c_app.append(torch.where(alive, ca.to(v.dtype), 0.0))
        r_app.append(torch.where(alive, ra.to(v.dtype), 0.0))
        alive = alive & ~(died | rec)
        history.append(v)
    vols.append(zero)
    c_app.append(zero)
    r_app.append(zero)
    return (torch.stack(vols, 1), torch.stack(c_app, 1),
            torch.stack(r_app, 1), lengths, edge)


# ---------------------------------------------------------------------------
# the test cohorts' factual branch and counterfactual rows

def test_branch(p: dict, rvs: dict, T: int):
    """The test cohort's own history: volumes [n, T] (v0, then the volume
    after each day, clipped to [0, death]), that day's chemo dosage,
    applications [n, T-1] and whether the day was processed [n, T-1] (a
    patient stops after the day its volume reaches the threshold or
    recovers); an edge mask [n]."""
    v = p['v0']
    n = v.shape[0]
    chemo = torch.zeros_like(v)
    history = []
    active = torch.ones(n, dtype=torch.bool, device=v.device)
    edge = torch.zeros_like(active)
    out = {k: [] for k in ('vol', 'dose', 'ca', 'ra', 'active')}
    for t in range(T - 1):
        history.append(v)
        metric = _mean_diameter(history, min(t + 1, WINDOW + 1), v)
        ca, e1 = _assign(rvs['chemo_rv'][:, t], metric, p)
        ra, e2 = _assign(rvs['radio_rv'][:, t], metric, p)
        edge |= active & (e1 | e2)
        dose_r = torch.where(ra, RADIO_AMT, 0.0).to(v.dtype)
        dose_c = chemo * DRUG_DECAY + torch.where(ca, CHEMO_AMT, 0.0
                                                  ).to(v.dtype)
        nxt = torch.clamp(_update(v, dose_c, dose_r, p,
                                  rvs['noise'][:, t + 1]), 0.0, DEATH)
        stop = (nxt >= DEATH) | (rvs['recovery'][:, t] <=
                                 torch.exp(-nxt * CELL_DENSITY))
        edge |= active & ((nxt - DEATH).abs() < EDGE * DEATH)
        v = torch.where(active, nxt, 0.0)
        chemo = torch.where(active, dose_c, 0.0)
        for k, x in (('vol', v), ('dose', chemo),
                     ('ca', torch.where(active, ca.to(v.dtype), 0.0)),
                     ('ra', torch.where(active, ra.to(v.dtype), 0.0)),
                     ('active', active)):
            out[k].append(x)
        active = active & ~stop
    st = {k: torch.stack(x, 1) for k, x in out.items()}
    st['vol'] = torch.cat([p['v0'][:, None], st['vol']], 1)
    return st, edge


OPTIONS = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0))   # (chemo, radio)


def one_step_rows(p: dict, br: dict, noise, T: int):
    """Every processed (patient, day t) gives four rows, one a treatment
    option: the history up to day t, then the next volume under that
    option (the factual branch's, clipped, for the option applied; else
    one unclipped update from day t's volume). The applications are the
    history's before t and the option at t. Rows [n, T-1, 4, T] and their
    validity [n, T-1, 4]."""
    n = br['vol'].shape[0]
    dt, dev = br['vol'].dtype, br['vol'].device
    oc = torch.tensor([o[0] for o in OPTIONS], device=dev).to(dt)
    orr = torch.tensor([o[1] for o in OPTIONS], device=dev).to(dt)
    q = {k: v[:, None] for k, v in p.items()}
    vols = torch.zeros((n, T - 1, 4, T), dtype=dt, device=dev)
    c_rows, r_rows = torch.zeros_like(vols), torch.zeros_like(vols)
    for t in range(T - 1):
        before = br['dose'][:, t - 1] if t > 0 else torch.zeros_like(
            br['dose'][:, 0])
        nxt = _update(br['vol'][:, t, None], before[:, None] * DRUG_DECAY
                      + CHEMO_AMT * oc, (RADIO_AMT * orr).expand(n, 4), q,
                      noise[:, t + 1, None])
        applied = (br['ca'][:, t, None] == oc) & (br['ra'][:, t, None] == orr)
        vols[:, t, :, :t + 1] = br['vol'][:, None, :t + 1]
        vols[:, t, :, t + 1] = torch.where(applied, br['vol'][:, t + 1, None],
                                           nxt)
        c_rows[:, t, :, :t] = br['ca'][:, None, :t]
        r_rows[:, t, :, :t] = br['ra'][:, None, :t]
        c_rows[:, t, :, t] = oc
        r_rows[:, t, :, t] = orr
    valid = br['active'][:, :, None].expand(n, T - 1, 4)
    return vols, c_rows, r_rows, valid


def sliding_plans(ph: int):
    """The 2 ph plans: chemo alone on plan day q for q < ph, then radio
    alone on day q - ph: (chemo [2ph, ph], radio [2ph, ph])."""
    eye, zero = np.eye(ph), np.zeros((ph, ph))
    return (np.concatenate([eye, zero]), np.concatenate([zero, eye]))


def sequence_rows(p: dict, br: dict, noise, T: int, ph: int):
    """Every processed (patient, day t) and sliding plan gives a row: the
    history up to day t + 1, then ph updates from that volume with the
    chemo concentration carried on from day t (the logarithm guarded by
    1e-7). A row is dropped where a plan volume before the last falls to
    -1e-7 or below, or any volume is not a number. Rows [n, T-1, 2ph,
    T+ph], applications alike, validity [n, T-1, 2ph]."""
    n = br['vol'].shape[0]
    dt, dev = br['vol'].dtype, br['vol'].device
    P, W = 2 * ph, T + ph
    plan_c, plan_r = (torch.as_tensor(x, device=dev).to(dt)
                      for x in sliding_plans(ph))
    q = {k: v[:, None] for k, v in p.items()}
    vols = torch.zeros((n, T - 1, P, W), dtype=dt, device=dev)
    c_rows, r_rows = torch.zeros_like(vols), torch.zeros_like(vols)
    valid = br['active'][:, :, None].expand(n, T - 1, P).clone()
    for t in range(T - 1):
        v = br['vol'][:, t + 1, None].expand(n, P)
        chemo = br['dose'][:, t, None].expand(n, P)
        vols[:, t, :, :t + 2] = br['vol'][:, None, :t + 2]
        c_rows[:, t, :, :t + 1] = br['ca'][:, None, :t + 1]
        r_rows[:, t, :, :t + 1] = br['ra'][:, None, :t + 1]
        for k in range(ph):
            chemo = chemo * DRUG_DECAY + CHEMO_AMT * plan_c[:, k]
            v = _update(v, chemo, (RADIO_AMT * plan_r[:, k]).expand(n, P),
                        q, noise[:, t + 2 + k, None], guard=1e-7)
            vols[:, t, :, t + 2 + k] = v
            c_rows[:, t, :, t + 1 + k] = plan_c[:, k]
            r_rows[:, t, :, t + 1 + k] = plan_r[:, k]
            if k < ph - 1:
                valid[:, t] &= ~(v + 1e-7 <= 0.0)
    valid &= ~torch.isnan(vols).any(-1)
    return vols, c_rows, r_rows, valid


# ---------------------------------------------------------------------------
# the main table's collection

def _rows(vols, c_rows, r_rows, valid, lengths, ptype):
    """The valid rows of [n, T-1, R, W] blocks as [N, W] rows, with each
    row's patient."""
    keep = valid.reshape(-1)
    W = vols.shape[-1]
    R = valid[0].numel()
    pid = torch.arange(len(valid), device=vols.device).repeat_interleave(R)
    return pid[keep], {
        'cancer_volume': vols.reshape(-1, W)[keep],
        'chemo_application': c_rows.reshape(-1, W)[keep],
        'radio_application': r_rows.reshape(-1, W)[keep],
        'sequence_lengths': lengths.reshape(-1)[keep],
        'patient_types': torch.as_tensor(
            np.repeat(ptype, R), device=vols.device)[keep].to(vols.dtype)
    }, keep


def subsets(sizes: dict, seed: int, variant='cancer_sim', conf_coeff=2.0,
            seq_length=60, projection_horizon=5, *, device,
            dtype=torch.float64, draw_dtype=None) -> dict:
    """The four subsets of a main-table run from one RandomState(seed):
    {name: (rows, edge [rows], patient [rows])}."""
    if variant != 'cancer_sim':
        raise ValueError(f'tumour variant {variant!r}')
    rs = np.random.RandomState(seed)
    T, ph = seq_length, projection_horizon
    out = {}
    for name, n in (('train_f', sizes['train']), ('val_f', sizes['val'])):
        pn = patients(n, rs, conf_coeff)
        shape = (n, T)
        rvs = {'noise': 0.01 * rs.randn(*shape), 'recovery': rs.rand(*shape),
               'chemo_rv': rs.rand(*shape), 'radio_rv': rs.rand(*shape)}
        vols, ca, ra, lengths, edge = factual(
            _to(pn, device, dtype), _to(rvs, device, dtype), T)
        out[name] = ({'cancer_volume': vols, 'chemo_application': ca,
                      'radio_application': ra, 'sequence_lengths': lengths,
                      'patient_types': torch.as_tensor(
                          pn['ptype'], device=device).to(dtype)}, edge,
                     torch.arange(n, device=device))
    for name, width in (('test_cf_one_step', T),
                        ('test_cf_treatment_seq', T + ph)):
        n = sizes['test']
        pn = patients(n, rs, conf_coeff)
        rvs = {k: np.empty((n, width if k == 'noise' else T))
               for k in ('noise', 'recovery', 'chemo_rv', 'radio_rv')}
        for i in range(n):
            rvs['noise'][i] = 0.01 * rs.randn(width)
            for k in ('recovery', 'chemo_rv', 'radio_rv'):
                rvs[k][i] = rs.rand(T)
        pt, rt = _to(pn, device, dtype), _to(rvs, device, dtype)
        br, edge = test_branch(pt, rt, T)
        if name == 'test_cf_one_step':
            vols, cr, rr, valid = one_step_rows(pt, br, rt['noise'], T)
            lengths = torch.arange(1, T, device=device)[None, :, None
                                                        ].expand_as(valid)
        else:
            vols, cr, rr, valid = sequence_rows(pt, br, rt['noise'], T, ph)
            lengths = (torch.arange(1, T, device=device) + ph)[
                None, :, None].expand_as(valid)
        pid, rows, keep = _rows(vols, cr, rr, valid, lengths, pn['ptype'])
        out[name] = (rows, edge[pid], pid)
    return out


def patient_of(name: str, data: dict, n: int):
    """The patient of each of a subset's rows: one row a patient in the
    factual subsets; the n-step rows carry their patient; the 1-step set
    keeps the four rows of each processed day, patient after patient, and
    every patient has its first day: each block of four rows of the
    least sequence length starts a patient."""
    lengths = torch.as_tensor(np.asarray(data['sequence_lengths'])).to(
        torch.int64)
    if name in ('train_f', 'val_f'):
        return torch.arange(len(lengths))
    if 'patient_ids_all_trajectories' in data:
        return torch.as_tensor(np.asarray(
            data['patient_ids_all_trajectories'])).to(torch.int64)
    first = (lengths == lengths.min()).to(torch.int64)
    # the position of each first-day row in its run of first-day rows
    run_start = torch.cat([torch.ones(1, dtype=torch.int64),
                           (first[1:] > first[:-1]).to(torch.int64)])
    count = torch.cumsum(first, 0)
    base = torch.cummax(torch.where(run_start.bool() & first.bool(),
                                    count - 1, 0), 0).values
    start = first.bool() & ((count - 1 - base) % len(OPTIONS) == 0)
    return torch.cumsum(start.to(torch.int64), 0) - 1


# ---------------------------------------------------------------------------
# fit

def fit(vol, statics, arms, lengths, threshold: float, alpha: float,
        seq_length: int = 60, dtype=torch.float64, n_arms: int = N_ARMS,
        max_iter: int = 100):
    """Global coefficients [n_arms, F]: forward differences (V[j+1] -
    V[j]) / dt over the steps j < length, the degree-2 interaction-only
    library over [V[j], statics], one regression per arm over the steps
    that arm drove; vol [N, T], arms [N, T-1]."""
    vol, statics = vol.to(dtype), statics.to(dtype)
    dt = MAX_TIME_HORIZON / seq_length
    N, T = vol.shape
    xdot = (vol[:, 1:] - vol[:, :-1]) / dt
    X = torch.cat([vol[:, :-1, None],
                   statics[:, None, :].expand(N, T - 1, -1)], -1)
    theta = features(X, exponents(1 + statics.shape[1]))
    ok = torch.arange(T - 1, device=vol.device)[None] < lengths[:, None]
    theta, xdot, arm = theta[ok], xdot[ok], arms.to(torch.int64)[ok]
    return torch.stack([stlsq(theta[arm == a], xdot[arm == a], threshold,
                              alpha, dtype, max_iter)
                        for a in range(n_arms)])


# ---------------------------------------------------------------------------
# the main table's processing

def scaling(train: dict, dtype=torch.float64) -> dict:
    """Means and standard deviations (population) of the training
    cohort's volumes over the steps t < length, then of the patient
    types: {'means': [2], 'stds': [2]}."""
    vol = torch.as_tensor(np.asarray(train['cancer_volume'])).to(dtype)
    n = torch.as_tensor(np.asarray(train['sequence_lengths'])).to(
        torch.int64)
    v = vol[torch.arange(vol.shape[1])[None] < n[:, None]]
    pt = torch.as_tensor(np.asarray(train['patient_types'])).to(dtype)
    return {'means': torch.stack([v.mean(), pt.mean()]),
            'stds': torch.stack([v.std(correction=0),
                                 pt.std(correction=0)])}


def process(data: dict, sc: dict, projection_horizon=None,
            dtype=torch.float64) -> dict:
    """The model's view of a subset: scaled previous outputs [N, T-1] and
    patient type [N, 1], the 4-arm one-hot of (chemo + 2 radio) [N, T-1,
    4], scaled outputs [N, T-1], the active steps t < length and, with
    ``projection_horizon`` ph, the last ph outputs of each row."""
    def arr(k):
        return torch.as_tensor(np.asarray(data[k])).to(dtype)
    z = (arr('cancer_volume') - sc['means'][0]) / sc['stds'][0]
    statics = ((arr('patient_types') - sc['means'][1]) / sc['stds'][1])[:,
                                                                       None]
    arms = (arr('chemo_application') + 2 * arr('radio_application'))[
        :, :-1].to(torch.int64)
    n = torch.as_tensor(np.asarray(data['sequence_lengths'])).to(
        torch.int64)
    T = z.shape[1] - 1
    out = {'prev_outputs': z[:, :-1], 'statics': statics,
           'treatments': torch.nn.functional.one_hot(arms, 4).to(dtype),
           'outputs': z[:, 1:],
           'active': (torch.arange(T)[None] < n[:, None]).to(dtype)}
    if projection_horizon:
        win = (n - projection_horizon)[:, None] + \
            torch.arange(projection_horizon)[None]
        out['window_outputs'] = torch.gather(z[:, 1:], 1, win)
    return out


def unscaled(prev_outputs, static_features, sc: dict):
    """(prev [N, T-1], statics [N, 1]) in the data's units."""
    prev = torch.as_tensor(np.asarray(prev_outputs)).double()
    s = torch.as_tensor(np.asarray(static_features)).double()
    return (prev * sc['stds'][0] + sc['means'][0],
            s * sc['stds'][1:] + sc['means'][1:])


# ---------------------------------------------------------------------------
# the vectorized column: a seed's cohorts from one torch generator

def _erf_range(lo, hi):
    return (torch.special.erf(torch.as_tensor(lo / np.sqrt(2.0))),
            torch.special.erf(torch.as_tensor(hi / np.sqrt(2.0))))


def _truncated(u, lo, hi):
    """A standard normal truncated to (lo, hi) from uniforms u, by the
    inverse of its distribution function; an edge mask where u lies
    within 1e-4 of either end, where the inverse is steep enough that the
    program's rounding moves the draw visibly."""
    a, b = _erf_range(lo, hi)
    a, b = a.to(u), b.to(u)
    z = np.sqrt(2.0) * torch.special.erfinv(a + (b - a) * u)
    z = torch.minimum(torch.maximum(z, torch.as_tensor(lo).to(u)),
                      torch.as_tensor(hi).to(u))
    return z, (u < 1e-4) | (u > 1 - 1e-4)


def column_patients(gen, n: int, gamma: float, *, device, dtype,
                    draw_dtype=torch.float32):
    """One subset's patients drawn from ``gen`` in the column's order: the
    stage, a uniform for its truncated-normal log diameter, 16 correlated
    normal pairs of which the first positive (alpha, rho) is kept (the
    mean where none is), the patient type and a uniform for beta_c's
    truncated normal. Returns (parameters, patient types, edge [n])."""
    names = sorted(STAGES)
    total = sum(STAGES[s][4] for s in names)
    probs = torch.tensor([STAGES[s][4] / total for s in names],
                         dtype=torch.float64, device=device)
    stage = torch.multinomial(probs, n, replacement=True, generator=gen)
    kw = dict(generator=gen, device=device, dtype=draw_dtype)
    u_diam = torch.rand(n, **kw).to(dtype)
    z_pairs = torch.randn((n, 16, 2), **kw).to(dtype)
    ptype = torch.tensor([1, 2, 3], device=device)[
        torch.randint(0, 3, (n,), generator=gen, device=device)]
    u_beta = torch.rand(n, **kw).to(dtype)

    dist = torch.tensor([STAGES[s][:4] for s in names], dtype=torch.float64,
                        device=device)[stage].to(dtype)
    mu, sigma, lo, hi = dist.unbind(1)
    lb, ub = (torch.log(lo) - mu) / sigma, (torch.log(hi) - mu) / sigma
    a = torch.special.erf(lb / np.sqrt(2.0))
    b = torch.special.erf(ub / np.sqrt(2.0))
    zd = np.sqrt(2.0) * torch.special.erfinv(a + (b - a) * u_diam)
    zd = torch.minimum(torch.maximum(zd, lb), ub)
    v0 = volume(torch.exp(zd * sigma + mu))
    edge = (u_diam < 1e-4) | (u_diam > 1 - 1e-4)

    sd = (0.168, 7.23e-3)
    cov = torch.tensor([[sd[0] ** 2, 0.87 * sd[0] * sd[1]],
                        [0.87 * sd[0] * sd[1], sd[1] ** 2]],
                       dtype=dtype, device=device)
    mean = torch.tensor([0.0398, 7e-5], dtype=dtype, device=device)
    cand = mean + z_pairs @ torch.linalg.cholesky(cov.float()
                                                  if dtype == torch.bfloat16
                                                  else cov).to(dtype).T
    ok = (cand > 0).all(-1)
    first = torch.where(ok, torch.arange(16, device=device), 16).min(1).values
    pick = torch.where((first < 16)[:, None],
                       cand[torch.arange(n, device=device), first.clamp(
                           max=15)], mean)
    tb, e2 = _truncated(u_beta, -0.028 / 0.0007, float('inf'))
    edge |= e2
    radio_adj = torch.where(ptype > 1, 0.0, 0.1).to(dtype)
    chemo_adj = torch.where(ptype < 3, 0.0, 0.1).to(dtype)
    alpha = pick[:, 0] + 0.0398 * radio_adj
    d_max = diameter(DEATH)
    p = {'v0': v0, 'alpha': alpha, 'rho': pick[:, 1], 'beta': alpha / 10.0,
         'beta_c': 0.028 + 0.0007 * tb + 0.028 * chemo_adj,
         'K': torch.full((n,), volume(30.0), dtype=dtype, device=device),
         'intercept': torch.full((n,), d_max / 2.0, dtype=dtype,
                                 device=device),
         'slope': torch.full((n,), gamma / d_max, dtype=dtype,
                             device=device)}
    return p, ptype, edge


def column_cohort(seed: int, n_train: int, n_test: int, T: int, gamma: float,
                  ph: int, *, device, dtype=torch.float64,
                  draw_dtype=torch.float32) -> dict:
    """One seed's column cohorts: 'train' (volumes [n, T], arms [n, T-1],
    lengths, patient type [n, 1], edge [n]) and 'one_step' / 'n_step'
    (rows [N, W], arms [N, W-1], lengths [N], patient type [N, 1], valid
    [N], edge [N]); every row kept, valid or not."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device, dtype=draw_dtype)
    out = {}
    for tag, n, width in (('train', n_train, T), ('test', n_test, T + ph)):
        p, ptype, edge = column_patients(gen, n, gamma, device=device,
                                         dtype=dtype, draw_dtype=draw_dtype)
        rvs = {'noise': 0.01 * torch.randn((n, width), **kw).to(dtype)}
        for k in ('recovery', 'chemo_rv', 'radio_rv'):
            rvs[k] = torch.rand((n, T), **kw).to(dtype)
        out[tag] = (p, ptype.to(dtype)[:, None], rvs, edge)
    p, statics, rvs, edge = out['train']
    vols, ca, ra, lengths, e = factual(p, rvs, T)
    res = {'train': (vols, (ca + 2 * ra)[:, :-1].to(torch.int64), lengths,
                     statics, edge | e)}
    p, statics, rvs, edge = out['test']
    br, e = test_branch(p, rvs, T)
    edge = edge | e
    for name, (vols, cr, rr, valid), first in (
            ('one_step', one_step_rows(p, br, rvs['noise'], T), 1),
            ('n_step', sequence_rows(p, br, rvs['noise'], T, ph), 1 + ph)):
        n, D, R, W = vols.shape
        lengths = (torch.arange(D, device=device) + first)[None, :, None
                                                          ].expand(n, D, R)
        res[name] = (vols.reshape(-1, W),
                     (cr + 2 * rr).reshape(-1, W)[:, :-1].to(torch.int64),
                     lengths.reshape(-1),
                     statics.repeat_interleave(D * R, 0),
                     valid.reshape(-1),
                     edge.repeat_interleave(D * R))
    return res


def stlsq_ridge(X, y, threshold: float, alpha: float, rel: float,
                dtype=torch.float64, iters: int = 20):
    """Thresholded ridge regression with a fixed number of iterations:
    ridge max(alpha, rel trace(X'X) / F) on the support, the unbiased
    refit with the ridge rel trace(X'X) / F alone; [F]."""
    F = X.shape[1]
    gram, rhs = X.T @ X, X.T @ y
    floor = rel * torch.diagonal(gram).sum() / F
    eye = torch.eye(F, dtype=gram.dtype, device=X.device)

    def solve(mask, a):
        m = mask.to(gram.dtype)
        A = gram * m[:, None] * m[None] + eye * (a * m + (1 - m))[None]
        return _solve(A, (rhs * m)[:, None], dtype)[:, 0]

    mask = torch.ones(F, dtype=torch.bool, device=X.device)
    for _ in range(iters):
        c = solve(mask, torch.clamp(floor, min=alpha))
        mask = (c.abs() >= threshold) & mask
    return torch.where(mask, solve(mask, floor), 0.0)


def fit_ridge(vol, statics, arms, lengths, threshold: float, alpha: float,
              rel: float, seq_length: int = 60, dtype=torch.float64,
              n_arms: int = N_ARMS):
    """A seed's global coefficients [n_arms, F] by `stlsq_ridge` over the
    forward-difference design of `fit`."""
    vol, statics = vol.to(dtype), statics.to(dtype)
    dt = MAX_TIME_HORIZON / seq_length
    N, T = vol.shape
    xdot = (vol[:, 1:] - vol[:, :-1]) / dt
    X = torch.cat([vol[:, :-1, None],
                   statics[:, None, :].expand(N, T - 1, -1)], -1)
    theta = features(X, exponents(1 + statics.shape[1]))
    ok = torch.arange(T - 1, device=vol.device)[None] < lengths[:, None]
    theta, xdot, arm = theta[ok], xdot[ok], arms.to(torch.int64)[ok]
    return torch.stack([stlsq_ridge(theta[arm == a], xdot[arm == a],
                                    threshold, alpha, rel, dtype)
                        for a in range(n_arms)])
