"""Tumor-growth simulator core (Geng et al. 2017), shared by the
"cancer_sim" benchmark and the "continuous" EQ_5 A-D family.

The discrete daily update is

    V[t] = V[t-1] * (1 + rho*log(K/V[t-1]) - beta_c*C[t-1]
                     - (alpha*d[t-1] + beta*d[t-1]^2) + eps[t])

with a chemo concentration C that halves every day plus the applied dose,
a radio dose d in {0, 2}, and a sigmoid-confounded treatment assignment on
the mean tumour diameter of the last 15 days.

As in `insite_tpu.sim.tumor`, the cores take their random draws as
arguments, so parity tests feed both packages the same draws. Each core
carries the whole cohort through a Python loop over time on device
tensors: an ``alive`` (factual) or ``active`` (counterfactual) mask stands
for the reference's early exit on death or recovery, and a fixed-width
rolling buffer holds the diameter window. The counterfactual rows of every
(patient, prefix, plan) are then built at once as broadcast tensors.

The counterfactual generators window over the patient's own factual
history, as `insite_tpu.sim.tumor` documents (the reference indexes its
half-filled output buffer there).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

TUMOUR_CELL_DENSITY = 5.8e8
CHEMO_AMT = 5.0
RADIO_AMT = 2.0
DRUG_DECAY = float(np.exp(-np.log(2.0) / 1.0))   # 1-day half-life


def calc_volume(diameter):
    return 4.0 / 3.0 * np.pi * (diameter / 2.0) ** 3


def calc_diameter(volume):
    return ((volume / (4.0 / 3.0 * np.pi)) ** (1.0 / 3.0)) * 2.0


TUMOUR_DEATH_THRESHOLD = calc_volume(13.0)

PARAM_KEYS = ('initial_volumes', 'alpha', 'rho', 'beta', 'beta_c', 'K',
              'chemo_sigmoid_intercepts', 'radio_sigmoid_intercepts',
              'chemo_sigmoid_betas', 'radio_sigmoid_betas')


def _window_mean_diameter(buf, count: int, lag: int = 0):
    """Mean diameter over the ``count`` buffer entries ending ``lag`` slots
    before the buffer end (most recent last): the reference window
    volumes[max(t-w-lag, 0) : t-lag]. A zero count gives the diameter of a
    zero volume, 0."""
    W = buf.shape[-1]
    if count <= 0:
        return buf.new_zeros(buf.shape[0])
    diam = calc_diameter(buf[:, W - lag - count:W - lag])
    return diam.sum(-1) / count


def _volume_update(v, chemo, radio, alpha, beta, beta_c, rho, K, eps,
                   guard=0.0):
    # max(v, tiny) keeps masked (dead or recovered, v = 0) lanes finite;
    # active lanes are never that small, so the dynamics are unchanged
    v_safe = torch.clamp(v + guard, min=1e-30)
    growth = rho * torch.log(K / v_safe + guard)
    return v * (1.0 + growth - beta_c * chemo -
                (alpha * radio + beta * radio * radio) + eps)


def _assign(probs_rv, metric, sig_beta, sig_intercept):
    prob = 1.0 / (1.0 + torch.exp(-sig_beta * (metric - sig_intercept)))
    return probs_rv < prob, prob


def _cast(params, dtype):
    return {k: params[k].to(dtype) for k in PARAM_KEYS}


# ---------------------------------------------------------------------------
# factual cohort

def factual_core(params, rvs, seq_length: int, window_size: int, lag: int):
    """The factual cohort: ``params`` holds [B] tensors (`PARAM_KEYS`),
    ``rvs`` the draws noise, recovery, chemo_rv and radio_rv, each [B, T].
    Returns the trajectory arrays [B, T], the sequence lengths [B] and the
    death and recovery flags [B, T]."""
    dtype = rvs['noise'].dtype
    p = _cast(params, dtype)
    v0 = p['initial_volumes']
    B = v0.shape[0]
    dev = v0.device
    thr = TUMOUR_DEATH_THRESHOLD

    buf = torch.zeros((B, window_size + lag), dtype=dtype, device=dev)
    buf[:, -1] = v0
    v_prev = v0
    chemo_prev = torch.zeros(B, dtype=dtype, device=dev)
    radio_prev = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    outs = []
    for t in range(1, seq_length - 1):
        v_t = _volume_update(v_prev, chemo_prev, radio_prev, p['alpha'],
                             p['beta'], p['beta_c'], p['rho'], p['K'],
                             rvs['noise'][:, t])
        # the window over volumes [max(t-w-lag, 0), t-lag) excludes v_t and
        # the lag most recent entries; the buffer holds ..., v_{t-1}
        count = min(t - lag, window_size) if t >= lag else 0
        metric = _window_mean_diameter(buf, count, lag)
        chemo_app, chemo_p = _assign(rvs['chemo_rv'][:, t], metric,
                                     p['chemo_sigmoid_betas'],
                                     p['chemo_sigmoid_intercepts'])
        radio_app, radio_p = _assign(rvs['radio_rv'][:, t], metric,
                                     p['radio_sigmoid_betas'],
                                     p['radio_sigmoid_intercepts'])
        radio_dose = torch.where(radio_app, RADIO_AMT, 0.0).to(dtype)
        chemo_dose = chemo_prev * DRUG_DECAY + \
            torch.where(chemo_app, CHEMO_AMT, 0.0).to(dtype)

        died = v_t > thr
        v_t = torch.where(died, thr, v_t)
        recovered = ~died & (rvs['recovery'][:, t] <
                             torch.exp(-v_t * TUMOUR_CELL_DENSITY))
        v_t = torch.where(recovered, 0.0, v_t)

        def live(x):
            return torch.where(alive, x, 0.0)
        v_prev = live(v_t)
        chemo_prev = live(chemo_dose)
        radio_prev = live(radio_dose)
        outs.append((v_prev, chemo_prev, radio_prev,
                     live(chemo_app.to(dtype)), live(radio_app.to(dtype)),
                     live(chemo_p), live(radio_p), died & alive,
                     recovered & alive))
        alive = alive & ~(died | recovered)
        buf = torch.cat([buf[:, 1:], v_prev[:, None]], dim=1)

    (v_seq, cd_seq, rd_seq, ca_seq, ra_seq, cp_seq, rp_seq, died_seq,
     rec_seq) = [torch.stack(o, dim=1) for o in zip(*outs)]

    def padded(x, first=None):
        pad = torch.zeros((B, 1), dtype=dtype, device=dev)
        return torch.cat([pad if first is None else first, x, pad], dim=1)

    stopped = died_seq | rec_seq                          # [B, T-2]
    any_stop = stopped.any(dim=1)
    # argmax over int8 returns the first maximum, as jnp.argmax does
    stop_t = torch.argmax(stopped.to(torch.int8), dim=1) + 1
    seq_lengths = torch.where(any_stop, stop_t + 1, seq_length - 1)
    rows = torch.arange(B, device=dev)

    def flags(seq):
        out = torch.zeros((B, seq_length), dtype=dtype, device=dev)
        out[rows, stop_t] = (seq.any(dim=1) & any_stop).to(dtype)
        return out

    return dict(cancer_volume=padded(v_seq, v0[:, None]),
                chemo_dosage=padded(cd_seq), radio_dosage=padded(rd_seq),
                chemo_application=padded(ca_seq),
                radio_application=padded(ra_seq),
                chemo_probabilities=padded(cp_seq),
                radio_probabilities=padded(rp_seq),
                sequence_lengths=seq_lengths, death_flags=flags(died_seq),
                recovery_flags=flags(rec_seq))


# ---------------------------------------------------------------------------
# the counterfactual generators' factual branch (shared by the 1-step and
# the treatment-sequence sets: the loop starts at t = 0, volumes are clipped)

def cf_factual_core(params, rvs, seq_length: int, window_size: int,
                    lag: int):
    """Returns volumes [B, T] (V[t+1] emitted at step t, clipped), the
    dosages and applications at t [B, T-1], and ``active`` [B, T-1], the
    steps the reference loop processed (it breaks after emitting rows)."""
    dtype = rvs['noise'].dtype
    p = _cast(params, dtype)
    v0 = p['initial_volumes']
    B = v0.shape[0]
    dev = v0.device
    thr = TUMOUR_DEATH_THRESHOLD

    buf = torch.zeros((B, window_size + 1 + lag), dtype=dtype, device=dev)
    v_t = v0
    chemo_prev = torch.zeros(B, dtype=dtype, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    outs = []
    for t in range(seq_length - 1):
        # the window [max(t-w-lag, 0), t-lag+1) includes v_{t-lag}: up to
        # window_size + 1 entries, so v_t goes in first
        buf = torch.cat([buf[:, 1:], v_t[:, None]], dim=1)
        count = min(t - lag + 1, window_size + 1) if t >= lag else 0
        metric = _window_mean_diameter(buf, count, lag)
        chemo_app, _ = _assign(rvs['chemo_rv'][:, t], metric,
                               p['chemo_sigmoid_betas'],
                               p['chemo_sigmoid_intercepts'])
        radio_app, _ = _assign(rvs['radio_rv'][:, t], metric,
                               p['radio_sigmoid_betas'],
                               p['radio_sigmoid_intercepts'])
        radio_dose = torch.where(radio_app, RADIO_AMT, 0.0).to(dtype)
        chemo_dose = chemo_prev * DRUG_DECAY + \
            torch.where(chemo_app, CHEMO_AMT, 0.0).to(dtype)

        v_next = _volume_update(v_t, chemo_dose, radio_dose, p['alpha'],
                                p['beta'], p['beta_c'], p['rho'], p['K'],
                                rvs['noise'][:, t + 1])
        v_next = torch.clamp(v_next, 0.0, thr)
        stop = (v_next >= thr) | (rvs['recovery'][:, t] <=
                                  torch.exp(-v_next * TUMOUR_CELL_DENSITY))

        def live(x):
            return torch.where(active, x, 0.0)
        v_t = live(v_next)
        chemo_prev = live(chemo_dose)
        outs.append((v_t, chemo_prev, live(radio_dose),
                     live(chemo_app.to(dtype)), live(radio_app.to(dtype)),
                     active))
        active = active & ~stop

    v_seq, cd_seq, rd_seq, ca_seq, ra_seq, act_seq = \
        [torch.stack(o, dim=1) for o in zip(*outs)]
    return dict(volumes=torch.cat([v0[:, None], v_seq], dim=1),
                chemo_dosage=cd_seq, radio_dosage=rd_seq,
                chemo_application=ca_seq, radio_application=ra_seq,
                active=act_seq)


# ---------------------------------------------------------------------------
# counterfactual rows

# the option axis: (chemo, radio) in [(0,0), (0,1), (1,0), (1,1)] order
OPTIONS_CHEMO = (0.0, 0.0, 1.0, 1.0)
OPTIONS_RADIO = (0.0, 1.0, 0.0, 1.0)


def _per_patient(params, dtype, *extra_dims):
    """alpha, beta, beta_c, rho, K as [B, 1, ...] for broadcasting."""
    idx = (slice(None),) + (None,) * len(extra_dims)
    return [params[k].to(dtype)[idx]
            for k in ('alpha', 'beta', 'beta_c', 'rho', 'K')]


def cf_one_step_rows(params, fact: dict, noise, seq_length: int):
    """All (patient, prefix t, 4 treatment options) rows at once.

    The row of the factual option carries the clipped factual next volume;
    the three others the unclipped one-step counterfactual: the 4 rows the
    reference emits per processed step. Returns (volumes [B, T-1, 4, T],
    chemo_app, radio_app [B, T-1, 4, T], seq_lengths [B, T-1, 4],
    valid [B, T-1, 4])."""
    volumes = fact['volumes']                   # [B, T]
    dtype, dev = volumes.dtype, volumes.device
    B, T = volumes.shape
    alpha, beta, beta_c, rho, K = _per_patient(params, dtype, 1, 1)

    prev_chemo = torch.cat([torch.zeros((B, 1), dtype=dtype, device=dev),
                            fact['chemo_dosage'][:, :-1]], dim=1)
    opt_c = torch.tensor(OPTIONS_CHEMO, dtype=dtype, device=dev)
    opt_r = torch.tensor(OPTIONS_RADIO, dtype=dtype, device=dev)
    dose_c = prev_chemo[:, :, None] * DRUG_DECAY + CHEMO_AMT * opt_c
    dose_r = RADIO_AMT * opt_r + torch.zeros_like(dose_c)
    v_cf = _volume_update(volumes[:, :-1, None], dose_c, dose_r, alpha,
                          beta, beta_c, rho, K,
                          noise[:, 1:T, None])            # [B, T-1, 4]

    is_factual = (fact['chemo_application'][:, :, None] == opt_c) & \
                 (fact['radio_application'][:, :, None] == opt_r)
    last_val = torch.where(is_factual, volumes[:, 1:, None], v_cf)

    t_grid = torch.arange(T - 1, device=dev)[:, None]
    j_grid = torch.arange(T, device=dev)[None, :]
    in_prefix = (j_grid <= t_grid)[None, :, None, :]      # j <= t
    at_next = (j_grid == t_grid + 1)[None, :, None, :]
    vol_rows = torch.where(in_prefix, volumes[:, None, None, :], 0.0)
    vol_rows = torch.where(at_next, last_val[..., None], vol_rows)

    def app_rows(app_seq, opt):
        pad_app = nnf.pad(app_seq, (0, 1))                # width T
        rows = torch.where((j_grid < t_grid)[None, :, None, :],
                           pad_app[:, None, None, :], 0.0)
        return torch.where((j_grid == t_grid)[None, :, None, :],
                           opt[None, None, :, None], rows)

    chemo_rows = app_rows(fact['chemo_application'], opt_c)
    radio_rows = app_rows(fact['radio_application'], opt_r)
    seq_lengths = (t_grid[:, 0] + 1)[None, :, None].expand(B, T - 1, 4)
    valid = fact['active'][:, :, None].expand(B, T - 1, 4)
    return vol_rows, chemo_rows, radio_rows, seq_lengths, valid


def cf_seq_rows(params, fact: dict, plans, noise, seq_length: int, ph: int):
    """All (patient, prefix t, plan p) projection-horizon rows.

    plans: [B, T-1, P, ph, 2] binary (chemo, radio) plans. Each plan rolls
    ``ph`` tumour updates from the factual state V[t+1], the chemo
    concentration continuing from the factual dosage at t. Returns volumes
    [B, T-1, P, T+ph], the chemo and radio application and chemo dosage
    rows, seq_lengths [B, T-1, P] and valid [B, T-1, P]."""
    volumes = fact['volumes']
    dtype, dev = volumes.dtype, volumes.device
    B, T = volumes.shape
    P = plans.shape[2]
    alpha, beta, beta_c, rho, K = _per_patient(params, dtype, 1, 1)

    plans = plans.to(dtype)
    v = volumes[:, 1:T, None].expand(B, T - 1, P)
    chemo_prev = fact['chemo_dosage'][:, :, None].expand(B, T - 1, P)
    t_idx = torch.arange(T - 1, device=dev)
    cf_vols, cf_doses = [], []
    for pt in range(ph):
        dose_c = chemo_prev * DRUG_DECAY + CHEMO_AMT * plans[..., pt, 0]
        dose_r = RADIO_AMT * plans[..., pt, 1]
        eps = noise[:, t_idx + 2 + pt][:, :, None]   # noise[current_t + 1]
        v = _volume_update(v, dose_c, dose_r, alpha, beta, beta_c, rho, K,
                           eps, guard=1e-7)
        cf_vols.append(v)
        cf_doses.append(dose_c)
        chemo_prev = dose_c
    cf_vols = torch.stack(cf_vols, dim=-1)             # [B, T-1, P, ph]
    cf_doses = torch.stack(cf_doses, dim=-1)

    T_out = T + ph
    full = (B, T - 1, P, T_out)
    t_grid = torch.arange(T - 1, device=dev)[:, None]
    j_grid = torch.arange(T_out, device=dev)[None, :]
    base = torch.where((j_grid <= t_grid + 1)[None, :, None, :],
                       nnf.pad(volumes, (0, ph))[:, None, None, :], 0.0)
    k = j_grid - (t_grid + 2)
    cf_part = torch.gather(
        cf_vols, -1, torch.clamp(k, 0, ph - 1)[None, :, None, :].expand(full))
    in_cf = ((k >= 0) & (k < ph))[None, :, None, :]
    vol_rows = torch.where(in_cf, cf_part, base)

    ka = j_grid - (t_grid + 1)
    ka_idx = torch.clamp(ka, 0, ph - 1)[None, :, None, :].expand(full)
    in_plan = ((ka >= 0) & (ka < ph))[None, :, None, :]

    def assemble(fact_seq, plan_vals):
        pad_f = nnf.pad(fact_seq, (0, T_out - fact_seq.shape[1]))
        rows = torch.where((j_grid <= t_grid)[None, :, None, :],
                           pad_f[:, None, None, :], 0.0)
        return torch.where(in_plan, torch.gather(plan_vals, -1, ka_idx),
                           rows)

    chemo_rows = assemble(fact['chemo_application'], plans[..., 0])
    radio_rows = assemble(fact['radio_application'], plans[..., 1])
    dose_rows = assemble(fact['chemo_dosage'], cf_doses)

    seq_lengths = (t_grid[:, 0] + 1 + ph)[None, :, None].expand(B, T - 1, P)
    valid = fact['active'][:, :, None] & ~torch.isnan(vol_rows).any(-1)
    # The reference drops any row whose cf trajectory holds a NaN: with its
    # log guard log(K/(V+1e-7)+1e-7), a volume V <= -1e-7 at any non-final
    # plan step NaNs the next update (a negative final value is kept).
    # _volume_update keeps negative volumes finite, so the drop is explicit.
    if ph > 1:
        valid = valid & ~(cf_vols[..., :ph - 1] + 1e-7 <= 0.0).any(-1)
    return vol_rows, chemo_rows, radio_rows, dose_rows, seq_lengths, valid
