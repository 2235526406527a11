"""INSIGHT_RECOVER_PARAMETRIC_DIST analysis: does INSITE's per-patient
fine-tune recover the simulator's hidden parametric distribution?

The per-patient recovered decay rates are correlated against the EQ_4
simulator's true hidden decay constants (``hidden_C_<a>`` of
`sim/pkpd.py::get_standard_params`). Numpy on the host, as
`insite_tpu.harness.insights`.

EQ_4's truth is dy/dt = -C_a(patient) * y under the patient's fixed arm,
with C linear in the observed statics for variants C and D plus
per-patient noise for D. The library's inputs of the per-arm EQ_4 fit are
[x0, statics...] (named x0, u0, u1), so the discovered arm equation is
x_dot = (c_x0 + sum_j c_{x0 u_j} s_j) x0 + ..., and the per-patient decay
constant is minus the x0-gradient at the patient's unscaled statics.
Columns that multiply the same regressor values within a fit are only
identified through their sum, which the gradient takes.
"""

from __future__ import annotations

import numpy as np


def recovered_arm_rates(coefs: np.ndarray, feature_names,
                        input_values: dict) -> np.ndarray:
    """Per-patient recovered decay constants -(d x_dot / d x0), [B, A].

    ``coefs``: the [B, A, F] fine-tuned coefficients
    (`SINDyRegressor.get_fine_tuned_coefficients`); ``feature_names``: the
    library's column names (`PolynomialLibrary.feature_names`);
    ``input_values``: each non-x0 input name (e.g. 'u0') to its
    patient-constant [B] values, the unscaled statics. x_dot must be linear
    in x0 (the degree-2 interaction-only library): a feature with x0 to a
    higher power raises."""
    coefs = np.asarray(coefs)
    B, A, _ = coefs.shape
    rates = np.zeros((B, A), coefs.dtype)
    for i, name in enumerate(feature_names):
        parts = name.split()
        if any(p.startswith('x0^') for p in parts):
            raise ValueError(
                f'feature {name!r} is nonlinear in x0; the decay-constant '
                'read-off applies to the degree-2 interaction-only library')
        if 'x0' not in parts:
            continue
        val = np.ones(B, coefs.dtype)
        for p in parts:
            if p != 'x0':
                val = val * np.asarray(input_values[p])
        rates -= coefs[:, :, i] * val[:, None]
    return rates


def recover_parametric_dist(model, dataset, raw: bool = False,
                            coefs=None) -> dict:
    """Correlate recovered and true per-arm decay constants on ``dataset``.

    ``model``: a fitted INSITE `SINDyRegressor`; ``dataset``: a factual
    EQ_4-family `SeqDataset` whose ``sim_params`` carry the generator's
    hidden per-patient constants ('hidden_C_0', 'hidden_C_1'); ``coefs``:
    the dataset's fine-tuned coefficients [B, A, F] where the caller has
    them already (else they are computed here, one more fine-tune).
    Patients count for the arm they spend active time under (EQ_4 arms are
    fixed per patient; the fine-tune leaves unvisited arms at the global
    coefficients).

    Returns {'arm<a>': {'n', 'true_mean', 'true_std', 'recovered_mean',
    'recovered_std', 'pearson_r'}}; with ``raw`` each arm also carries the
    per-patient 'true' and 'recovered' lists."""
    params = getattr(dataset, 'sim_params', None)
    if params is None or 'hidden_C_0' not in params:
        raise ValueError(
            'dataset has no hidden decay constants to recover '
            '(EQ_4-family factual subsets carry sim_params)')
    if coefs is None:
        coefs = model.get_fine_tuned_coefficients(dataset)
    coefs = np.asarray(coefs)
    B, A, _ = coefs.shape
    _, statics, _, _ = model._unscaled_arrays(dataset)
    statics = np.asarray(statics)[:B]
    names = model._input_names()
    input_values = {n: statics[:, j] for j, n in enumerate(names[1:])}
    rates = recovered_arm_rates(
        coefs, model.library.feature_names(names), input_values)

    treatments = np.asarray(dataset.data['current_treatments'])[:B]
    active = np.asarray(dataset.data['active_entries'])[:B]
    time_in_arm = (treatments * active).sum(1)          # [B, A]

    out = {}
    for a in range(A):
        true = np.asarray(params[f'hidden_C_{a}'])[:B]
        mask = time_in_arm[:, a] > 0
        t, r = true[mask], rates[mask, a]
        corr = float(np.corrcoef(t, r)[0, 1]) if mask.sum() > 1 else np.nan
        out[f'arm{a}'] = {
            'n': int(mask.sum()),
            'true_mean': float(t.mean()), 'true_std': float(t.std()),
            'recovered_mean': float(r.mean()),
            'recovered_std': float(r.std()),
            'pearson_r': corr,
        }
        if raw:
            out[f'arm{a}']['true'] = t.tolist()
            out[f'arm{a}']['recovered'] = r.tolist()
    return out
