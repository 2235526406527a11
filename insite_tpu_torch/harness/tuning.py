"""Hyperparameter tuning on the validation cohort.

- `tune_insite_lam`: INSITE tunes one hparam, the proximal penalty lam.
  The validation rows are stacked once per grid value on the batch axis and
  go through ONE fine-tune with a penalty per row, so the whole grid costs
  the kernel launches of one fine-tune (``gn_iters + 1`` sensitivity
  launches and one rollout over G x n_val rows).
- `grid_search`: a seeded, subsampled grid search for the neural
  baselines, sequential trials with per-trial fault isolation (a trial that
  raises is retried, then recorded as errored), selecting on validation
  factual RMSE ('val_rmse_all').
- `successive_halving_search`: the adaptive variant; small epoch budgets
  first, the best third promoted to a budget three times larger.

Grids, trial order and selection are those of `insite_tpu.harness.tuning`.
"""

from __future__ import annotations

import itertools
import logging
import traceback

import numpy as np
import torch

from insite_tpu_torch.eval.metrics import normalised_masked_rmse

logger = logging.getLogger('insite_tpu_torch')

INSITE_LAM_GRID = (0.0, 10.0, 100.0, 200.0, 500.0, 1000.0, 2000.0)

# Neural search spaces: learning rate, batch size, hidden widths and dropout
# around each model's defaults. Keys are fields of the model configs
# (models/<m>.py), so the same dicts drive `model_overrides`.
NEURAL_HPARAM_GRIDS = {
    'ct': {'learning_rate': [0.01, 0.001, 0.0001],
           'batch_size': [64, 128, 256],
           'seq_hidden_units': [8, 16, 32, 64],
           'br_size': [8, 16, 32, 64],
           'fc_hidden_units': [16, 32, 64, 128],
           'dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'crn': {'enc_learning_rate': [0.01, 0.001, 0.0001],
            'enc_batch_size': [64, 128, 256],
            'enc_seq_hidden_units': [12, 24, 48, 96],
            'enc_br_size': [3, 6, 12, 24],
            'enc_fc_hidden_units': [9, 18, 36, 72],
            'enc_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5],
            'dec_learning_rate': [0.01, 0.001, 0.0001],
            'dec_batch_size': [256, 512, 1024],
            'dec_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'edct': {'enc_learning_rate': [0.01, 0.001, 0.0001],
             'enc_batch_size': [64, 128, 256],
             'enc_seq_hidden_units': [8, 16, 32, 64],
             'enc_br_size': [8, 16, 32, 64],
             'enc_fc_hidden_units': [16, 32, 64, 128],
             'enc_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5],
             'dec_learning_rate': [0.01, 0.001, 0.0001],
             'dec_batch_size': [256, 512, 1024],
             'dec_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'rmsn': {'enc_lr': [0.01, 0.001, 0.0001],
             'enc_bs': [64, 128, 256],
             'enc_hidden': [6, 12, 24, 48],
             'enc_dropout': [0.1, 0.2, 0.3, 0.4, 0.5],
             'dec_lr': [0.01, 0.001, 0.0001],
             'dec_hidden': [16, 32, 64, 128],
             'dec_dropout': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'gnet': {'learning_rate': [0.01, 0.001, 0.0001],
             'batch_size': [64, 128, 256],
             'seq_hidden_units': [12, 24, 48, 96],
             'r_size': [3, 6, 12, 24],
             'fc_hidden_units': [24, 48, 96, 192],
             'dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
}


def tune_insite_lam(model, val_f, lam_grid=INSITE_LAM_GRID,
                    projection_horizon=1):
    """Pick the proximal penalty lam minimising the validation factual
    RMSE ('rmse_all', %) of a fitted INSITE `SINDyRegressor`.

    Every lam of the grid is scored by ONE fine-tune: the validation rows
    stacked len(lam_grid) times on the batch axis, each copy with its lam,
    through the prediction path's inputs (smoothing, clip, active set,
    one-ODE fold, row chunks). With an empty support nothing moves, so
    every lam scores the same and the first wins, as in the JAX package.
    Sets ``model.cfg.lam`` to the winner and returns
    (best_lam, {lam: rmse_all})."""
    preds, _ = model._fine_tune(val_f, projection_horizon,
                                lam_grid=lam_grid)
    n = preds.shape[0] // len(lam_grid)
    lengths = model._tensor(
        np.tile(np.asarray(val_f.data['sequence_lengths']).astype(np.int64),
                len(lam_grid)), torch.int64)
    preds = model._scaled_numpy(preds, lengths, val_f)
    scores = {}
    for g, lam in enumerate(lam_grid):
        _, rmse_all = normalised_masked_rmse(val_f, preds[g * n:(g + 1) * n])
        scores[float(lam)] = float(rmse_all)
    best = min(scores, key=scores.get)
    logger.info(f'[tune_insite_lam] grid scores (val rmse_all %): {scores} '
                f'-> lam={best}')
    model.cfg.lam = best
    return best, scores


def grid_points(space: dict, n_trials=None, seed=0):
    """Enumerate a grid (name -> list of values) into trial param dicts.
    With ``n_trials``, subsample the full product uniformly without
    replacement under ``seed``."""
    names = sorted(space)
    full = [dict(zip(names, vals))
            for vals in itertools.product(*(space[n] for n in names))]
    if n_trials is None or n_trials >= len(full):
        return full
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(full), size=n_trials, replace=False)
    return [full[i] for i in idx]


def _fit_and_score(build_and_fit, params, val_f, max_failures, tag):
    """(model, val rmse_all) of one trial, retried up to ``max_failures``
    times; (None, None) if every attempt raised."""
    for attempt in range(max_failures):
        try:
            model = build_and_fit(dict(params))
            _, rmse = model.get_normalised_masked_rmse(val_f)
            return model, rmse
        except Exception:
            logger.warning(f'[{tag}] trial {params} attempt {attempt + 1} '
                           f'failed:\n{traceback.format_exc()}')
    return None, None


def successive_halving_search(build_and_fit, space: dict, val_f,
                              n_trials=16, seed=0, eta=3, min_budget=10,
                              max_budget=100, budget_key='epochs',
                              max_failures=3):
    """Sample ``n_trials`` configs from the grid, fit each at a small
    ``budget_key`` budget, keep the top 1/eta by validation factual RMSE,
    multiply the budget by eta, and repeat until ``max_budget``; a lone
    survivor below it is refit at ``max_budget``.

    `build_and_fit(params)` receives the trial params with the current
    budget under ``budget_key``. Returns (best_params, best_model, trials);
    best_model is trained at ``max_budget``."""
    configs = grid_points(space, n_trials, seed)
    budget, rung, trials = min_budget, 0, []
    while True:
        scored = []
        for params in configs:
            p = {**params, budget_key: int(budget)}
            model, rmse = _fit_and_score(build_and_fit, p, val_f,
                                         max_failures, 'sha')
            trials.append({**p, 'rung': rung, 'val_rmse_all': rmse})
            logger.info(f'[sha] rung {rung} ({budget} {budget_key}) '
                        f'{params} -> val_rmse_all={rmse}')
            if rmse is not None:
                scored.append((rmse, params, model))
        if not scored:
            raise RuntimeError('successive_halving_search: every trial in '
                               f'rung {rung} errored')
        scored.sort(key=lambda t: t[0])
        if budget >= max_budget or len(scored) == 1:
            if budget < max_budget:      # lone survivor: refit at full
                p = {**scored[0][1], budget_key: int(max_budget)}
                model = build_and_fit(dict(p))
                _, rmse = model.get_normalised_masked_rmse(val_f)
                scored = [(rmse, scored[0][1], model)]
                trials.append({**p, 'rung': rung + 1,
                               'val_rmse_all': rmse})
            best = scored[0]
            logger.info(f'[sha] best {best[1]} '
                        f'(val_rmse_all={best[0]:.4f})')
            return dict(best[1]), best[2], trials
        keep = max(1, len(scored) // eta)
        configs = [p for _, p, _ in scored[:keep]]
        budget = min(max_budget, budget * eta)
        rung += 1


def grid_search(build_and_fit, space: dict, val_f, n_trials=None, seed=0,
                max_failures=3):
    """Sequential seeded search over ``space``.

    `build_and_fit(params) -> estimator` returns a fitted estimator; the
    selection metric is the validation factual rmse_all. Returns
    (best_params, best_model, trials), trials a list of
    {**params, 'val_rmse_all': float | None}."""
    trials, best = [], (None, None, np.inf)
    for params in grid_points(space, n_trials, seed):
        model, rmse = _fit_and_score(build_and_fit, params, val_f,
                                     max_failures, 'grid_search')
        trials.append({**params, 'val_rmse_all': rmse})
        logger.info(f'[grid_search] {params} -> val_rmse_all={rmse}')
        if rmse is not None and rmse < best[2]:
            best = (dict(params), model, rmse)
    if best[0] is None:
        raise RuntimeError('grid_search: every trial errored')
    logger.info(f'[grid_search] best {best[0]} (val_rmse_all={best[2]:.4f})')
    return best[0], best[1], trials
