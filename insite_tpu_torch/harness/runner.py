"""The sweep: enumerate (dataset, method, seed, gamma) runs, run each through
seed -> dataset collection -> fit -> 1-step RMSE -> n-step RMSEs, wall off
their faults, and log one row per run.

The '[Exp evaluation complete] {...}' log lines are the results database:
`harness/results.py::rows_from_log` and the JAX package's `df_from_log`
read them back. Every value in a row is a plain Python float, int, bool or
str, so the row's repr is a Python literal.

The port serves the MAIN_TABLE experiment for the ``sindy`` and
``insite`` methods on the EQ_4 family, cancer_sim and EQ_5; the rest
raises `NotImplementedError` naming the slice of ROADMAP.md that brings
it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import traceback
from enum import Enum

import numpy as np

from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.harness.config import (RunConfig, SINDY_ALPHA,
                                             model_dataset_name,
                                             sindy_params_for)
from insite_tpu_torch.harness.results import generate_main_results_table

logger = logging.getLogger('insite_tpu_torch')

METHODS = ('sindy', 'insite')
LATER_METHODS = {'wsindy': 'Slice 4', 'msm': 'Slice 5', 'ct': 'Slice 6',
                 'crn': 'Slice 6', 'rmsn': 'Slice 6', 'gnet': 'Slice 6',
                 'edct': 'Slice 6'}


class Experiment(Enum):
    MAIN_TABLE = 1
    INSIGHT_CONFOUNDING = 2
    ABLATION_ONE_ODE = 3
    ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS = 4
    INSIGHT_RECOVER_PARAMETRIC_DIST = 5
    INSIGHT_NOISE = 6
    INSIGHT_LESS_SAMPLES = 7


def _require_served(cfg: RunConfig, experiment: Experiment,
                    methods=()) -> None:
    """Raise for what this slice does not serve."""
    later = []
    if experiment != Experiment.MAIN_TABLE:
        later.append(f'experiment {experiment.name} (Slices 4 and 7)')
    for name in ('tune_hparams', 'load_from_cache', 'force_recache',
                 'isolate_runs'):
        if getattr(cfg, name):
            later.append(f'{name} (Slice 7)')
    for name in ('resume_log', 'metrics_jsonl'):
        if getattr(cfg, name):
            later.append(f'{name}={getattr(cfg, name)!r} (Slice 7)')
    later += [f'method {m} ({LATER_METHODS.get(m, "not in the JAX package")})'
              for m in methods if m not in METHODS]
    if later:
        raise NotImplementedError('not ported yet (ROADMAP.md): ' +
                                  ', '.join(later))


def _collection_for(dataset_name, method_name, seed, domain_conf,
                    cfg: RunConfig, *, device, dtype=None):
    """A fresh collection per run (the dataset cache is Slice 7); the
    SINDy family runs multiclass."""
    num_patients = {'train': cfg.train_samples, 'val': cfg.val_samples,
                    'test': cfg.test_samples}
    return make_collection(dataset_name, num_patients, seed,
                           coeff=float(domain_conf),
                           treatment_mode='multiclass',
                           cf_seq_mode=cfg.cf_seq_mode,
                           noise_scale=cfg.noise_scale, device=device,
                           dtype=dtype)


def _merged_overrides(cfg: RunConfig, method_name: str, dataset_name: str,
                      domain_conf: float) -> dict:
    """Flatten `cfg.model_overrides` for one run, least-specific key
    first (`<m>` < `<m>@<ds>` < `<m>@<ds>/<coeff>`)."""
    mo = cfg.model_overrides or {}
    coeff = '%g' % float(domain_conf)
    merged = {}
    for key in (method_name, f'{method_name}@{dataset_name}',
                f'{method_name}@{dataset_name}/{coeff}'):
        merged.update(mo.get(key, {}))
    return merged


def _apply_model_overrides(mcfg, cfg: RunConfig, method_name: str,
                           dataset_name: str, domain_conf: float):
    """Merge the run's `cfg.model_overrides` entries onto the model
    config."""
    merged = _merged_overrides(cfg, method_name, dataset_name, domain_conf)
    if not merged:
        return mcfg
    valid = {f.name for f in dataclasses.fields(mcfg)}
    unknown = set(merged) - valid
    if unknown:
        raise ValueError(f'unknown {type(mcfg).__name__} fields in '
                         f'model_overrides: {sorted(unknown)}')
    return dataclasses.replace(mcfg, **merged)


def _build_model(method_name, dataset_name, coll, cfg: RunConfig,
                 domain_conf: float = 2.0, *, device, dtype=None):
    """The SINDy-family estimator of one run (`method_name` sindy or
    insite), with the dataset's hyperparameters and the run's overlays. On
    EQ_5 the chemo dosage joins the covariates."""
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    if not coll.processed_data_multi:
        coll.process_data_multi(
            include_continuous_treatment='EQ_5' in dataset_name)
    thr, lam = sindy_params_for(dataset_name)
    mcfg = SINDyConfig(dataset_name=model_dataset_name(dataset_name),
                       sindy_threshold=thr,
                       sindy_alpha=SINDY_ALPHA, lam=lam,
                       insite=(method_name == 'insite'),
                       treatment_mode=coll.treatment_mode)
    mcfg = _apply_model_overrides(mcfg, cfg, method_name, dataset_name,
                                  domain_conf)
    return SINDyRegressor(mcfg, coll, device=device, dtype=dtype)


def run_experiment(dataset_name: str, method_name: str, seed: int,
                   domain_conf: float, cfg: RunConfig = None,
                   experiment: Experiment = Experiment.MAIN_TABLE, *,
                   device, dtype=None) -> dict:
    """One (dataset, method, seed, gamma) run on ``device``: fit on the
    training cohort, then the 1-step and the 2..(ph+1)-step
    counterfactual RMSEs (%) of the test cohort."""
    cfg = cfg or RunConfig()
    _require_served(cfg, experiment, (method_name,))
    t0 = time.perf_counter()
    coll = _collection_for(dataset_name, method_name, seed, domain_conf,
                           cfg, device=device, dtype=dtype)
    model = _build_model(method_name, dataset_name, coll, cfg, domain_conf,
                         device=device, dtype=dtype)
    model.fit(coll.train_f, coll.val_f)

    rmse_orig, rmse_all, rmse_last = model.get_normalised_masked_rmse(
        coll.test_cf_one_step, one_step_counterfactual=True)
    results = {'encoder_test_rmse_all': rmse_all,
               'encoder_test_rmse_orig': rmse_orig,
               'encoder_test_rmse_last': rmse_last}
    n_step = model.get_normalised_n_step_rmses(coll.test_cf_treatment_seq)
    results.update({f'decoder_test_rmse_{k + 2}-step': float(v)
                    for k, v in enumerate(np.asarray(n_step))})
    results['global_equation_string'] = model.global_equation_string
    results['fine_tuned'] = bool(model.insite)
    results.update({'method': method_name, 'seed': int(seed),
                    'seconds_taken': time.perf_counter() - t0})
    return results


def _plain(row: dict) -> dict:
    """Numpy scalars to Python's (the repr of np.float64 is not a
    literal); anything else that is not a plain scalar is an error."""
    out = {}
    for k, v in row.items():
        if isinstance(v, np.generic):
            v = v.item()
        if not isinstance(v, (bool, int, float, str)):
            raise TypeError(f'row value {k}={v!r} is not a plain float, '
                            'int, bool or str')
        out[k] = v
    return out


def _sweep_fingerprint(cfg: RunConfig, experiment_name: str) -> dict:
    return {
        'experiment': experiment_name, 'epochs': cfg.epochs,
        'train_samples': cfg.train_samples, 'val_samples': cfg.val_samples,
        'test_samples': cfg.test_samples, 'cf_seq_mode': cfg.cf_seq_mode,
        'noise_scale': cfg.noise_scale, 'tune_hparams': cfg.tune_hparams,
        'model_overrides': cfg.model_overrides or {},
    }


def sweep(cfg: RunConfig = None, experiment=Experiment.MAIN_TABLE,
          log=None, *, device, dtype=None):
    """The benchmark sweep on ``device`` with per-run fault isolation:
    with ``cfg.debug_mode`` a failing run raises, otherwise it becomes a
    row with ``errored=True``. Returns (rows, LaTeX tables by metric)."""
    cfg = cfg or RunConfig()
    log = log or logger
    if cfg.flush_mode:
        cfg.flush()
    _require_served(cfg, experiment, cfg.methods)

    args_for_runs = [(dataset_name, method_name, seed, cfg.domain_conf)
                     for seed in range(cfg.seed_start,
                                       cfg.seed_start + cfg.seed_runs)
                     for dataset_name in cfg.datasets
                     for method_name in cfg.methods]

    # a typo'd overlay key would otherwise silently apply nothing
    if cfg.model_overrides:
        possible = set()
        for ds, m, _, gamma in args_for_runs:
            possible |= {m, f'{m}@{ds}', f'{m}@{ds}/{"%g" % float(gamma)}'}
        unmatched = set(cfg.model_overrides) - possible
        if unmatched:
            log.warning(f'[sweep] model_overrides keys matching no run in '
                        f'this sweep: {sorted(unmatched)}')
    log.info('[Sweep config] ' + json.dumps(
        _sweep_fingerprint(cfg, experiment.name), sort_keys=True))

    rows = []
    for args in args_for_runs:
        dataset_name, method_name, seed, domain_conf = args
        log.info(f'[Now evaluating exp] {args}')
        try:
            result = run_experiment(dataset_name, method_name, seed,
                                    domain_conf, cfg, experiment,
                                    device=device, dtype=dtype)
            result['errored'] = False
        except Exception as e:          # the fault wall
            if cfg.debug_mode:
                raise
            log.exception(f'[Error] {e}')
            traceback.print_exc()
            result = {'errored': True}
        result.update({'dataset_name': dataset_name, 'seed': seed,
                       'method_name': method_name,
                       'domain_conf': domain_conf})
        result = _plain(result)
        log.info(f'[Exp evaluation complete] {result}')
        rows.append(result)
    return rows, generate_main_results_table(rows)
