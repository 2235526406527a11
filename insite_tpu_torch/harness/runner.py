"""The sweep: enumerate (dataset, method, seed, gamma[, setting]) runs, run
each through seed -> dataset collection -> fit -> 1-step RMSE -> n-step
RMSEs, wall off their faults, and log one row per run.

The '[Exp evaluation complete] {...}' log lines are the results database:
`harness/results.py::rows_from_log` and the JAX package's `df_from_log`
read them back. Every value in a row is a plain Python float, int, bool or
str, or a (nested) list of such, so the row's repr is a Python literal.

The port serves all nine methods of the JAX package (``sindy``,
``wsindy``, ``insite``, ``msm``, ``ct``, ``crn``, ``rmsn``, ``gnet`` and
``edct``) on the EQ_4 family, cancer_sim and EQ_5, in all seven
experiments:
MAIN_TABLE, ABLATION_ONE_ODE (one joint ODE over multilabel treatments),
ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS (the degree-4 library),
INSIGHT_RECOVER_PARAMETRIC_DIST (the per-patient coefficient distribution
of the validation cohort) and the three robustness sweeps on the EQ_4
family, INSIGHT_CONFOUNDING (gamma over ``cfg.domain_confs`` on EQ_4_D),
INSIGHT_NOISE (the observation-noise scale over ``cfg.noise_scales`` on
EQ_4_B) and INSIGHT_LESS_SAMPLES (the training cohort over
``cfg.train_sample_grid`` on EQ_4_D). A method the JAX package does not
have raises `NotImplementedError`. A collection with a vitals stream (a
`RealDatasetCollection`, which no entry point builds) gives ct and gnet
their ``dim_vitals``; crn, rmsn and edct take its width from the
collection.

Around the runs, as in the JAX package: ``tune_hparams`` tunes on the
validation cohort before the test metrics (`harness/tuning.py`: insite's
lam grid in one stacked fine-tune, the neural methods' grid or
successive-halving search), ``load_from_cache`` keeps collections on disk
(`harness/cache.py`), ``resume_log`` reuses the completed rows of an
earlier sweep's log whose config fingerprints all match, ``isolate_runs``
runs each run or column in a fresh interpreter (`harness/isolated.py`),
and ``metrics_jsonl`` names the JSONL sink every run writes its metrics to
(`harness/metrics_logger.py`).

`vectorized_sweep` (``run.py --vectorized``) runs each (dataset, method)
column of seeds as one batch (`harness/vectorized.py` for the ODE methods,
`harness/vectorized_msm.py` for msm, `harness/vectorized_neural.py` for
the neural baselines, each stage of which trains as one seed-stacked fit)
and logs the same per-seed rows, marked ``'vectorized': True``.

A run's collection (`_collection_for`) and its processing and estimator
(`_build_model`) are the tracer's spans 'collection' and 'processing'
(`utils/profiling.py`); the estimator's own spans follow.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import traceback
from enum import Enum

import numpy as np
import torch

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.harness import cache, isolated, tuning
from insite_tpu_torch.harness.config import (RunConfig, SINDY_ALPHA,
                                             model_dataset_name,
                                             sindy_params_for)
from insite_tpu_torch.harness.insights import recover_parametric_dist
from insite_tpu_torch.harness.metrics_logger import MetricsLogger
from insite_tpu_torch.harness.results import (_read_sweep_fingerprints,
                                              generate_main_results_table,
                                              rows_from_log)
from insite_tpu_torch.models import crn, ct, edct, gnet, rmsn
from insite_tpu_torch.utils.profiling import span

logger = logging.getLogger('insite_tpu_torch')

SINDY_METHODS = ('sindy', 'insite', 'wsindy')
# the methods whose collection the encoder processing serves
ENCODER_METHODS = ('crn', 'edct', 'rmsn')
METHODS = SINDY_METHODS + ('msm', 'ct', 'gnet') + ENCODER_METHODS
# the methods with a `vectorized_sweep` column: all nine, in the JAX
# package's order
VECTORIZED_METHODS = ('insite', 'sindy', 'wsindy', 'ct', 'crn', 'edct',
                      'rmsn', 'gnet', 'msm')


# method -> (estimator, config)
NEURAL_MODELS = {'ct': (ct.CausalTransformer, ct.CTConfig),
                 'crn': (crn.CRN, crn.CRNConfig),
                 'rmsn': (rmsn.RMSN, rmsn.RMSNConfig),
                 'gnet': (gnet.GNet, gnet.GNetConfig),
                 'edct': (edct.EDCT, edct.EDCTConfig)}


class Experiment(Enum):
    MAIN_TABLE = 1
    INSIGHT_CONFOUNDING = 2
    ABLATION_ONE_ODE = 3
    ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS = 4
    INSIGHT_RECOVER_PARAMETRIC_DIST = 5
    INSIGHT_NOISE = 6
    INSIGHT_LESS_SAMPLES = 7


# these run (dataset, method, seed) cells of ``cfg.datasets`` at one gamma;
# the other three sweep gamma, the noise scale or the cohort size on one
# fixed EQ_4 dataset
TABLE_EXPERIMENTS = (Experiment.MAIN_TABLE, Experiment.ABLATION_ONE_ODE,
                     Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS,
                     Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST)


def _require_served(methods) -> None:
    """Raise for a method the JAX package does not have."""
    unknown = [f'method {m} (not in the JAX package)'
               for m in methods if m not in METHODS]
    if unknown:
        raise NotImplementedError('not ported (ROADMAP.md): ' +
                                  ', '.join(unknown))


@span('collection')
def _collection_for(dataset_name, method_name, seed, domain_conf,
                    cfg: RunConfig, experiment=Experiment.MAIN_TABLE, *,
                    device, dtype=None):
    """The run's collection: simulated, or with ``cfg.load_from_cache``
    read from the disk cache, where a simulated one is also stored (and
    with ``cfg.force_recache`` stored without reading). The SINDy family
    runs multiclass, and multilabel under ABLATION_ONE_ODE, whose joint
    library reads the raw treatment columns; every other method runs
    multilabel."""
    if method_name in SINDY_METHODS and \
            experiment != Experiment.ABLATION_ONE_ODE:
        treatment_mode = 'multiclass'
    else:
        treatment_mode = 'multilabel'
    num_patients = {'train': cfg.train_samples, 'val': cfg.val_samples,
                    'test': cfg.test_samples}
    # the JAX package's key, plus where and in what type the cohort was
    # drawn: the EQ_4 generators draw on the collection's device
    key = (dataset_name, treatment_mode, seed, float(domain_conf),
           tuple(sorted(num_patients.items())), cfg.cf_seq_mode,
           cfg.noise_scale, torch.device(device).type,
           str(resolve_float(dtype)))
    if cfg.load_from_cache and not cfg.force_recache:
        coll = cache.get_cached(key)
        if coll is not None:
            return coll
    coll = make_collection(dataset_name, num_patients, seed,
                           coeff=float(domain_conf),
                           treatment_mode=treatment_mode,
                           cf_seq_mode=cfg.cf_seq_mode,
                           noise_scale=cfg.noise_scale, device=device,
                           dtype=dtype)
    if cfg.load_from_cache or cfg.force_recache:
        cache.put_cached(key, coll)
    return coll


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


def _dims_from_collection(coll, with_vitals=False) -> dict:
    """The model-config dimensions a processed collection gives; with
    ``with_vitals``, also ``dim_vitals`` where it has a vitals stream."""
    d = coll.train_f.data
    dims = dict(dim_outcome=d['outputs'].shape[-1],
                dim_treatments=d['current_treatments'].shape[-1],
                dim_static_features=d['static_features'].shape[-1])
    if with_vitals and 'vitals' in d:
        dims['dim_vitals'] = d['vitals'].shape[-1]
    return dims


@span('processing')
def _build_model(method_name, dataset_name, coll, cfg: RunConfig,
                 domain_conf: float = 2.0,
                 experiment=Experiment.MAIN_TABLE, *, device, dtype=None,
                 seed: int = 0):
    """The estimator of one run, with the run's overlays: for `method_name`
    sindy, wsindy or insite a `SINDyRegressor` with the dataset's
    hyperparameters and the experiment's ablation, on ``device``; for msm
    an `MSM`, a host model in float64 whatever ``device`` and ``dtype``;
    for ct, crn, rmsn, gnet and edct the networks on ``device`` in
    ``dtype`` (float32 unless named), trained for ``cfg.epochs`` from
    ``seed`` (gnet with ``cfg.gnet_mc_samples`` Monte-Carlo rollouts).
    The collections of crn, edct and rmsn take the encoder processing,
    every other the multi-input one. On EQ_5 the chemo dosage joins the
    covariates of the SINDy family only."""
    if method_name in ENCODER_METHODS:
        if not coll.processed_data_encoder:
            coll.process_data_encoder()
    elif not coll.processed_data_multi:
        coll.process_data_multi(
            include_continuous_treatment=('EQ_5' in dataset_name and
                                          method_name in SINDY_METHODS))
    if method_name in NEURAL_MODELS:
        model_cls, cfg_cls = NEURAL_MODELS[method_name]
        if method_name == 'gnet':
            fields = dict(mc_samples=cfg.gnet_mc_samples,
                          **_dims_from_collection(coll, with_vitals=True))
        else:
            fields = dict(treatment_mode=coll.treatment_mode,
                          **_dims_from_collection(
                              coll, with_vitals=(method_name == 'ct')))
        mcfg = cfg_cls(epochs=cfg.epochs, seed=seed, **fields)
        return model_cls(_apply_model_overrides(mcfg, cfg, method_name,
                                                dataset_name, domain_conf),
                         coll, device=device, dtype=dtype)
    if method_name == 'msm':
        from insite_tpu_torch.models.msm import MSM, MSMConfig
        mcfg = MSMConfig(max_epochs=cfg.epochs,
                         **_dims_from_collection(coll))
        return MSM(_apply_model_overrides(mcfg, cfg, method_name,
                                          dataset_name, domain_conf), coll)
    if method_name not in SINDY_METHODS:
        raise NotImplementedError(method_name)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    thr, lam = sindy_params_for(dataset_name)
    mcfg = SINDyConfig(dataset_name=model_dataset_name(dataset_name),
                       sindy_threshold=thr,
                       sindy_alpha=SINDY_ALPHA, lam=lam,
                       insite=(method_name == 'insite'),
                       wsindy=(method_name == 'wsindy'),
                       joint_model=(experiment == Experiment.ABLATION_ONE_ODE),
                       ablation_more_complex_basis_functions=(
                           experiment ==
                           Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS),
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
    counterfactual RMSEs (%) of the test cohort. With ``cfg.tune_hparams``
    a neural method is fitted by a search over its grid and its row
    starts with ``tuned_hparams``; insite's lam is tuned after the fit and
    its row starts with ``tuned_lam``. Under
    INSIGHT_RECOVER_PARAMETRIC_DIST an insite run adds the mean and std of
    the validation cohort's fine-tuned coefficients and, on the EQ_4
    family, how well they recover the hidden decay constants. With
    ``cfg.metrics_jsonl`` the run's params and metrics go to that sink."""
    cfg = cfg or RunConfig()
    _require_served((method_name,))
    t0 = time.perf_counter()
    coll = _collection_for(dataset_name, method_name, seed, domain_conf,
                           cfg, experiment, device=device, dtype=dtype)
    results = {}
    if cfg.tune_hparams and method_name in tuning.NEURAL_HPARAM_GRIDS:
        # a search on the validation factual RMSE; the winner is evaluated
        def build_and_fit(params_):
            mo = dict(cfg.model_overrides or {})
            mo[method_name] = {**mo.get(method_name, {}), **params_}
            cfg_t = dataclasses.replace(cfg, model_overrides=mo)
            m = _build_model(method_name, dataset_name, coll, cfg_t,
                             domain_conf, experiment, device=device,
                             dtype=dtype, seed=seed)
            m.fit(coll.train_f, coll.val_f)
            return m

        space = tuning.NEURAL_HPARAM_GRIDS[method_name]
        if cfg.tune_algo == 'sha':
            best_params, model, _ = tuning.successive_halving_search(
                build_and_fit, space, coll.val_f, n_trials=cfg.tune_trials,
                seed=seed, max_budget=cfg.epochs,
                min_budget=max(1, cfg.epochs // 9))
        else:
            best_params, model, _ = tuning.grid_search(
                build_and_fit, space, coll.val_f, n_trials=cfg.tune_trials,
                seed=seed)
        results['tuned_hparams'] = best_params
    else:
        model = _build_model(method_name, dataset_name, coll, cfg,
                             domain_conf, experiment, device=device,
                             dtype=dtype, seed=seed)
        model.fit(coll.train_f, coll.val_f)
    if cfg.tune_hparams and method_name == 'insite':
        # the whole lam grid scored on the validation cohort in one
        # fine-tune
        results['tuned_lam'], _ = tuning.tune_insite_lam(model, coll.val_f)

    rmse_orig, rmse_all, rmse_last = model.get_normalised_masked_rmse(
        coll.test_cf_one_step, one_step_counterfactual=True)
    results.update({'encoder_test_rmse_all': rmse_all,
                    'encoder_test_rmse_orig': rmse_orig,
                    'encoder_test_rmse_last': rmse_last})
    n_step = model.get_normalised_n_step_rmses(coll.test_cf_treatment_seq)
    results.update({f'decoder_test_rmse_{k + 2}-step': float(v)
                    for k, v in enumerate(np.asarray(n_step))})
    if hasattr(model, 'global_equation_string'):
        results['global_equation_string'] = model.global_equation_string
        results['fine_tuned'] = bool(getattr(model, 'insite', False))
    if method_name == 'rmsn':
        # which stabilized-weight formula the row ran
        results['sw_mode'] = model.cfg.sw_mode
    if experiment == Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST and \
            method_name == 'insite':
        c = model.get_fine_tuned_coefficients(coll.val_f)
        # accumulated and rounded in float64, so the log's literals are
        # 6-decimal numbers in float32 runs too
        c = np.asarray(c, np.float64)
        results['coef_mean'] = np.mean(c, axis=0).round(6).tolist()
        results['coef_std'] = np.std(c, axis=0).round(6).tolist()
        if 'hidden_C_0' in (getattr(coll.val_f, 'sim_params', None) or {}):
            # the one fine-tune above serves the recovery too
            rec = recover_parametric_dist(model, coll.val_f, coefs=c)
            for arm, stats in rec.items():
                for k, v in stats.items():
                    results[f'recover_{arm}_{k}'] = v
    results.update({'method': method_name, 'seed': int(seed),
                    'seconds_taken': time.perf_counter() - t0})
    if cfg.metrics_jsonl:
        ml = MetricsLogger(cfg.metrics_jsonl,
                           run_name=f'{method_name}-{dataset_name}-{seed}')
        ml.log_params({'dataset_name': dataset_name, 'method': method_name,
                       'seed': seed, 'domain_conf': domain_conf})
        ml.log_metrics(results)
        ml.finish()
    return results


def _plain_value(k, v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, (list, tuple)):
        return [_plain_value(k, x) for x in v]
    if isinstance(v, dict):
        return {kk: _plain_value(k, x) for kk, x in v.items()}
    if not isinstance(v, (bool, int, float, str)):
        raise TypeError(f'row value {k}={v!r} is not a plain float, int, '
                        'bool or str, nor a list or dict of such')
    return v


def _plain(row: dict) -> dict:
    """Numpy scalars to Python's (the repr of np.float64 is not a
    literal), also inside (nested) lists and dicts (a neural run's
    ``tuned_hparams``); anything else that is not a plain scalar is an
    error."""
    return {k: _plain_value(k, v) for k, v in row.items()}


def _sweep_fingerprint(cfg: RunConfig, experiment_name: str) -> dict:
    return {
        'experiment': experiment_name, 'epochs': cfg.epochs,
        'train_samples': cfg.train_samples, 'val_samples': cfg.val_samples,
        'test_samples': cfg.test_samples, 'cf_seq_mode': cfg.cf_seq_mode,
        'noise_scale': cfg.noise_scale, 'tune_hparams': cfg.tune_hparams,
        'model_overrides': cfg.model_overrides or {},
    }


def _log_fingerprint(cfg: RunConfig, experiment_name: str, log) -> None:
    log.info('[Sweep config] ' + json.dumps(
        _sweep_fingerprint(cfg, experiment_name), sort_keys=True))


# the INSIGHT grids' fields: part of a resumed run's key, not of the
# fingerprint a resumed log must match
GRID_FIELDS = ('noise_scale', 'train_samples')


def _resume_key(ds, method, seed, gamma, overrides) -> tuple:
    extra = tuple(sorted((k, float(v)) for k, v in overrides.items()))
    return (ds, method, int(seed), float(gamma), extra)


def _completed_runs(cfg: RunConfig, experiment: Experiment, fingerprint,
                    prev_fps, log) -> dict:
    """{resume key: row} of the completed (not errored) runs logged in
    ``cfg.resume_log``, or {} where any sweep config in that log differs
    from ``fingerprint`` (except, in the INSIGHT sweeps, on their grid
    fields): rows written under other settings are never reused. Cells
    logged as NaN are dropped from a reused row."""
    skip = set(GRID_FIELDS) if experiment.name.startswith('INSIGHT_') \
        else set()
    mismatch = {}
    for prev_fp in prev_fps:
        for k in fingerprint:
            if k not in skip and prev_fp.get(k) != fingerprint[k]:
                mismatch[k] = prev_fp.get(k)
    if not prev_fps:
        log.warning(f'[Resume] {cfg.resume_log} carries no [Sweep config] '
                    f'fingerprint (pre-fingerprint log); reusing rows '
                    f'WITHOUT config verification')
    if mismatch:
        log.warning(
            f'[Resume] REFUSING to reuse rows from {cfg.resume_log}: one of '
            f'its {len(prev_fps)} sweep config(s) differs on '
            f'{sorted(mismatch)} (theirs={mismatch} vs ours='
            f'{ {k: fingerprint[k] for k in mismatch} }); all runs will '
            f'execute fresh')
        return {}
    done = {}
    for row in rows_from_log(cfg.resume_log):
        if row.get('errored', False):
            continue
        row = {k: v for k, v in row.items()
               if not (v == 'nan' or (isinstance(v, float) and np.isnan(v)))}
        ov = {k: row[k] for k in GRID_FIELDS if k in row}
        done[_resume_key(row['dataset_name'], row['method_name'],
                         row['seed'], row['domain_conf'], ov)] = row
    log.info(f'[Resume] {len(done)} completed runs found in '
             f'{cfg.resume_log}')
    return done


def _enumerate_runs(cfg: RunConfig, experiment: Experiment) -> list:
    """The sweep's runs in order: ``(dataset, method, seed, gamma)`` and,
    where the experiment sweeps a field of the config, a fifth entry
    ``{field: value}`` that overrides it for the run and joins its row.
    Seeds are outermost, methods innermost."""
    seeds = range(cfg.seed_start, cfg.seed_start + cfg.seed_runs)
    if experiment in TABLE_EXPERIMENTS:
        return [(dataset_name, method_name, seed, cfg.domain_conf)
                for seed in seeds
                for dataset_name in cfg.datasets
                for method_name in cfg.methods]
    if experiment == Experiment.INSIGHT_CONFOUNDING:
        return [('EQ_4_D', method_name, seed, domain_conf)
                for seed in seeds
                for domain_conf in cfg.domain_confs
                for method_name in cfg.methods]
    if experiment == Experiment.INSIGHT_NOISE:
        # observation-noise robustness on the noisy EQ_4 variant
        return [('EQ_4_B', method_name, seed, cfg.domain_conf,
                 {'noise_scale': noise_scale})
                for seed in seeds
                for noise_scale in cfg.noise_scales
                for method_name in cfg.methods]
    if experiment == Experiment.INSIGHT_LESS_SAMPLES:
        # sample efficiency on EQ_4_D
        return [('EQ_4_D', method_name, seed, cfg.domain_conf,
                 {'train_samples': n_train})
                for seed in seeds
                for n_train in cfg.train_sample_grid
                for method_name in cfg.methods]
    raise ValueError(experiment)


def sweep(cfg: RunConfig = None, experiment=Experiment.MAIN_TABLE,
          log=None, *, device, dtype=None):
    """The benchmark sweep on ``device`` with per-run fault isolation:
    with ``cfg.debug_mode`` a failing run raises, otherwise it becomes a
    row with ``errored=True``. With ``cfg.resume_log`` the completed runs
    of that log are re-logged and reused, not run; with
    ``cfg.isolate_runs`` each run executes in a fresh interpreter. Returns
    (rows, LaTeX tables by metric)."""
    cfg = cfg or RunConfig()
    log = log or logger
    if cfg.flush_mode:
        cfg.flush()
    _require_served(cfg.methods)

    args_for_runs = _enumerate_runs(cfg, experiment)

    # a typo'd overlay key would otherwise silently apply nothing
    if cfg.model_overrides:
        possible = set()
        for run_args in args_for_runs:
            ds, m, _, gamma = run_args[:4]
            possible |= {m, f'{m}@{ds}', f'{m}@{ds}/{"%g" % float(gamma)}'}
        unmatched = set(cfg.model_overrides) - possible
        if unmatched:
            log.warning(f'[sweep] model_overrides keys matching no run in '
                        f'this sweep: {sorted(unmatched)}')
    fingerprint = _sweep_fingerprint(cfg, experiment.name)
    # read the resumed log before logging ours: resuming into the same log
    # file must not see its own fingerprint
    prev_fps = _read_sweep_fingerprints(cfg.resume_log) \
        if cfg.resume_log else []
    _log_fingerprint(cfg, experiment.name, log)
    done = _completed_runs(cfg, experiment, fingerprint, prev_fps, log) \
        if cfg.resume_log else {}

    rows = []
    for args in args_for_runs:
        dataset_name, method_name, seed, domain_conf = args[:4]
        overrides = args[4] if len(args) > 4 else {}
        key = _resume_key(dataset_name, method_name, seed, domain_conf,
                          overrides)
        if key in done:
            # re-logged, so the new log is complete on its own
            log.info(f'[Exp evaluation complete] {done[key]}')
            rows.append(done[key])
            continue
        run_cfg = dataclasses.replace(cfg, **overrides) if overrides else cfg
        log.info(f'[Now evaluating exp] {args}')
        try:
            run = isolated.run_isolated if run_cfg.isolate_runs \
                else run_experiment
            result = run(dataset_name, method_name, seed, domain_conf,
                         run_cfg, experiment, device=device, dtype=dtype)
            result['errored'] = False
            result.update(overrides)
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


# ---------------------------------------------------------------------------
# --vectorized: one batch per (dataset, method) column of seeds

class ColumnSkipped(Exception):
    """A (dataset, method) vectorized column has no path (wsindy outside
    the EQ_4 family, as the JAX package skips it)."""


def _vectorized_column(cfg: RunConfig, dataset_name: str, method_name: str,
                       log=logger, *, device, dtype=None):
    """One (dataset, method) vectorized column of ``cfg.seed_runs`` seeds
    on ``device``. Returns ``(r, seeds)``: metric name -> np.ndarray [S],
    and the seed of each entry. Raises ColumnSkipped where the column has
    no path. msm and the neural columns run seeds ``cfg.seed_start`` ..;
    the ODE columns seeds 0..S-1."""
    from insite_tpu_torch.harness import vectorized
    from insite_tpu_torch.harness import vectorized_neural as vn
    from insite_tpu_torch.harness.vectorized_msm import vectorized_msm_sweep
    S = cfg.seed_runs
    if method_name == 'msm' or method_name in NEURAL_MODELS:
        kw = dict(n_seeds=S,
                  num_patients={'train': cfg.train_samples,
                                'val': cfg.val_samples,
                                'test': cfg.test_samples},
                  coeff=cfg.domain_conf, epochs=cfg.epochs,
                  seed_start=cfg.seed_start, cf_seq_mode=cfg.cf_seq_mode,
                  noise_scale=cfg.noise_scale,
                  model_overrides=_merged_overrides(
                      cfg, method_name, dataset_name, cfg.domain_conf),
                  device=device, dtype=dtype)
        if method_name == 'msm':
            r = vectorized_msm_sweep(dataset_name, **kw)
        elif method_name == 'ct':
            r = vn.vectorized_ct_sweep(dataset_name, **kw)
        elif method_name in ('crn', 'edct'):
            r = vn.vectorized_enc_dec_sweep(method_name, dataset_name, **kw)
        elif method_name == 'rmsn':
            r = vn.vectorized_rmsn_sweep(dataset_name, **kw)
        else:
            r = vn.vectorized_gnet_sweep(
                dataset_name, mc_samples=cfg.gnet_mc_samples, **kw)
        return r, list(range(cfg.seed_start, cfg.seed_start + S))
    if method_name == 'wsindy' and 'EQ_4' not in dataset_name:
        raise ColumnSkipped('wsindy runs on the EQ_4 family only; skipping '
                            f'{dataset_name}')
    thr, lam = sindy_params_for(dataset_name)
    if cfg.seed_start:
        log.warning('[vectorized] ODE columns always run seeds 0..S-1; '
                    'ignoring seed_start')
    kw = dict(n_seeds=S, n_train=cfg.train_samples, n_test=cfg.test_samples,
              threshold=thr, alpha=SINDY_ALPHA, lam=lam, method=method_name,
              device=device, dtype=dtype)
    if 'EQ_4' in dataset_name:
        r = vectorized.vectorized_eq4_sweep(
            dataset_name, conf_coeff=cfg.domain_conf, **kw)
    else:
        r = vectorized.vectorized_tumor_sweep(dataset_name,
                                              coeff=cfg.domain_conf, **kw)
    return r, list(range(S))


def _seed_row(r: dict, i: int, S: int) -> dict:
    """The metrics of entry ``i`` of a column: every [S] array of ``r``,
    in its order."""
    return {k: float(v[i]) for k, v in r.items()
            if isinstance(v, np.ndarray) and v.ndim == 1 and len(v) == S}


def _errored(cfg: RunConfig, e: Exception, log, dataset_name: str,
             method_name: str, **setting) -> dict:
    """The fault wall of a column: with ``cfg.debug_mode`` re-raise,
    otherwise log the error and return the column's errored row."""
    if cfg.debug_mode:
        raise e
    log.exception(f'[Error] {e}')
    traceback.print_exc()
    return {'errored': True, 'dataset_name': dataset_name,
            'method_name': method_name, 'seed': -1,
            'domain_conf': cfg.domain_conf, **setting}


def _vectorized_confounding_sweep(cfg: RunConfig, log, *, device,
                                  dtype=None) -> list:
    """INSIGHT_CONFOUNDING under --vectorized: a column of seeds per gamma
    of ``cfg.domain_confs`` for each ODE method on EQ_4_D, logged as
    per-seed rows (``domain_conf`` set per gamma)."""
    from insite_tpu_torch.harness.vectorized import \
        vectorized_confounding_sweep
    rows = []
    for method_name in cfg.methods:
        if method_name not in SINDY_METHODS:
            log.warning(f'[vectorized] INSIGHT_CONFOUNDING has a '
                        f'vectorized path for the ODE methods only; '
                        f'skipping {method_name}')
            continue
        S = cfg.seed_runs
        thr, lam = sindy_params_for('EQ_4_D')
        log.info(f'[Now evaluating exp] (vectorized confounding, EQ_4_D, '
                 f'{method_name}, gammas={tuple(cfg.domain_confs)}, '
                 f'{S} seeds)')
        t0 = time.perf_counter()
        try:
            r = vectorized_confounding_sweep(
                'EQ_4_D', gammas=tuple(float(g) for g in cfg.domain_confs),
                n_seeds=S, n_train=cfg.train_samples,
                n_test=cfg.test_samples, method=method_name, threshold=thr,
                alpha=SINDY_ALPHA, lam=lam, device=device, dtype=dtype)
            secs = time.perf_counter() - t0
            n_rows = len(r['gammas']) * S
            for gi, gamma in enumerate(r['gammas']):
                for s in range(S):
                    row = {k: float(v[gi, s]) for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 2}
                    row.update({'method': method_name, 'seed': s,
                                'seconds_taken': secs / n_rows,
                                'vectorized': True, 'errored': False,
                                'dataset_name': 'EQ_4_D',
                                'method_name': method_name,
                                'domain_conf': float(gamma)})
                    log.info(f'[Exp evaluation complete] {row}')
                    rows.append(row)
        except Exception as e:          # the fault wall
            rows.append(_errored(cfg, e, log, 'EQ_4_D', method_name))
    return rows


def _vectorized_grid_sweep(cfg: RunConfig, log, *, device,
                           dtype=None) -> list:
    """INSIGHT_NOISE (EQ_4_B over ``cfg.noise_scales``) and
    INSIGHT_LESS_SAMPLES (EQ_4_D over ``cfg.train_sample_grid``): a column
    of seeds per grid point for each ODE method, logged as per-seed rows
    with the grid's ``noise_scale`` or ``train_samples``."""
    from insite_tpu_torch.harness.vectorized import vectorized_eq4_sweep
    noise_exp = cfg.experiment == 'INSIGHT_NOISE'
    dataset = 'EQ_4_B' if noise_exp else 'EQ_4_D'
    grid = cfg.noise_scales if noise_exp else cfg.train_sample_grid
    grid_key = 'noise_scale' if noise_exp else 'train_samples'
    rows = []
    for method_name in cfg.methods:
        if method_name not in SINDY_METHODS:
            log.warning(f'[vectorized] {cfg.experiment} has a vectorized '
                        f'path for the ODE methods only; skipping '
                        f'{method_name}')
            continue
        S = cfg.seed_runs
        thr, lam = sindy_params_for(dataset)
        for g in grid:
            log.info(f'[Now evaluating exp] (vectorized {cfg.experiment}, '
                     f'{dataset}, {method_name}, {grid_key}={g}, '
                     f'{S} seeds)')
            t0 = time.perf_counter()
            try:
                kw = dict(n_seeds=S, n_test=cfg.test_samples,
                          conf_coeff=cfg.domain_conf, threshold=thr,
                          alpha=SINDY_ALPHA, lam=lam, method=method_name,
                          device=device, dtype=dtype)
                if noise_exp:
                    kw.update(n_train=cfg.train_samples,
                              noise_scale=float(g))
                else:
                    kw.update(n_train=int(g))
                r = vectorized_eq4_sweep(dataset, **kw)
                secs = time.perf_counter() - t0
                for s in range(S):
                    row = _seed_row(r, s, S)
                    row.update({'method': method_name, 'seed': s,
                                'seconds_taken': secs / S,
                                'vectorized': True, 'errored': False,
                                'dataset_name': dataset,
                                'method_name': method_name,
                                'domain_conf': cfg.domain_conf,
                                grid_key: float(g)})
                    log.info(f'[Exp evaluation complete] {row}')
                    rows.append(row)
            except Exception as e:      # the fault wall
                rows.append(_errored(cfg, e, log, dataset, method_name,
                                     **{grid_key: float(g)}))
    return rows


def vectorized_sweep(cfg: RunConfig = None, log=None, *, device,
                     dtype=None):
    """``run.py --vectorized``: each (dataset, method) column of seeds
    runs as one batch on ``device`` and is logged as per-seed rows with
    the JAX package's keys (``'vectorized': True``, ``seconds_taken`` the
    column's seconds over its seeds, and on rmsn rows ``sw_mode``), which
    `rows_from_log` reads back. ODE columns run seeds 0..S-1; msm and the
    neural columns honour ``seed_start``.
    INSIGHT_CONFOUNDING runs a column per gamma, INSIGHT_NOISE and
    INSIGHT_LESS_SAMPLES one per grid point; every other experiment runs
    the main table's columns, each in a fresh interpreter with
    ``cfg.isolate_runs``. With ``cfg.debug_mode`` a failing column
    raises, otherwise it becomes one errored row (not logged as a result),
    as in the JAX package, whose vectorized sweep also ignores
    ``flush_mode`` and ``resume_log``. Returns (rows, LaTeX tables by
    metric)."""
    cfg = cfg or RunConfig()
    log = log or logger
    _require_served(cfg.methods)
    _log_fingerprint(cfg, cfg.experiment, log)
    if cfg.experiment == 'INSIGHT_CONFOUNDING':
        rows = _vectorized_confounding_sweep(cfg, log, device=device,
                                             dtype=dtype)
    elif cfg.experiment in ('INSIGHT_NOISE', 'INSIGHT_LESS_SAMPLES'):
        rows = _vectorized_grid_sweep(cfg, log, device=device, dtype=dtype)
    else:
        rows = []
        for dataset_name in cfg.datasets:
            for method_name in cfg.methods:
                rows += _vectorized_main_column(cfg, dataset_name,
                                                method_name, log,
                                                device=device, dtype=dtype)
    rows = [_plain(r) for r in rows]
    return rows, generate_main_results_table(rows)


def _vectorized_main_column(cfg: RunConfig, dataset_name: str,
                            method_name: str, log, *, device,
                            dtype=None) -> list:
    """The rows of one main-table column: one per seed, or one errored
    row, or none where the column is skipped."""
    S = cfg.seed_runs
    log.info(f'[Now evaluating exp] (vectorized, {dataset_name}, '
             f'{method_name}, {S} seeds)')
    t0 = time.perf_counter()
    rows = []
    try:
        if cfg.isolate_runs:
            r, seeds = isolated.run_isolated_column(
                dataset_name, method_name, cfg, device=device, dtype=dtype)
        else:
            r, seeds = _vectorized_column(cfg, dataset_name, method_name,
                                          log, device=device, dtype=dtype)
        secs = time.perf_counter() - t0
        for i, seed in enumerate(seeds):
            row = _seed_row(r, i, S)
            row.update({'method': method_name, 'seed': seed,
                        'seconds_taken': secs / S, 'vectorized': True,
                        'errored': False, 'dataset_name': dataset_name,
                        'method_name': method_name,
                        'domain_conf': cfg.domain_conf})
            if method_name == 'rmsn':
                # which stabilized-weight formula the column ran
                row['sw_mode'] = _merged_overrides(
                    cfg, method_name, dataset_name, cfg.domain_conf).get(
                        'sw_mode', rmsn.RMSNConfig.sw_mode)
            log.info(f'[Exp evaluation complete] {row}')
            rows.append(row)
    except ColumnSkipped as e:
        log.warning(f'[vectorized] {e}')
    except Exception as e:              # the fault wall
        rows.append(_errored(cfg, e, log, dataset_name, method_name))
    return rows
