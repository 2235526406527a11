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
``cfg.train_sample_grid`` on EQ_4_D). The sweep's tuning, cache, resume,
isolation and metrics-sink settings, and collections with a vitals stream,
raise `NotImplementedError` naming the slice of ROADMAP.md that brings
them.

`vectorized_sweep` (``run.py --vectorized``) runs each (dataset, method)
column of seeds as one batch (`harness/vectorized.py` for the ODE methods,
`harness/vectorized_msm.py` for msm, `harness/vectorized_neural.py` for
the neural baselines, each stage of which trains as one seed-stacked fit)
and logs the same per-seed rows, marked ``'vectorized': True``.
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
from insite_tpu_torch.harness.insights import recover_parametric_dist
from insite_tpu_torch.harness.results import generate_main_results_table
from insite_tpu_torch.models import crn, ct, edct, gnet, rmsn
from insite_tpu_torch.models.base import VITALS_NOT_PORTED

logger = logging.getLogger('insite_tpu_torch')

SINDY_METHODS = ('sindy', 'insite', 'wsindy')
# the methods whose collection the encoder processing serves
ENCODER_METHODS = ('crn', 'edct', 'rmsn')
METHODS = SINDY_METHODS + ('msm', 'ct', 'gnet') + ENCODER_METHODS


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


def _require_served(cfg: RunConfig, methods=()) -> None:
    """Raise for what the port does not serve yet: the sweep settings of
    Slice 7c, and for a method the JAX package does not have."""
    later = []
    for name in ('tune_hparams', 'load_from_cache', 'force_recache',
                 'isolate_runs'):
        if getattr(cfg, name):
            later.append(f'{name} (Slice 7c)')
    for name in ('resume_log', 'metrics_jsonl'):
        if getattr(cfg, name):
            later.append(f'{name}={getattr(cfg, name)!r} (Slice 7c)')
    later += [f'method {m} (not in the JAX package)'
              for m in methods if m not in METHODS]
    if later:
        raise NotImplementedError('not ported yet (ROADMAP.md): ' +
                                  ', '.join(later))


def _collection_for(dataset_name, method_name, seed, domain_conf,
                    cfg: RunConfig, experiment=Experiment.MAIN_TABLE, *,
                    device, dtype=None):
    """A fresh collection per run (the dataset cache is Slice 7c). The
    SINDy family runs multiclass, and multilabel under ABLATION_ONE_ODE,
    whose joint library reads the raw treatment columns; every other method
    runs multilabel."""
    if method_name in SINDY_METHODS and \
            experiment != Experiment.ABLATION_ONE_ODE:
        treatment_mode = 'multiclass'
    else:
        treatment_mode = 'multilabel'
    num_patients = {'train': cfg.train_samples, 'val': cfg.val_samples,
                    'test': cfg.test_samples}
    return make_collection(dataset_name, num_patients, seed,
                           coeff=float(domain_conf),
                           treatment_mode=treatment_mode,
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


def _dims_from_collection(coll, with_vitals=False) -> dict:
    """The model-config dimensions a processed collection gives. With
    ``with_vitals`` a vitals stream would add ``dim_vitals``; it is not
    ported yet and raises."""
    d = coll.train_f.data
    if with_vitals and 'vitals' in d:
        raise NotImplementedError(VITALS_NOT_PORTED)
    return dict(dim_outcome=d['outputs'].shape[-1],
                dim_treatments=d['current_treatments'].shape[-1],
                dim_static_features=d['static_features'].shape[-1])


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
    counterfactual RMSEs (%) of the test cohort. Under
    INSIGHT_RECOVER_PARAMETRIC_DIST an insite run adds the mean and std of
    the validation cohort's fine-tuned coefficients and, on the EQ_4
    family, how well they recover the hidden decay constants."""
    cfg = cfg or RunConfig()
    _require_served(cfg, (method_name,))
    t0 = time.perf_counter()
    coll = _collection_for(dataset_name, method_name, seed, domain_conf,
                           cfg, experiment, device=device, dtype=dtype)
    model = _build_model(method_name, dataset_name, coll, cfg, domain_conf,
                         experiment, device=device, dtype=dtype, seed=seed)
    model.fit(coll.train_f, coll.val_f)

    rmse_orig, rmse_all, rmse_last = model.get_normalised_masked_rmse(
        coll.test_cf_one_step, one_step_counterfactual=True)
    results = {'encoder_test_rmse_all': rmse_all,
               'encoder_test_rmse_orig': rmse_orig,
               'encoder_test_rmse_last': rmse_last}
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
    return results


def _plain_value(k, v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, (list, tuple)):
        return [_plain_value(k, x) for x in v]
    if not isinstance(v, (bool, int, float, str)):
        raise TypeError(f'row value {k}={v!r} is not a plain float, int, '
                        'bool or str, nor a list of such')
    return v


def _plain(row: dict) -> dict:
    """Numpy scalars to Python's (the repr of np.float64 is not a
    literal), also inside (nested) lists; anything else that is not a
    plain scalar is an error."""
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
    row with ``errored=True``. Returns (rows, LaTeX tables by metric)."""
    cfg = cfg or RunConfig()
    log = log or logger
    if cfg.flush_mode:
        cfg.flush()
    _require_served(cfg, cfg.methods)

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
    _log_fingerprint(cfg, experiment.name, log)

    rows = []
    for args in args_for_runs:
        dataset_name, method_name, seed, domain_conf = args[:4]
        overrides = args[4] if len(args) > 4 else {}
        run_cfg = dataclasses.replace(cfg, **overrides) if overrides else cfg
        log.info(f'[Now evaluating exp] {args}')
        try:
            result = run_experiment(dataset_name, method_name, seed,
                                    domain_conf, run_cfg, experiment,
                                    device=device, dtype=dtype)
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
    the main table's columns. With ``cfg.debug_mode`` a failing column
    raises, otherwise it becomes one errored row (not logged as a result),
    as in the JAX package, whose vectorized sweep also ignores
    ``flush_mode``. Returns (rows, LaTeX tables by metric)."""
    cfg = cfg or RunConfig()
    log = log or logger
    _require_served(cfg, cfg.methods)
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
        r, seeds = _vectorized_column(cfg, dataset_name, method_name, log,
                                      device=device, dtype=dtype)
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
