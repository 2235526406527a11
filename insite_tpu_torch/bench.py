"""The north-star bench: simulate a 10,000-patient EQ_4_D PKPD cohort,
discover one ODE per treatment arm by STLSQ and fine-tune it per patient
(INSITE), on one CUDA card. The port of the repository's `bench.py`.

    python -m insite_tpu_torch.bench

Settings, from the environment as `bench.py` reads them:

  BENCH_MODE            'fused' (default): `harness/northstar.py::
                        fused_northstar`, the cohort on the device
                        throughout; 'standard': `PkpdDatasetCollection` ->
                        `SINDyRegressor.fit` -> the fine-tuned rollout ->
                        `normalised_masked_rmse`, each stage timed between
                        device synchronisations
  BENCH_PATIENTS        training patients (10,000)
  BENCH_DEVICE_REPEATS  fused mode: after the timed pass, sim+design+QR and
                        the fine-tune each run this many more times on the
                        inputs already on the device, and the least of
                        each is reported under ``device_time_s`` (2)
  BENCH_PLATFORM=cpu    run on the host, the metric's name suffixed
                        ``_cpu``; otherwise a CUDA card is required and its
                        absence raises

An untimed warm-up (the kernels' build at first use, a small cohort)
comes first. Stage times go to stderr; the last line of stdout is one
JSON object with `bench.py`'s keys: ``metric``, ``value`` (seconds),
``unit``, ``vs_baseline`` (the 60-s target of BASELINE.json over
``value``, above 1 when faster) and, in fused mode with repeats,
``device_time_s`` {sim_design, finetune, total}.
"""

from __future__ import annotations

import json
import os
import sys
from time import perf_counter

import torch

from insite_tpu_torch.data.collection import PkpdDatasetCollection
from insite_tpu_torch.eval.metrics import normalised_masked_rmse
from insite_tpu_torch.harness.northstar import _sync, fused_northstar
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
from insite_tpu_torch.utils.profiling import span

METRIC = 'eq4_10k_simulate_discover_finetune_wall_s'
TARGET_S = 60.0            # BASELINE.json: under 60 s for the whole workload


def _log(msg: str) -> None:
    print(f'[bench] {msg}', file=sys.stderr, flush=True)


def _device(env) -> tuple:
    """(device, metric suffix): the host with ``BENCH_PLATFORM=cpu``,
    otherwise the first CUDA card, whose absence raises."""
    if env.get('BENCH_PLATFORM') == 'cpu':
        return torch.device('cpu'), '_cpu'
    if not torch.cuda.is_available():
        raise RuntimeError('the bench runs on a CUDA card and none is '
                           'available; BENCH_PLATFORM=cpu runs it on the '
                           'host')
    return torch.device('cuda', 0), ''


def _fitted_insite(coll, device) -> SINDyRegressor:
    """INSITE on EQ_4_D, fitted on ``coll``'s training set, with
    `bench.py`'s settings (its ``bfgs_tol`` and ``bfgs_maxiter`` included:
    the Levenberg-Marquardt fine-tune ignores them, as in the JAX
    package)."""
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True,
                      bfgs_tol=1e-9, bfgs_maxiter=100)
    return SINDyRegressor(cfg, coll, device=device).fit(coll.train_f)


def _standard(n_train: int, seed: int, device) -> dict:
    """The collection -> fit -> fine-tune -> RMSE path, each stage a span
    (`utils/profiling.py`) that ends at a device synchronisation."""
    _sync(device)
    with span('collection') as sim:
        coll = PkpdDatasetCollection(
            conf_coeff=2.0, num_patients={'train': n_train, 'val': 100,
                                          'test': 2},
            equation_str='EQ_4_D', seed=seed, device=device)
        _sync(device)
    with span('fit') as fit:
        model = _fitted_insite(coll, device)
        _sync(device)
    with span('predict') as fine_tune:
        preds = model._fine_tuned_rollout(coll.train_f, projection_horizon=1)
        _sync(device)
    t_sim, t_fit, t_finetune = sim.seconds, fit.seconds, fine_tune.seconds
    rmse_orig, rmse_all = normalised_masked_rmse(coll.train_f, preds)
    return {'t_sim': t_sim, 't_fit': t_fit, 't_finetune': t_finetune,
            'total': t_sim + t_fit + t_finetune,
            'global_equation_string': model.global_equation_string,
            'rmse_orig': float(rmse_orig), 'rmse_all': float(rmse_all)}


def _warmup(mode: str, device) -> None:
    """Untimed: builds the kernels at their first launch and runs the
    mode's path once on a small cohort."""
    t0 = perf_counter()
    if mode == 'fused':
        fused_northstar(8, seed=1, device=device)
    else:
        coll = PkpdDatasetCollection(
            conf_coeff=2.0, num_patients={'train': 8, 'val': 4, 'test': 2},
            equation_str='EQ_4_D', seed=1, device=device)
        _fitted_insite(coll, device)._fine_tuned_rollout(
            coll.train_f, projection_horizon=1)
    _sync(device)
    _log(f'warmup (untimed: the kernels\' build at first use, a small '
         f'cohort): {perf_counter() - t0:.4f}s')


def main(env=None) -> dict:
    """Run the bench with the settings of ``env`` (``os.environ`` unless
    given), print the stage lines on stderr and the JSON object on the
    last line of stdout. Returns the record: the JSON object under
    ``line``, and ``mode``, ``device``, the factual ``rmse_orig`` and
    ``rmse_all`` (%), ``global_equation_string`` and the stage times."""
    env = os.environ if env is None else env
    mode = env.get('BENCH_MODE', 'fused')
    if mode not in ('fused', 'standard'):
        raise ValueError(f'BENCH_MODE={mode!r}; expected fused or standard')
    n_train = int(env.get('BENCH_PATIENTS', 10_000))
    device, suffix = _device(env)
    _log(f'device: {device}' + (f' ({torch.cuda.get_device_name(device)})'
                                if device.type == 'cuda' else ''))
    _warmup(mode, device)

    if mode == 'fused':
        repeats = int(env.get('BENCH_DEVICE_REPEATS', 2))
        r = fused_northstar(n_train, seed=0, equation_name='EQ_4_D',
                            projection_horizon=1,
                            device_time_repeats=repeats, device=device)
        _log(f"fused: sim+design+QR {r['t_sim_design']:.4f}s | host STLSQ "
             f"{r['t_stlsq']:.4f}s | fine-tune {r['t_finetune']:.4f}s | "
             f"metric {r['t_metric']:.4f}s")
        stages = {k: r[k] for k in ('t_sim_design', 't_stlsq', 't_finetune',
                                    't_metric')}
        if repeats > 0:
            _log(f"device-time (min of {repeats} repeats): sim+design+QR "
                 f"{r['device_sim_design_s']:.4f}s | fine-tune "
                 f"{r['device_finetune_s']:.4f}s")
            stages.update(device_sim_design_s=r['device_sim_design_s'],
                          device_finetune_s=r['device_finetune_s'])
    else:
        r = _standard(n_train, 0, device)
        _log(f"simulate+process: {r['t_sim']:.4f}s")
        _log(f"discovery (STLSQ x2 arms over {n_train}x59 samples): "
             f"{r['t_fit']:.4f}s")
        _log(f"INSITE fine-tune ({n_train} patients, batched "
             f"Levenberg-Marquardt): {r['t_finetune']:.4f}s")
        stages = {k: r[k] for k in ('t_sim', 't_fit', 't_finetune')}
    _log(r['global_equation_string'])
    _log(f"factual normalised RMSE: orig={r['rmse_orig']:.4f}% "
         f"all={r['rmse_all']:.4f}%")

    total = r['total']
    line = {'metric': METRIC + suffix, 'value': total, 'unit': 's',
            'vs_baseline': round(TARGET_S / total, 3)}
    if 'device_sim_design_s' in stages:
        line['device_time_s'] = {
            'sim_design': stages['device_sim_design_s'],
            'finetune': stages['device_finetune_s'],
            'total': (stages['device_sim_design_s']
                      + stages['device_finetune_s'])}
    print(json.dumps(line), flush=True)
    return {'line': line, 'mode': mode, 'device': str(device),
            'rmse_orig': r['rmse_orig'], 'rmse_all': r['rmse_all'],
            'global_equation_string': r['global_equation_string'],
            'stages': stages}


if __name__ == '__main__':
    main()
