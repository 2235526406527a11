"""The vectorized seed columns of the ODE methods (`harness/vectorized.py`)
against the JAX package, in float64 on the CPU: the batched masked-ridge
`stlsq` (rtol 1e-10), `weak_sindy_fit_select` (rtol 1e-8), the fine-tune
with per-row global models over the union of their supports against one
fine-tune per seed (rtol 1e-10), and the EQ_4 column core fed the JAX
package's cohorts against its `_one_seed` (RMSEs rtol 1e-6, coefficients
rtol 1e-8); the port's vectorized EQ_4 cohort against its collection's
(bit for bit); `vectorized_sweep`'s rows against the JAX runner's, the
skipped and the not-yet-ported columns, and the CLI; and, the counterpart
of the JAX package's `test_sweep_sharded_over_mesh_matches_single_device`,
the port's `vectorized_eq4_sweep` with its seeds sharded over a mesh of 2
and of 8 CPU devices against the unsharded column (rtol 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.core.constants import MAX_VALUE as JAX_MAX_VALUE
from insite_tpu.discovery import wsindy as jax_wsindy
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.discovery.stlsq import stlsq as jax_stlsq
from insite_tpu.harness import vectorized as jax_vec
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.runner import vectorized_sweep as jax_vectorized_sweep
from insite_tpu.models.sindy import SINDyConfig as JaxSINDyConfig
from insite_tpu.models.sindy import _eq4_design as jax_eq4_design
from insite_tpu.sim import pkpd as jax_pkpd
from insite_tpu_torch import run
from insite_tpu_torch.data.collection import PkpdDatasetCollection
from insite_tpu_torch.discovery import wsindy
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import stlsq
from insite_tpu_torch.harness import runner, vectorized
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.logging_utils import create_logger_in_process
from insite_tpu_torch.harness.results import rows_from_log
from insite_tpu_torch.models.sindy import (insite_gn_finetune_predict,
                                           support)

F64 = dict(device='cpu', dtype=torch.float64)
N_TRAIN, N_TEST, T, PH = 40, 2, 60, 5
torch.set_num_threads(1)


def t64(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _regression(seed, n=400):
    """An EQ_4-like design: near-collinear statics, x_dot = -1.05 x0 u0
    (- 0.14 x0 on odd seeds) + noise, ragged 0/1 weights."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.rand(n) * 40 + 1, 0.5 + 0.05 * rng.randn(n),
                  0.5 + 0.05 * rng.randn(n)], axis=-1)
    theta = np.array(JaxLibrary(n_inputs=3)(jnp.asarray(X)))
    y = -1.05 * X[:, 0] * X[:, 1] - 0.14 * (seed % 2) * X[:, 0] + \
        0.01 * rng.randn(n)
    return theta, y, (rng.rand(n) > 0.2).astype(np.float64)


@pytest.mark.parametrize('weighted', [True, False])
def test_stlsq_batched_over_seeds_matches_jax(weighted):
    problems = [_regression(s) for s in range(3)]
    theta, y, w = (np.stack(p) for p in zip(*problems))
    coefs, masks = stlsq(t64(theta), t64(y), 0.1, 0.5,
                         sample_weight=t64(w) if weighted else None)
    assert coefs.shape == masks.shape == (3, 7)
    for s in range(3):
        ref_c, ref_m = jax_stlsq(jnp.asarray(theta[s]), jnp.asarray(y[s]),
                                 0.1, 0.5,
                                 sample_weight=(jnp.asarray(w[s])
                                                if weighted else None))
        np.testing.assert_array_equal(masks[s], np.asarray(ref_m))
        np.testing.assert_allclose(coefs[s], np.asarray(ref_c), rtol=1e-10,
                                   atol=1e-13)
    assert masks[1, 1] and not masks[0, 1]       # the seeds' supports differ


def _jax_eq4_cohort(seed, equation_str='EQ_4_D', conf_coeff=2.0,
                    n_train=N_TRAIN, n_test=N_TEST):
    """A seed's EQ_4 cohorts as the JAX package's `_one_seed` draws them
    (vectorized.py:44-62), in the port's flat cohort layout, float64."""
    equation = jax_pkpd.Equation[equation_str]
    add_noise = equation.name.split('_')[-1] in ('B', 'C', 'D')
    key = jax.random.PRNGKey(seed)

    def cohort(n, mode):
        k, sub = jax.random.split(key)
        params = dict(jax_pkpd.get_standard_params(n, equation, sub))
        params['observation_noise'] = jax_pkpd.OBSERVATION_NOISE
        params['sigmoid_intercept'] = JAX_MAX_VALUE / 2.0
        params['sigmoid_gamma'] = conf_coeff / JAX_MAX_VALUE
        _, sub = jax.random.split(k)
        statics = np.stack([params['observed_static_c_0'],
                            params['observed_static_c_1']], -1)
        if mode == 'factual':
            vol, treat, lengths = jax_pkpd._simulate_factual_full(
                params, sub, T, add_noise, dtype=jnp.float64)[:3]
            return (t64(vol), t64(treat), t64(lengths, torch.int64),
                    t64(statics))
        if mode == 'one_step':
            out = jax_pkpd._simulate_cf_1_step_full(params, sub, T,
                                                    add_noise,
                                                    dtype=jnp.float64)
        else:
            out = jax_pkpd._simulate_cf_seq_full(
                params, sub, T, PH, 'sliding_treatment', add_noise,
                dtype=jnp.float64)
        rows, actions, lengths, st0, st1 = (np.asarray(x) for x in out)
        W = rows.shape[-1]
        return (t64(rows.reshape(-1, W)),
                t64(actions.reshape(-1, W)[:, :-1], torch.int64),
                t64(lengths.reshape(-1), torch.int64),
                t64(np.stack([st0, st1], -1)), None)

    return {'train': cohort(n_train, 'factual'),
            'one_step': cohort(n_test, 'one_step'),
            'n_step': cohort(n_test, 'n_step')}


def test_weak_sindy_fit_select_matches_jax():
    c = _jax_eq4_cohort(3, n_train=60)
    vol, treat, lengths, statics = c['train']
    arms = treat[:, :-1].long()
    eff_len = torch.clamp(lengths - 1, min=2)
    cfg = JaxSINDyConfig()
    grid = np.repeat(np.asarray(cfg.wsindy_threshold_grid), 3) * 0.1
    alphas = np.tile(np.asarray(cfg.wsindy_alpha_grid), 5)
    jlib = JaxLibrary(n_inputs=3)
    jvol, jstat, jlen = (jnp.asarray(x.numpy()) for x in (vol, statics,
                                                           eff_len))
    jd = jax_eq4_design(jvol, jstat, jnp.asarray(arms.numpy()), jlen,
                        1 / 6, library=jlib, joint=False, smooth=True,
                        fd_order=4)
    for a in range(2):
        w = (jd[2] & (jd[3] == a)).astype(jnp.float64)
        ref = jax_wsindy.weak_sindy_fit_select(
            jvol, jstat, jlen, jlib, 1 / 6, jnp.asarray(grid), jd[0], jd[1],
            w,
            alphas=jnp.asarray(alphas),
            trajectory_mask=jnp.asarray(arms[:, 0].numpy() == a))
        got = wsindy.weak_sindy_fit_select(
            vol, statics, eff_len, PolynomialLibrary(n_inputs=3), 1 / 6,
            grid, t64(jd[0]), t64(jd[1]), t64(w), alphas=alphas,
            trajectory_mask=(arms[:, 0] == a))
        assert np.count_nonzero(got) > 0
        np.testing.assert_array_equal(got != 0, np.asarray(ref) != 0)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-8,
                                   atol=1e-12)


def test_per_row_finetune_equals_one_finetune_per_seed():
    """Three seeds' rows in one fine-tune over the union of their supports
    (seed 2's empty: every coefficient at or below 1e-3) against each seed
    fine-tuned alone over its own support (seed 2's fine-tune of an empty
    support)."""
    rng = np.random.RandomState(0)
    lib = PolynomialLibrary(n_inputs=3)
    models = np.zeros((3, 2, 7))
    models[0, 0, 4], models[0, 1, 1], models[0, 1, 5] = -1.05, -0.14, -1.02
    models[1, 0, 4], models[1, 1, 5] = -1.0, -1.1
    models[1, 1, 2] = 5e-4                       # retained, below 1e-3
    models[2, 0, 4], models[2, 1, 5] = 8e-4, -6e-4
    n, Tr = 6, 15
    y0 = rng.rand(3 * n) * 30 + 5
    statics = 0.5 + 0.05 * rng.randn(3 * n, 2)
    arms = np.repeat(rng.randint(0, 2, (3 * n, 1)), Tr, axis=1)
    truth = np.where(arms[:, :1] == 0, -0.55, -0.7)
    prev = y0[:, None] * np.exp(truth * np.arange(Tr) / 6) + \
        0.05 * rng.randn(3 * n, Tr)
    lengths = rng.randint(2, Tr + 1, 3 * n)
    lengths[0], lengths[n] = 3, 2                # rows that skip (<= ph)
    lengths[n + 1] = Tr
    args = [t64(x) for x in (prev, statics)] + \
        [t64(arms, torch.int32), t64(lengths, torch.int64)]
    rows = t64(np.repeat(models, n, axis=0))
    union = support(models)
    preds, coefs = insite_gn_finetune_predict(
        lib, rows, *args, 1 / 6, lam=10.0, projection_horizon=3,
        active_idx=union)
    for s in range(3):
        take = slice(s * n, (s + 1) * n)
        g = t64(models[s])
        part = [x[take] for x in args]
        ref_p, ref_c = insite_gn_finetune_predict(
            lib, g, *part, 1 / 6, lam=10.0, projection_horizon=3,
            active_idx=support(models[s]))
        np.testing.assert_allclose(preds[take], ref_p, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(coefs[take], ref_c, rtol=1e-10,
                                   atol=1e-12)
    # skip rows keep their full global model, retained entries included
    np.testing.assert_array_equal(coefs[0], rows[0])
    assert float(coefs[n, 1, 2]) == 5e-4
    assert float(coefs[n + 1, 1, 2]) == 0.0      # masked out elsewhere
    assert (coefs[2 * n:][lengths[2 * n:] > 3] == 0).all()


def _jax_column(method, seeds=(0, 1), dedup=False, equation_str='EQ_4_D'):
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    return jax.device_get(jax_vec._sweep_jit(
        keys, equation_str, N_TRAIN, N_TEST, T, 2.0, 0.1, 0.5, 10.0,
        method == 'insite', 12, PH, wsindy=(method == 'wsindy'),
        dedup_one_step=dedup))


@pytest.mark.parametrize('method, dedup', [('sindy', False),
                                           ('insite', False),
                                           ('insite', True),
                                           ('wsindy', False)])
def test_eq4_column_on_jax_cohorts_matches_one_seed(method, dedup):
    ref = _jax_column(method, dedup=dedup)
    got = vectorized.column([_jax_eq4_cohort(s) for s in (0, 1)],
                            family='eq4', method=method, threshold=0.1,
                            alpha=0.5, lam=10.0, projection_horizon=PH,
                            dedup_one_step=dedup)
    np.testing.assert_allclose(got['global_coefs'], ref[4], rtol=1e-8,
                               atol=1e-12)
    names = ['encoder_test_rmse_orig', 'encoder_test_rmse_all',
             'encoder_test_rmse_last']
    worst = 0.0
    for i, name in enumerate(names):
        np.testing.assert_allclose(got[name], ref[i], rtol=1e-6)
        worst = max(worst, float(np.max(np.abs(got[name] / ref[i] - 1))))
    for k in range(PH):
        v = got[f'decoder_test_rmse_{k + 2}-step']
        np.testing.assert_allclose(v, ref[3][:, k], rtol=1e-6)
        worst = max(worst, float(np.max(np.abs(v / ref[3][:, k] - 1))))
    print(f'{method} dedup={dedup}: largest relative RMSE deviation '
          f'{worst:.3e}')


def test_vectorized_eq4_cohort_is_the_collections():
    c = vectorized.eq4_cohort(4, 'EQ_4_D', 12, 3, T, 2.0, PH, **F64)
    coll = PkpdDatasetCollection(2.0, {'train': 12, 'val': 2, 'test': 3},
                                 'EQ_4_D', seed=4, max_seq_length=T,
                                 projection_horizon=PH, **F64)
    vol, treat, lengths, statics = c['train']
    d = coll.train_f.data
    np.testing.assert_array_equal(vol.numpy(), d['cancer_volume'])
    np.testing.assert_array_equal(treat.numpy(), d['treatment_application'])
    np.testing.assert_array_equal(lengths.numpy(), d['sequence_lengths'])
    np.testing.assert_array_equal(statics[:, 1].numpy(),
                                  d['observed_static_c_1'])
    for subset, ds in (('one_step', coll.test_cf_one_step),
                       ('n_step', coll.test_cf_treatment_seq)):
        rows, arms, lengths, statics, _ = c[subset]
        d = ds.data
        np.testing.assert_array_equal(rows.numpy(), d['cancer_volume'])
        np.testing.assert_array_equal(
            arms.numpy(), d['treatment_application'][:, :-1])
        np.testing.assert_array_equal(lengths.numpy(), d['sequence_lengths'])
        np.testing.assert_array_equal(statics[:, 0].numpy(),
                                      d['observed_static_c_0'])


SWEEP = dict(seed_runs=2, train_samples=30, val_samples=2, test_samples=2,
             debug_mode=True)


@pytest.mark.parametrize('experiment, settings, key', [
    ('MAIN_TABLE', {}, None),
    ('INSIGHT_CONFOUNDING', dict(domain_confs=(0, 4)), 'domain_conf'),
    ('INSIGHT_NOISE', dict(noise_scales=(0.0, 1.0)), 'noise_scale'),
    ('INSIGHT_LESS_SAMPLES', dict(train_sample_grid=(20, 30)),
     'train_samples')])
def test_vectorized_sweep_rows_match_jax_runner(tmp_path, experiment,
                                                settings, key):
    """Both packages' logged rows: the same keys in the same order, the
    same seeds and settings, RMSEs of the same scale (the EQ_4 cohorts
    come from different generators)."""
    logs = {tag: str(tmp_path / f'{tag}.txt') for tag in ('jax', 'port')}
    jax_vectorized_sweep(
        JaxRunConfig(methods=('sindy',), datasets=('EQ_4_D',),
                     experiment=experiment, metrics_jsonl='', **SWEEP,
                     **settings),
        log=create_logger_in_process(logs['jax'], f'jax-{experiment}'))
    rows, tables = runner.vectorized_sweep(
        RunConfig(methods=('sindy',), datasets=('EQ_4_D',),
                  experiment=experiment, **SWEEP, **settings),
        log=create_logger_in_process(logs['port'], f'port-{experiment}'),
        device='cpu', dtype=torch.float64)
    ref = df_from_log(logs['jax']).to_dict('records')
    assert rows == rows_from_log(logs['port'])
    assert len(rows) == len(ref) == (4 if key else 2)
    for ours, theirs in zip(rows, ref):
        assert list(ours) == list(theirs)
        assert ours['vectorized'] is True and ours['errored'] is False
        for k in ('seed', 'dataset_name', 'method_name', 'domain_conf') + (
                (key,) if key else ()):
            assert ours[k] == theirs[k]
        assert 0.2 < ours['encoder_test_rmse_orig'] / \
            theirs['encoder_test_rmse_orig'] < 5
    assert 'encoder_test_rmse_orig' in tables


def test_skipped_and_unported_columns(caplog):
    cfg = RunConfig(methods=('wsindy', 'ct'),
                    datasets=('cancer_sim', 'EQ_9_X'), seed_runs=1, epochs=1,
                    train_samples=20, val_samples=2, test_samples=2,
                    debug_mode=False)
    rows, _ = runner.vectorized_sweep(cfg, device='cpu')
    # wsindy outside the EQ_4 family is skipped (no row); ct on cancer_sim
    # gives its row; a column that fails (an unknown dataset) is an errored
    # row
    assert [(r['dataset_name'], r['method_name'], r['errored'])
            for r in rows] == [('cancer_sim', 'ct', False),
                               ('EQ_9_X', 'ct', True)]
    assert rows[0]['vectorized'] is True
    assert np.isfinite(rows[0]['decoder_test_rmse_6-step'])
    assert rows[1] == {'errored': True, 'dataset_name': 'EQ_9_X',
                       'method_name': 'ct', 'seed': -1, 'domain_conf': 2.0}
    assert 'unknown dataset EQ_9_X' in caplog.text
    assert 'wsindy runs on the EQ_4 family only' in caplog.text
    cfg.debug_mode = True
    cfg.methods, cfg.datasets = ('ct',), ('EQ_9_X',)
    with pytest.raises(ValueError, match='unknown dataset EQ_9_X'):
        runner.vectorized_sweep(cfg, device='cpu')
    # isolated, the column fails in its child, and the parent raises
    cfg.isolate_runs = True
    with pytest.raises(RuntimeError,
                       match=r'isolated column \(EQ_9_X, ct\) failed'):
        runner.vectorized_sweep(cfg, device='cpu')


def test_cli_vectorized_on_cpu(tmp_path):
    log_path = run.main(['--vectorized', '--device', 'cpu', '--methods',
                         'sindy', 'insite', '--datasets', 'EQ_4_A',
                         '--seeds', '2', '--train-samples', '30',
                         '--val-samples', '2', '--test-samples', '2',
                         '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    assert rows == df_from_log(log_path).to_dict('records')
    assert [(r['method_name'], r['seed']) for r in rows] == [
        ('sindy', 0), ('sindy', 1), ('insite', 0), ('insite', 1)]
    assert all(r['vectorized'] is True for r in rows)
    assert rows[0]['seconds_taken'] == rows[1]['seconds_taken']
    text = open(log_path).read()
    assert '[Sweep config]' in text and 'Latex Table::' in text


@pytest.mark.parametrize('method', ['sindy', 'insite'])
def test_sweep_sharded_over_mesh_matches_single_device(method):
    """The seeds split into one block a device: each block's cohorts,
    discovery and fine-tune (over the whole column's union of supports)
    on its device give the unsharded column's per-seed results (f64, rtol
    1e-10)."""
    from insite_tpu_torch.parallel import batch_mesh
    kw = dict(n_seeds=8, n_train=30, n_test=3, seq_length=20, method=method,
              dtype=torch.float64)
    ref = vectorized.vectorized_eq4_sweep('EQ_4_D', device='cpu', **kw)
    for k in (2, 8):
        got = vectorized.vectorized_eq4_sweep(
            'EQ_4_D', mesh=batch_mesh([torch.device('cpu')] * k), **kw)
        assert list(got) == list(ref)
        worst = max(float(np.max(np.abs(np.asarray(got[key]) -
                                        np.asarray(ref[key]))))
                    for key in ref)
        print(f'{method} k={k}: largest absolute deviation {worst:.3e}')
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-10,
                                       err_msg=key)
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        vectorized.vectorized_eq4_sweep(
            'EQ_4_D', mesh=batch_mesh([torch.device('cpu')] * 3), **kw)
