"""The tumor-family vectorized seed columns (`harness/vectorized.py`:
`tumor_cohort` and `column` with family 'tumor') fed the JAX package's
parameters and draws, rebuilt with `_tumor_one_seed`'s key discipline,
against its `_tumor_one_seed`, in float64 on the CPU: RMSEs rtol 1e-6,
coefficients rtol 1e-8 (on EQ_5_A, whose single patient type duplicates
two pairs of library columns, the sum of each pair), and on EQ_5 every
coefficient of the chemo-dosage input exactly 0. The port's own parameter
draws (`_tumor_params`) against the JAX package's distributions, and a
whole `vectorized_tumor_sweep`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.harness import vectorized as jax_vec
from insite_tpu_torch.harness import vectorized

N_TRAIN, N_TEST, T, PH = 30, 2, 20, 5
torch.set_num_threads(1)


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _jax_draws(seed, dataset_name):
    """`tumor_draws`' dict from the JAX package's keys, in the roles and
    key splits of `_tumor_one_seed` (vectorized.py:431-483, 541-543)."""
    ptc, bcn, extra = jax_vec.TUMOR_VARIANTS[dataset_name]
    f64 = jnp.float64

    def params(k, n):
        p, ptypes = jax_vec._tumor_params_jax(k, n, 2.0, 2.0, ptc, bcn, f64)
        return {k: t64(v) for k, v in p.items()}, t64(ptypes)

    def factual_rvs(k, n):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return {'noise': 0.01 * jax.random.normal(k1, (n, T), f64),
                'recovery': jax.random.uniform(k2, (n, T), f64),
                'chemo_rv': jax.random.uniform(k3, (n, T), f64),
                'radio_rv': jax.random.uniform(k4, (n, T), f64)}

    k_tr, k_te = jax.random.split(jax.random.PRNGKey(seed))
    kp, kr, kn = jax.random.split(k_tr, 3)
    kp2, kr2, kn2, kn3 = jax.random.split(k_te, 4)
    out = {}
    out['train_params'], out['train_ptypes'] = params(kp, N_TRAIN)
    out['train_rvs'] = {k: t64(v) for k, v in
                        factual_rvs(kr, N_TRAIN).items()}
    out['test_params'], out['test_ptypes'] = params(kp2, N_TEST)
    rvs_t = factual_rvs(kr2, N_TEST)
    rvs_t['noise'] = 0.01 * jax.random.normal(kn3, (N_TEST, T + PH), f64)
    out['test_rvs'] = {k: t64(v) for k, v in rvs_t.items()}
    out['train_noise'] = out['one_step_noise'] = out['n_step_noise'] = None
    if extra:
        out['train_noise'] = t64(0.01 * jax.random.normal(kn, (N_TRAIN, T),
                                                           f64))
        out['one_step_noise'] = t64(0.01 * jax.random.normal(
            kn2, (N_TEST * (T - 1) * 4, T), f64))
        out['n_step_noise'] = t64(0.01 * jax.random.normal(
            jax.random.fold_in(kn2, 1), (N_TEST * (T - 1) * 2 * PH, T + PH),
            f64))
    return out


@pytest.mark.parametrize('dataset_name, method', [
    ('cancer_sim', 'sindy'), ('cancer_sim', 'insite'), ('EQ_5_A', 'sindy'),
    ('EQ_5_D', 'insite')])
def test_tumor_column_on_jax_draws_matches_one_seed(dataset_name, method):
    ptc, bcn, extra = jax_vec.TUMOR_VARIANTS[dataset_name]
    dosage = 'EQ_5' in dataset_name
    seeds = (0, 1)
    ref = jax.device_get(jax_vec._tumor_sweep_jit(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds]), N_TRAIN, N_TEST,
        T, 2.0, 0.001, 0.5, 10.0, method == 'insite', 12, PH, ptc, bcn,
        extra, include_dosage=dosage))
    cohorts = [vectorized.tumor_cohort(_jax_draws(s, dataset_name), T, PH,
                                       include_dosage=dosage)
               for s in seeds]
    got = vectorized.column(cohorts, family='tumor', method=method,
                            threshold=0.001, alpha=0.5, lam=10.0,
                            projection_horizon=PH)
    assert got['global_coefs'].shape == (2, 4, 7 if dosage else 4)
    if ptc == (1,):
        # one patient type: 'u0' is a copy of '1' and 'x0 u0' of 'x0', so
        # the ridge floor alone splits each pair and only the pair's sum
        # is determined (measured: the split differs at 1e-3 relative)
        def identified(c):
            c = np.asarray(c)
            return np.concatenate([c[..., :1] + c[..., 2:3],
                                   c[..., 1:2] + c[..., 4:5],
                                   c[..., [3, 5, 6]]], axis=-1)
        np.testing.assert_allclose(identified(got['global_coefs']),
                                   identified(ref[4]), rtol=1e-8,
                                   atol=1e-10)
    else:
        np.testing.assert_allclose(got['global_coefs'], ref[4], rtol=1e-8,
                                   atol=1e-10)
    if dosage:
        # features 3, 5, 6 of [1, x0, u0, u1, x0 u0, x0 u1, u0 u1] read
        # the dosage, identically 0
        assert (got['global_coefs'][..., [3, 5, 6]] == 0.0).all()
    names = ('encoder_test_rmse_orig', 'encoder_test_rmse_all',
             'encoder_test_rmse_last')
    worst = 0.0
    for i, name in enumerate(names):
        np.testing.assert_allclose(got[name], ref[i], rtol=1e-6)
        worst = max(worst, float(np.max(np.abs(got[name] / ref[i] - 1))))
    for k in range(PH):
        v = got[f'decoder_test_rmse_{k + 2}-step']
        np.testing.assert_allclose(v, ref[3][:, k], rtol=1e-6)
        worst = max(worst, float(np.max(np.abs(v / ref[3][:, k] - 1))))
    print(f'{dataset_name} {method}: largest relative RMSE deviation '
          f'{worst:.3e}')


def test_tumor_params_follow_the_jax_distributions():
    """Means and spreads of the port's draws within sampling error of the
    JAX package's (20,000 patients each)."""
    n = 20_000
    ours, ptypes = vectorized._tumor_params(
        torch.Generator().manual_seed(0), n, 2.0, 2.0, device='cpu',
        dtype=torch.float64)
    ref, ref_types = jax_vec._tumor_params_jax(jax.random.PRNGKey(0), n,
                                               2.0, 2.0, dtype=jnp.float64)
    for k in ('initial_volumes', 'alpha', 'rho', 'beta', 'beta_c'):
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert (a > 0).all(), k
        se = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) < 5 * se, k
        assert abs(a.std() / b.std() - 1) < 0.05, k
    for k in ('K', 'chemo_sigmoid_betas', 'radio_sigmoid_intercepts'):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-12)
    for t in (1, 2, 3):
        share = float((ptypes == t).double().mean())
        assert abs(share - float(np.mean(np.asarray(ref_types) == t))) < 0.02


def test_vectorized_tumor_sweep_runs_a_column():
    r = vectorized.vectorized_tumor_sweep(
        'EQ_5_B', n_seeds=2, n_train=N_TRAIN, n_test=N_TEST, seq_length=T,
        method='insite', device='cpu', dtype=torch.float64)
    assert r['global_coefs'].shape == (2, 4, 7)
    v = r['encoder_test_rmse_orig']
    assert v.shape == (2,) and np.isfinite(v).all() and v[0] != v[1]
    assert r['mean'] == pytest.approx(float(v.mean()))
    for k in range(2, 7):
        assert np.isfinite(r[f'decoder_test_rmse_{k}-step']).all()
