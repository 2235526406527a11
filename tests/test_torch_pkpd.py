"""PKPD factual simulator: the port's core against the JAX core on the same
parameters and draws (exact up to f64 rounding), and its own generator
against the JAX package's in distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from insite_tpu.sim import pkpd as jp
from insite_tpu_torch import convert
from insite_tpu_torch.sim import pkpd as tp

N_DIST = 20_000


def _jax_params(n, seed):
    p = jp.generate_params(n, conf_coeff=2.0, window_size=15, lag=0,
                           key=jax.random.PRNGKey(seed),
                           equation=jp.Equation.EQ_4_D, dtype=jnp.float64)
    return {k: np.array(v) for k, v in p.items()}


def test_factual_core_matches_jax_f64():
    n, seq_length = 64, 60
    params = _jax_params(n, 0)
    # rows 0-3 decay to ~1e-14 within two intervals: the recovery draw fires
    params['hidden_C_0'][:4] = params['hidden_C_1'][:4] = 29.0
    # rows 4-7 grow past MAX_VALUE: death truncation
    params['hidden_C_0'][4:8] = params['hidden_C_1'][4:8] = -1.0
    params['initial_volumes'][4:8] = 40.0
    rng = np.random.RandomState(0)
    treatment_rvs = rng.rand(n)
    recovery_rvs = rng.rand(n, seq_length) * 0.5

    ref = jp._simulate_factual_core(
        {k: (jnp.asarray(v) if np.ndim(v) else v) for k, v in params.items()},
        jnp.asarray(treatment_rvs), jnp.asarray(recovery_rvs), seq_length,
        dtype=jnp.float64)
    vol_r, treat_r, len_r = (np.asarray(a) for a in ref)
    out = tp._simulate_factual_core(
        convert.params_from_numpy(params, 'cpu', torch.float64),
        torch.from_numpy(treatment_rvs), torch.from_numpy(recovery_rvs),
        seq_length, dtype=torch.float64)
    vol, treat, lengths = (a.numpy() for a in out)

    assert (len_r[:4] == 3).all() and (vol_r[:4, 2:] == 0).all()
    assert (len_r[4:8] < seq_length - 1).all()
    assert (vol_r[4:8, -1] == 50.0).all()
    assert 0 < treat_r[:, 0].mean() < 1
    np.testing.assert_array_equal(lengths, len_r)
    np.testing.assert_array_equal(treat, treat_r)
    # f64, same operation order; cumprod may associate differently
    np.testing.assert_allclose(vol, vol_r, rtol=1e-12, atol=0)


def _close_in_3_se(a, b, se):
    assert abs(a - b) < 3 * se, (a, b, se)


def test_standard_params_distribution_matches_jax():
    ref = jp.get_standard_params(N_DIST, jp.Equation.EQ_4_D,
                                 jax.random.PRNGKey(3), dtype=jnp.float64)
    out = tp.get_standard_params(N_DIST, tp.Equation.EQ_4_D,
                                 torch.Generator().manual_seed(3), 'cpu',
                                 dtype=torch.float64)
    for k in ('observed_static_c_0', 'observed_static_c_1'):
        a, b = np.asarray(ref[k]), out[k].numpy()
        sa, sb = a.std(), b.std()
        _close_in_3_se(a.mean(), b.mean(), np.hypot(sa, sb) / np.sqrt(N_DIST))
        _close_in_3_se(sa, sb, np.hypot(sa, sb) / np.sqrt(2 * N_DIST))
    for params in (ref, out):
        v0 = np.asarray(params['initial_volumes'])
        assert v0.min() >= 1.0 and v0.max() < 50.0
    # EQ_4_D: hidden constants = statics + fixed offset + one shared shift
    shift = out['hidden_C_1'] - out['observed_static_c_1']
    assert torch.allclose(shift, shift[0].expand_as(shift))


def test_factual_full_treatment_share_matches_jax():
    seq_length = 60
    params = jp.generate_params(N_DIST, 2.0, 15, 0, jax.random.PRNGKey(4),
                                jp.Equation.EQ_4_D, dtype=jnp.float64)
    vol_r, treat_r, len_r = (np.asarray(a) for a in jp._simulate_factual_full(
        params, jax.random.PRNGKey(5), seq_length, True, dtype=jnp.float64))
    gen = torch.Generator().manual_seed(4)
    tparams = tp.generate_params(N_DIST, 2.0, 15, 0, gen, tp.Equation.EQ_4_D,
                                 'cpu', dtype=torch.float64)
    vol, treat, lengths = (a.numpy() for a in tp._simulate_factual_full(
        tparams, gen, seq_length, True, dtype=torch.float64))
    assert vol.shape == vol_r.shape and treat.shape == treat_r.shape
    assert np.isfinite(vol).all()
    assert (treat[:, -1] == 0).all()
    pa, pb = treat_r[:, 0].mean(), treat[:, 0].mean()
    p = (pa + pb) / 2
    _close_in_3_se(pa, pb, np.sqrt(2 * p * (1 - p) / N_DIST))
    assert (lengths == len_r).mean() > 0.99     # truncation is rare at EQ_4
