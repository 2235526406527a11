"""Weak-form SINDy: the port's `discovery/wsindy.py` and the A-WSINDy
estimator against the JAX package, in float64 on the CPU, on inputs made
from a numpy seed or on a cohort carried over with
`convert.collection_from_numpy`.

Tolerances: the quadrature weights and window starts are numpy in both
packages and equal (the hand-written trapezoid sum to rtol 1e-15 of
`np.trapezoid`); the weak systems are the same contractions in another
summation order, rtol 1e-12; the host solves are the same numpy code on
those systems, so candidates agree to rtol 1e-9 and the selected index is
equal; the estimator's coefficients and RMSEs agree to rtol 1e-8 with equal
supports, and the equation strings are equal once their coefficients are
rounded to 8 significant digits (measured: the last 3 of 16 digits
differ)."""

import copy
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.discovery import wsindy as jax_wsindy
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.discovery import wsindy
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.harness.config import (model_dataset_name,
                                             sindy_params_for)
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor

F64 = dict(device='cpu', dtype=torch.float64)
torch.set_num_threads(1)


def t64(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize('window_len, p', [(30, 2), (8, 2), (5, 2), (3, 1),
                                           (4, 1)])
def test_hat_weights_equal_jax(window_len, p):
    W, Wd = wsindy._hat_weights(window_len, p)
    W_r, Wd_r = jax_wsindy._hat_weights(window_len, p)
    np.testing.assert_allclose(W, W_r, rtol=1e-15, atol=0)
    np.testing.assert_allclose(Wd, Wd_r, rtol=1e-15, atol=1e-18)
    # the weights integrate phi itself: sum_i 1 * W[i] = integral(phi)
    want = {1: 4 / 3, 2: 16 / 15}[p]
    assert abs(W.sum() - want) < 1e-6


def test_trapezoid_is_numpys():
    rs = np.random.RandomState(0)
    x = np.sort(rs.rand(4001)) * 2 - 1
    y = rs.randn(4001)
    np.testing.assert_allclose(wsindy._trapezoid(y, x), np.trapezoid(y, x),
                               rtol=1e-15)


@pytest.mark.parametrize('kw', [
    dict(n_windows=100, window_len=30, t_len=59, seed=0),
    dict(n_windows=7, window_len=12, t_len=20, seed=3, p=1),
    dict(n_windows=5, window_len=8, t_len=60, all_starts=True),
    dict(n_windows=5, window_len=3, t_len=3, all_starts=True, p=1)])
def test_test_functions_equal_jax(kw):
    for got, want in zip(wsindy._test_functions(**kw),
                         jax_wsindy._test_functions(**kw)):
        np.testing.assert_array_equal(got, want)


def _cohort(seed, B=9, T=40, S=2, A=2):
    rs = np.random.RandomState(seed)
    volumes = np.abs(rs.randn(B, T)).cumsum(1) + 1.0
    statics = rs.rand(B, S)
    lengths = rs.randint(5, T + 1, B)
    lengths[0] = T
    step_arms = np.repeat(rs.randint(0, A, (B, (T - 1) // 3 + 1)), 3,
                          axis=1)[:, :T - 1]
    return volumes, statics, lengths, step_arms


def _assert_systems_close(got, want):
    for g, w, name in zip(got, want, ('A', 'b', 'w')):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13, err_msg=name)


def test_weak_system_trajectory_mask_matches_jax():
    volumes, statics, lengths, step_arms = _cohort(0)
    mask = step_arms[:, 0] == 1
    kw = dict(n_windows=11, window_len=10, seed=4)
    got = wsindy.weak_system(t64(volumes), t64(statics),
                             t64(lengths, torch.int64),
                             PolynomialLibrary(3), 1 / 6,
                             trajectory_mask=t64(mask, torch.bool), **kw)
    want = jax_wsindy.weak_system(jnp.asarray(volumes), jnp.asarray(statics),
                                  jnp.asarray(lengths), JaxLibrary(3), 1 / 6,
                                  trajectory_mask=jnp.asarray(mask), **kw)
    _assert_systems_close(got, want)
    assert got[0].shape == (9 * 11, 7) and 0 < float(got[2].sum()) < 99


@pytest.mark.parametrize('arm', [0, 1])
def test_weak_system_step_arms_matches_jax(arm):
    volumes, statics, lengths, step_arms = _cohort(1)
    kw = dict(window_len=4, all_starts=True, p=1, arm=arm)
    got = wsindy.weak_system(t64(volumes), t64(statics),
                             t64(lengths, torch.int64),
                             PolynomialLibrary(3), 1 / 6,
                             step_arms=t64(step_arms, torch.int64), **kw)
    want = jax_wsindy.weak_system(jnp.asarray(volumes), jnp.asarray(statics),
                                  jnp.asarray(lengths), JaxLibrary(3), 1 / 6,
                                  step_arms=jnp.asarray(step_arms), **kw)
    _assert_systems_close(got, want)
    assert float(got[2].sum()) > 0


def test_weak_system_segments_matches_jax():
    volumes, statics, lengths, step_arms = _cohort(2, S=1, A=4)
    got = wsindy.weak_system_segments(
        t64(volumes), t64(statics), t64(lengths, torch.int64),
        PolynomialLibrary(2), 1 / 6, t64(step_arms, torch.int64), 2,
        window_lens=(8, 5, 3))
    want = jax_wsindy.weak_system_segments(
        jnp.asarray(volumes), jnp.asarray(statics), jnp.asarray(lengths),
        JaxLibrary(2), 1 / 6, jnp.asarray(step_arms), 2,
        window_lens=(8, 5, 3))
    _assert_systems_close(got, want)
    assert got[0].shape == (9 * (33 + 36 + 38), 4)


def test_weak_system_refuses_multilabel_step_arms():
    volumes, statics, lengths, step_arms = _cohort(3)
    labels = np.stack([step_arms, 1 - step_arms], axis=-1)
    with pytest.raises(ValueError, match='arm per transition'):
        wsindy.weak_system(t64(volumes), t64(statics),
                           t64(lengths, torch.int64), PolynomialLibrary(3),
                           1 / 6, step_arms=t64(labels, torch.int64), arm=0)


def _noisy_system(seed, N=400, F=7):
    rs = np.random.RandomState(seed)
    A = rs.randn(N, F) * np.array([1, 5, 0.5, 0.5, 3, 3, 0.2])
    A[:, 2] = A[:, 0] * 0.5 + 1e-3 * rs.randn(N)      # near-parallel columns
    c = np.array([0, -0.3, 0, 0, -1.0, 0, 0.02])
    b = A @ c + 0.01 * rs.randn(N)
    w = (rs.rand(N) > 0.2).astype(float)
    return A, b, w


@pytest.mark.parametrize('seed', [0, 1])
def test_host_solves_match_jax(seed):
    A, b, w = _noisy_system(seed)
    grid = np.repeat([0.025, 0.05, 0.1, 0.2, 0.4], 3)
    alphas = np.tile([0.5, 0.05, 0.005], 5)
    cands = np.stack([wsindy.weak_stlsq_host(A, b, w, t, alpha=al)
                      for t, al in zip(grid, alphas)])
    cands_r = np.stack([jax_wsindy.weak_stlsq_host(A, b, w, t, alpha=al)
                        for t, al in zip(grid, alphas)])
    np.testing.assert_array_equal(cands != 0, cands_r != 0)
    np.testing.assert_allclose(cands, cands_r, rtol=1e-9, atol=1e-14)
    # the grid solve shares one set of normal equations: the same numbers
    np.testing.assert_array_equal(
        wsindy.weak_candidates_host(A, b, w, grid, alphas), cands)
    assert len({tuple(c != 0) for c in cands}) > 1     # the grid matters
    c, g = wsindy.weak_select_host(cands, A, b, w, select_tol=0.05)
    c_r, g_r = jax_wsindy.weak_select_host(cands_r, grid, A, b, w,
                                           select_tol=0.05)
    assert g == g_r
    np.testing.assert_allclose(c, c_r, rtol=1e-9, atol=1e-14)


def test_select_prefers_sparsest_admissible_then_later_index():
    theta = np.eye(3)
    y = np.array([1.0, 1.0, 0.0])
    w = np.ones(3)
    cands = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1e-3], [0.0, 0.0, 0.0],
                      [1.0, 1.0, 0.0]])
    # 0 and 3 fit exactly with 2 terms (the later wins), 1 needs 3, the
    # all-zero model is not admissible
    assert wsindy.weak_select_host(cands, theta, y, w)[1] == 3
    zeros = np.zeros((2, 3))
    assert wsindy.weak_select_host(zeros, theta, y, w)[1] == 1


SIZES = {'train': 60, 'val': 4, 'test': 2}


def rounded(equation: str) -> str:
    """The equation string with every number at 8 significant digits."""
    return re.sub(r'\d+\.\d+(e-?\d+)?',
                  lambda m: f'{float(m.group()):.8g}', equation)


@pytest.mark.parametrize('name', ['EQ_4_D', 'cancer_sim'])
def test_wsindy_regressor_matches_jax_f64(name):
    ref = jax_make_collection(name, SIZES, 0, 2.0)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=5,
        treatment_mode='multiclass')
    cfg = dict(dataset_name=model_dataset_name(name),
               sindy_threshold=sindy_params_for(name)[0], wsindy=True)
    out = []
    for model, coll in ((SINDyRegressor(SINDyConfig(**cfg), ours, **F64),
                         ours),
                        (JaxRegressor(JaxConfig(**cfg), ref), ref)):
        model.fit(coll.train_f)
        out.append((np.asarray(model.coefs), model.global_equation_string,
                    model.get_normalised_masked_rmse(
                        coll.test_cf_one_step, one_step_counterfactual=True),
                    np.asarray(model.get_normalised_n_step_rmses(
                        coll.test_cf_treatment_seq))))
    (c, eq, one, n_step), (c_r, eq_r, one_r, n_step_r) = out
    np.testing.assert_array_equal(c != 0, c_r != 0)
    np.testing.assert_allclose(c, c_r, rtol=1e-8, atol=1e-14)
    assert np.abs(c).max() > 1e-3 and rounded(eq) == rounded(eq_r)
    np.testing.assert_allclose(one, one_r, rtol=1e-8)
    np.testing.assert_allclose(n_step, n_step_r, rtol=1e-8)


def test_single_candidate_without_selection():
    """``wsindy_select`` off: one weak solve at (sindy_threshold, 0.5)."""
    ref = jax_make_collection('EQ_4_B', SIZES, 1, 2.0)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_B', projection_horizon=5,
        treatment_mode='multiclass')
    cfg = dict(dataset_name='EQ_4_B', wsindy=True, wsindy_select=False)
    m = SINDyRegressor(SINDyConfig(**cfg), ours, **F64).fit(ours.train_f)
    m_r = JaxRegressor(JaxConfig(**cfg), ref).fit(ref.train_f)
    np.testing.assert_allclose(m.coefs, np.asarray(m_r.coefs), rtol=1e-8,
                               atol=1e-14)
    assert rounded(m.global_equation_string) == \
        rounded(m_r.global_equation_string)
