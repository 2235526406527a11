"""The weak fit at one threshold: the port's `sr3_l1` and
`weak_sindy_fit` (both solvers) against the JAX package's, in float64 on
the CPU, on systems made from a numpy seed. Tolerance rtol 1e-8 for both
(measured: sr3_l1 5.6e-16, weak_sindy_fit 1.3e-15 with SR3 and 4.9e-12
with STLSQ relative at most); the supports are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery import wsindy as jax_wsindy
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu_torch.discovery import wsindy
from insite_tpu_torch.discovery.library import PolynomialLibrary

torch.set_num_threads(1)


def _close(got, want, what, rtol=1e-8, atol=1e-14):
    """Equal supports and assert_allclose, printing the largest relative
    deviation."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got != 0, want != 0, err_msg=what)
    dev = np.abs(got - want) / np.maximum(np.abs(want), atol / rtol)
    print(f'{what}: largest relative deviation {dev.max():.3e}')
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _noisy_system(seed, N=300, F=7):
    rs = np.random.RandomState(seed)
    A = rs.randn(N, F) * np.array([1, 5, 0.5, 0.5, 3, 3, 0.2])
    A[:, 2] = A[:, 0] * 0.5 + 1e-3 * rs.randn(N)      # near-parallel columns
    c = np.array([0, -0.3, 0, 0, -1.0, 0, 0.02])
    b = A @ c + 0.01 * rs.randn(N)
    w = (rs.rand(N) > 0.2).astype(float)
    return A, b, w


@pytest.mark.parametrize('seed, threshold', [(0, 0.05), (1, 0.2)])
def test_sr3_l1_matches_jax(seed, threshold):
    """1,000 relax-and-split steps from one Cholesky factor, the refit on
    the support: the JAX package's coefficients; a float32 system is
    solved in float64, giving the float64 system's answer to its
    rounding."""
    A, b, w = _noisy_system(seed)
    got = wsindy.sr3_l1(*(torch.from_numpy(x) for x in (A, b, w)),
                        threshold)
    want = jax_wsindy.sr3_l1(jnp.asarray(A), jnp.asarray(b), jnp.asarray(w),
                             threshold)
    assert got.dtype == torch.float64
    _close(got.numpy(), np.asarray(want), f'sr3_l1 seed {seed}')
    assert 0 < (got != 0).sum() < A.shape[1]
    got32 = wsindy.sr3_l1(*(torch.from_numpy(x).float() for x in (A, b, w)),
                          threshold)
    assert got32.dtype == torch.float64
    np.testing.assert_array_equal(got32.numpy() != 0, got.numpy() != 0)
    np.testing.assert_allclose(got32.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-6)


def _decay_cohort(seed=0, B=12, T=40):
    """Trajectories of y' = -(k0 + k1 c0) y with observation noise, and a
    trajectory mask: the rows of one arm."""
    rs = np.random.RandomState(seed)
    statics = rs.rand(B, 2)
    k = 0.5 + statics[:, 0] * 0.8
    y = 5 + rs.rand(B)
    out = [y]
    for _ in range(T - 1):
        y = y - (1 / 6) * k * y
        out.append(y)
    volumes = np.stack(out, 1) + 1e-3 * rs.randn(B, T)
    lengths = np.full(B, T)
    lengths[::4] = T - 7
    mask = rs.rand(B) > 0.3
    return volumes, statics, lengths, mask


@pytest.mark.parametrize('solver, threshold', [('stlsq', 0.1),
                                               ('sr3', 0.05)])
def test_weak_sindy_fit_matches_jax(solver, threshold):
    """The weak system of the masked trajectories solved at one
    threshold: the JAX package's coefficients, float32 inputs included
    (the system is built in float64 either way)."""
    volumes, statics, lengths, mask = _decay_cohort()
    kw = dict(n_windows=20, window_len=12, seed=3, solver=solver)
    want = np.asarray(jax_wsindy.weak_sindy_fit(
        jnp.asarray(volumes), jnp.asarray(statics), jnp.asarray(lengths),
        JaxLibrary(3), 1 / 6, threshold,
        trajectory_mask=jnp.asarray(mask), **kw))
    for dtype in (torch.float64, torch.float32):
        got = wsindy.weak_sindy_fit(
            torch.as_tensor(volumes, dtype=dtype),
            torch.as_tensor(statics, dtype=dtype),
            torch.as_tensor(lengths), PolynomialLibrary(3), 1 / 6,
            threshold, trajectory_mask=torch.as_tensor(mask), **kw)
        assert got.dtype == np.float64 and got.shape == (7,)
        if dtype == torch.float64:
            _close(got, want, f'weak_sindy_fit {solver}')
    assert 0 < (want != 0).sum() < 7


def test_weak_sindy_fit_refuses_unknown_solver():
    volumes, statics, lengths, _ = _decay_cohort()
    with pytest.raises(ValueError, match='solver'):
        wsindy.weak_sindy_fit(torch.as_tensor(volumes),
                              torch.as_tensor(statics),
                              torch.as_tensor(lengths), PolynomialLibrary(3),
                              1 / 6, 0.1, solver='lasso')
