"""Derivative estimates: the port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery import differentiate as jd
from insite_tpu_torch.discovery import differentiate as td


@pytest.mark.parametrize('fn,args', [('savgol_coeffs_matrix', (5, 3)),
                                     ('fornberg_matrix', (5, 1)),
                                     ('fornberg_matrix', (3, 1)),
                                     ('fornberg_matrix', (5, 2))])
def test_filter_matrices_identical(fn, args):
    np.testing.assert_array_equal(getattr(td, fn)(*args),
                                  getattr(jd, fn)(*args))


@pytest.mark.parametrize('order', [2, 4])
def test_smoothed_finite_difference_ragged_matches_jax(order):
    rng = np.random.RandomState(0)
    B, T, dt = 7, 20, 1 / 6
    x = 20 + rng.randn(B, T).cumsum(1)
    # ragged, including rows shorter than the 5-point window
    lengths = np.array([20, 12, 5, 3, 7, 19, 4], np.int64)
    ref = np.asarray(jd.smoothed_finite_difference(
        jnp.asarray(x), jnp.asarray(lengths), dt, order=order))
    out = td.smoothed_finite_difference(
        torch.from_numpy(x), torch.from_numpy(lengths), dt,
        order=order).numpy()
    valid = np.arange(T)[None, :] < lengths[:, None]
    # f64; the two 5-term window sums may be taken in another order
    np.testing.assert_allclose(out[valid], ref[valid], rtol=1e-10,
                               atol=1e-10 * np.abs(ref[valid]).max())
