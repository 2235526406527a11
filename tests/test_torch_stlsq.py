"""QR reduction and host STLSQ: the port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery.library import PolynomialLibrary
from insite_tpu.discovery.stlsq import _qr_reduce as jax_qr_reduce
from insite_tpu.discovery.stlsq import stlsq_from_qr as jax_stlsq_from_qr
from insite_tpu_torch.discovery import stlsq as ts


def _problem(seed, n=400):
    """An EQ_4-like regression: near-collinear statics (0.5 +- 0.05),
    x_dot = -1.05 * x0 * u0 + noise, ragged 0/1 weights."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.rand(n) * 40 + 1, 0.5 + 0.05 * rng.randn(n),
                  0.5 + 0.05 * rng.randn(n)], axis=-1)
    theta = np.array(PolynomialLibrary(n_inputs=3)(jnp.asarray(X)))
    y = -1.05 * X[:, 0] * X[:, 1] - 0.14 * X[:, 0] + 0.01 * rng.randn(n)
    w = (rng.rand(n) > 0.2).astype(np.float64)
    return theta, y, w


@pytest.mark.parametrize('weighted', [True, False])
def test_qr_reduce_same_normal_equations(weighted):
    theta, y, w = _problem(0)
    Rj, qj = (np.asarray(a) for a in jax_qr_reduce(
        jnp.asarray(theta), jnp.asarray(y),
        jnp.asarray(w) if weighted else None))
    Rt, qt = (a.numpy() for a in ts._qr_reduce(
        torch.from_numpy(theta), torch.from_numpy(y),
        torch.from_numpy(w) if weighted else None))
    # R is unique only up to the sign of each row: compare R^T R and
    # R^T Q^T y. f64 Householder QR in two libraries: error ~ eps*cond(theta)
    np.testing.assert_allclose(Rt.T @ Rt, Rj.T @ Rj, rtol=1e-9,
                               atol=1e-12 * np.abs(Rj.T @ Rj).max())
    np.testing.assert_allclose(Rt.T @ qt, Rj.T @ qj, rtol=1e-9,
                               atol=1e-12 * np.abs(Rj.T @ qj).max())


@pytest.mark.parametrize('threshold,alpha,mask,unbias', [
    (0.1, 0.5, None, True), (0.05, 0.0, None, True),
    (0.1, 0.5, [1, 1, 0, 1, 1, 1, 0], False), (100.0, 0.5, None, True)])
def test_stlsq_from_qr_identical(threshold, alpha, mask, unbias):
    theta, y, w = _problem(1)
    R, qty = (np.asarray(a) for a in jax_qr_reduce(
        jnp.asarray(theta), jnp.asarray(y), jnp.asarray(w)))
    ref_c, ref_m = jax_stlsq_from_qr(R, qty, threshold, alpha,
                                    initial_mask=mask, unbias=unbias)
    c, m = ts.stlsq_from_qr(R, qty, threshold, alpha, initial_mask=mask,
                            unbias=unbias)
    np.testing.assert_array_equal(m, ref_m)
    np.testing.assert_array_equal(c, ref_c)      # same host f64 arithmetic
