"""PolynomialLibrary: the port against the JAX package on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu_torch.discovery.library import PolynomialLibrary

LIBRARIES = [dict(n_inputs=3, degree=2, interaction_only=True),
             dict(n_inputs=2),
             dict(n_inputs=3, degree=4, interaction_only=False)]


@pytest.mark.parametrize('kw', LIBRARIES)
def test_tables_names_and_equations_identical(kw):
    ref, lib = JaxLibrary(**kw), PolynomialLibrary(**kw)
    np.testing.assert_array_equal(lib.exponents(), ref.exponents())
    assert lib.exponents().dtype == ref.exponents().dtype
    assert lib.n_features == ref.n_features
    assert lib.feature_names() == ref.feature_names()
    names = [f'v{i}' for i in range(kw['n_inputs'])]
    assert lib.feature_names(names) == ref.feature_names(names)
    rng = np.random.RandomState(0)
    coefs = rng.randn(ref.n_features) * (rng.rand(ref.n_features) > 0.5)
    coefs[0] = 5e-4                                 # below min_coef
    assert lib.pretty_equation(coefs, names) == \
        ref.pretty_equation(coefs, names)
    assert lib.pretty_equation(coefs, quantize_round_to=2) == \
        ref.pretty_equation(coefs, quantize_round_to=2)
    assert lib.pretty_equation(np.zeros(ref.n_features)) == \
        ref.pretty_equation(np.zeros(ref.n_features))


@pytest.mark.parametrize('kw', LIBRARIES)
def test_feature_matrix_matches_jax_f64(kw):
    rng = np.random.RandomState(1)
    X = rng.randn(5, 7, kw['n_inputs']) * 3
    ref = np.asarray(JaxLibrary(**kw)(jnp.asarray(X)))
    out = PolynomialLibrary(**kw)(torch.from_numpy(X)).numpy()
    assert out.shape == ref.shape
    # f64; the same chains of multiplications, grouped differently across
    # inputs for mixed monomials (a last-ulp difference at most)
    np.testing.assert_allclose(out, ref, rtol=1e-12)
