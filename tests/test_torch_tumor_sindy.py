"""The A-SINDy / INSITE estimator on the tumor family: the port's
`SINDyRegressor` on a collection carried over from the JAX package against
the JAX `SINDyRegressor` on that same cohort, in float64 on the CPU (the JAX
side takes its XLA rollout and jvp fine-tune, the port the plain versions
of its kernels), and the unbias refit on a rank-deficient support.

Tolerances: the global coefficients and equation strings are equal (the
same design, host QR and host STLSQ); A-SINDy RMSEs agree to rtol 1e-12
and INSITE RMSEs to rtol 1e-8 (the same LM sequence, with the Jacobian
from forward sensitivities here and jvp there)."""

import copy

import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.discovery.stlsq import stlsq_from_qr as jax_stlsq_from_qr
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS, make_collection
from insite_tpu_torch.discovery.stlsq import stlsq_from_qr
from insite_tpu_torch.harness.config import model_dataset_name
from insite_tpu_torch.models.sindy import (SINDyConfig, SINDyRegressor,
                                           support)

F64 = dict(device='cpu', dtype=torch.float64)
SIZES = {'train': 40, 'val': 4, 'test': 2}
# the plain rollouts are thousands of small ops: intra-op threads only add
# synchronisation, and across parallel test workers they oversubscribe the
# cores
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pristine():
    return {name: jax_make_collection(name, SIZES, 0, 2.0)
            for name in ('cancer_sim', 'EQ_5_C')}


def _evaluate(model, coll):
    model.fit(coll.train_f)
    return (model.coefs, model.global_equation_string,
            model.get_normalised_masked_rmse(coll.test_cf_one_step,
                                             one_step_counterfactual=True),
            np.asarray(model.get_normalised_n_step_rmses(
                coll.test_cf_treatment_seq)))


@pytest.mark.parametrize('insite', [False, True], ids=['sindy', 'insite'])
@pytest.mark.parametrize('name', ['cancer_sim', 'EQ_5_C'])
def test_regressor_matches_jax_f64(pristine, name, insite):
    ref = copy.deepcopy(pristine[name])
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=5,
        treatment_mode='multiclass')
    cfg = dict(dataset_name=model_dataset_name(name), sindy_threshold=0.001, insite=insite)
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64)
    c, eq, one, n_step = _evaluate(model, ours)
    c_r, eq_r, one_r, n_step_r = _evaluate(
        JaxRegressor(JaxConfig(**cfg), ref), ref)
    np.testing.assert_array_equal(c, c_r)
    assert eq == eq_r
    assert c.shape == (4, 4 if name == 'cancer_sim' else 7)
    if name == 'EQ_5_C':
        # the dosage at t = 0 is the third input (u1); it is 0 in every
        # factual training row, so its features (u1, x0 u1, u0 u1) fit to 0
        assert not np.any(c[:, [3, 5, 6]]) and np.all(c[:, [1, 4]])
    rtol = 1e-8 if insite else 1e-12
    np.testing.assert_allclose(one, one_r, rtol=rtol)
    np.testing.assert_allclose(n_step, n_step_r, rtol=rtol)
    assert n_step.shape == (5,)
    if insite:
        assert len(support(model.coefs)) > 4   # beyond the register model


def test_rank_deficient_unbias_takes_the_minimum_norm_solution():
    """Column 2 a copy of column 0 (a constant static beside the bias): the
    JAX package's unbias refit raises; the port's gives the minimum-norm
    least-squares solution, which splits the weight evenly; a full-rank
    support gives the JAX package's coefficients bit for bit."""
    rs = np.random.RandomState(0)
    x = rs.rand(200)
    theta3 = np.stack([np.ones(200), x, x * x], axis=1)
    y = 0.4 + 1.5 * x + 0.01 * rs.randn(200)
    R3 = np.linalg.qr(np.concatenate([theta3, y[:, None]], 1), mode='r')
    # the triangle of [1, x, 1, x^2]: theta = Q R with an exact copy
    R = np.zeros((4, 4))
    R[:3, [0, 1, 3]] = R3[:3, :3]
    R[:3, 2] = R3[:3, 0]
    qty = np.append(R3[:3, 3], 0.0)
    theta = theta3[:, [0, 1, 0, 2]]
    with pytest.raises(np.linalg.LinAlgError):
        jax_stlsq_from_qr(R, qty, 0.05, 0.5)
    coefs, mask = stlsq_from_qr(R, qty, 0.05, 0.5)
    want = np.linalg.lstsq(theta[:, mask], y, rcond=None)[0]
    np.testing.assert_allclose(coefs[mask], want, rtol=1e-9)
    np.testing.assert_allclose(coefs[0], coefs[2], rtol=1e-9)
    got = stlsq_from_qr(R3[:3, :3], R3[:3, 3], 0.05, 0.5)
    ref = jax_stlsq_from_qr(R3[:3, :3], R3[:3, 3], 0.05, 0.5)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1].all()


def test_single_patient_type_fits_and_predicts():
    """EQ_5_A: one patient type, so 'u0' is a copy of '1' and 'x0 u0' of
    'x0'. The fit splits each arm's weight evenly between the copies, and
    INSITE's damped fine-tune runs on the doubled support."""
    coll = make_collection('EQ_5_A', SIZES, 0, 2.0, **F64)
    model = SINDyRegressor(SINDyConfig(dataset_name='EQ_5_A',
                                       sindy_threshold=0.001, insite=True),
                           coll, **F64)
    c, _, one, n_step = _evaluate(model, coll)
    np.testing.assert_allclose(c[:, 0], c[:, 2], rtol=1e-8)
    np.testing.assert_allclose(c[:, 1], c[:, 4], rtol=1e-8)
    assert np.isfinite(one).all() and np.isfinite(n_step).all()
