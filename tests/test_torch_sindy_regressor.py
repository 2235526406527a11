"""The A-SINDy / INSITE estimator: the port's `SINDyRegressor` on a
collection carried over from the JAX package (`convert.collection_from_
numpy`) against the JAX `SINDyRegressor` on that same cohort, in float64 on
the CPU (the JAX side takes its XLA rollout and jvp fine-tune, the port the
plain versions of its kernels)."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import PkpdDatasetCollection as JaxCollection
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu.models.sindy import resolve_y_clip as jax_resolve_y_clip
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS, make_collection
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.models.sindy import (SINDyConfig, SINDyRegressor,
                                           resolve_y_clip)
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD

F64 = dict(device='cpu', dtype=torch.float64)
# the plain rollouts are thousands of small ops: intra-op threads only add
# synchronisation, and across parallel test workers they oversubscribe the
# cores (an order of magnitude slower on an 8-core host)
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pristine():
    return JaxCollection(2.0, {'train': 100, 'val': 10, 'test': 3},
                         'EQ_4_D', seed=0, dtype=jnp.float64)


def _collections(pristine):
    """(the port's collection, the JAX one) over one unprocessed cohort."""
    ref = copy.deepcopy(pristine)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_D', projection_horizon=5,
        treatment_mode='multiclass')
    return ours, ref


def _evaluate(model, coll):
    model.fit(coll.train_f)
    return (model.coefs, model.global_equation_string,
            model.get_normalised_masked_rmse(coll.test_cf_one_step,
                                             one_step_counterfactual=True),
            np.asarray(model.get_normalised_n_step_rmses(
                coll.test_cf_treatment_seq)))


@pytest.mark.parametrize('extra', [
    dict(insite=False), dict(insite=True),
    dict(insite=False, sindy_quantize=True),
    dict(insite=True, smooth_input_data=True)],
    ids=['sindy', 'insite', 'sindy-quantize', 'insite-smooth'])
def test_regressor_matches_jax_f64(pristine, extra):
    ours, ref = _collections(pristine)
    cfg = dict(dataset_name='EQ_4_D', **extra)
    c, eq, one, n_step = _evaluate(SINDyRegressor(SINDyConfig(**cfg), ours,
                                                  **F64), ours)
    c_r, eq_r, one_r, n_step_r = _evaluate(
        JaxRegressor(JaxConfig(**cfg), ref), ref)
    # the same design matrix and host QR bits, then the same host STLSQ
    np.testing.assert_allclose(c, c_r, rtol=1e-10, atol=1e-12)
    assert eq == eq_r
    assert 'Treatment 1: x_dot =' in eq
    # sindy: the same rollout to rounding; insite: the same LM update
    # sequence, Jacobian from forward sensitivities here and jvp there
    # (measured on the CPU: 1e-9 relative at most)
    np.testing.assert_allclose(one, one_r, rtol=1e-8)
    np.testing.assert_allclose(n_step, n_step_r, rtol=1e-8)
    assert n_step.shape == (5,)


def _rows(ds: SeqDataset, idx) -> SeqDataset:
    out = SeqDataset({k: v[idx] for k, v in ds.data.items()},
                     ds.subset_name, ds.norm_const)
    out.scaling_params = ds.scaling_params
    return out


def test_chunked_fine_tune_matches_unchunked():
    coll = make_collection('EQ_4_B', {'train': 60, 'val': 4, 'test': 2},
                           seed=3, coeff=2.0, **F64)
    cfg = SINDyConfig(dataset_name='EQ_4_B', insite=True)
    whole = SINDyRegressor(cfg, coll, **F64).fit(coll.train_f)
    chunked = SINDyRegressor(dataclasses.replace(cfg, finetune_chunk=3),
                             coll, **F64).fit(coll.train_f)
    # 8 rows of each test set: chunks of 3, 3 and 2 (padded by one row)
    for ds, ph in ((coll.test_cf_one_step, 1),
                   (coll.test_cf_treatment_seq, 5)):
        ds = _rows(ds, np.arange(0, len(ds), len(ds) // 8)[:8])
        want = whole._fine_tune(ds, ph)
        for got, ref in zip(chunked._fine_tune(ds, ph), want):
            assert got.shape[0] == 8
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
        np.testing.assert_array_equal(
            whole.get_fine_tuned_coefficients(ds, ph), want[1].numpy())


def test_empty_support_matches_jax(pristine):
    """Every global coefficient at or below 1e-3: no LM loop, the masked
    global model on rows longer than the horizon, the full one on the
    others."""
    ours, ref = _collections(pristine)
    cfg = dict(dataset_name='EQ_4_D', insite=True, sindy_threshold=1e6)
    c, _, one, n_step = _evaluate(SINDyRegressor(SINDyConfig(**cfg), ours,
                                                 **F64), ours)
    c_r, eq_r, one_r, n_step_r = _evaluate(
        JaxRegressor(JaxConfig(**cfg), ref), ref)
    assert not np.abs(c).max() > 1e-3
    np.testing.assert_array_equal(c, c_r)
    np.testing.assert_allclose(one, one_r, rtol=1e-10)
    np.testing.assert_allclose(n_step, n_step_r, rtol=1e-10)


@pytest.mark.parametrize('field, value', [
    ('wsindy', True), ('joint_model', True),
    ('ablation_more_complex_basis_functions', True),
    ('insite_solver', 'bfgs'), ('dataset_name', 'MIMIC'),
    ('rollout_backend', 'xla')])
def test_later_slices_raise(field, value):
    """What the estimator does not serve raises at construction, saying
    why; the weak fit, the joint model and the degree-4 library are
    served (their parity tests: test_torch_wsindy.py, test_torch_joint.py,
    test_torch_degree4.py)."""
    cfg = SINDyConfig(**{field: value})
    if field in ('wsindy', 'joint_model',
                 'ablation_more_complex_basis_functions'):
        model = SINDyRegressor(cfg, None, **F64)
        assert getattr(model.cfg, field) is True
        assert model._n_arms == (1 if field == 'joint_model' else 2)
        return
    reason = {'insite_solver': 'BFGS fine-tune is ported only when a '
                               'caller needs it',
              'dataset_name': 'the JAX package serves no SINDy fit on '
                              'real data',
              'rollout_backend': 'device picks kernel or plain'}[field]
    with pytest.raises(NotImplementedError, match=reason):
        SINDyRegressor(cfg, None, **F64)


def test_y_clip_resolution():
    assert resolve_y_clip('auto', 'EQ_4_B') is None
    assert resolve_y_clip((0.0, 1.0), 'EQ_4_B') == (0.0, 1.0)
    # the tumor family: the range its simulators clip the volume to
    for name in ('CANCER_SIM', 'EQ_5_A', 'EQ_5_D'):
        assert resolve_y_clip('auto', name) == \
            jax_resolve_y_clip('auto', name) == \
            (0.0, float(TUMOUR_DEATH_THRESHOLD))
    with pytest.raises(ValueError, match='unknown dataset'):
        make_collection('MIMIC', {'train': 4, 'val': 2, 'test': 2},
                        seed=0, coeff=2.0, **F64)
