"""The vectorized MSM column (`harness/vectorized_msm.py`) against the JAX
package's, in float64 on the CPU: `batched_logistic_fit` and
`batched_wlinreg` on the same stacked inputs (rtol 1e-10), and a whole
column on collections the JAX package made, handed over with
`convert.collection_from_numpy` (the same numpy solves on the same
designs: rtol 1e-10); the port's own column at its standard path's
cohorts, with `seed_start` honoured."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.harness import vectorized_msm as jax_vmsm
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.harness import runner, vectorized_msm
from insite_tpu_torch.harness.config import RunConfig

SIZES = {'train': 30, 'val': 4, 'test': 4}
torch.set_num_threads(1)


def test_batched_solves_match_jax():
    rng = np.random.RandomState(0)
    mats = [rng.randn(n, 5) for n in (40, 33, 37)]
    X, mask = vectorized_msm._pad_stack(mats)
    Xr, mask_r = jax_vmsm._pad_stack(mats)
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(mask, mask_r)
    logits = X @ np.array([1.5, -2.0, 0.5, 0.0, 1.0])[:, None]
    Y = np.concatenate([(rng.rand(*logits.shape) <
                         1 / (1 + np.exp(-logits))),
                        rng.rand(*logits.shape) < 0.3], axis=-1) * 1.0
    W, b = vectorized_msm.batched_logistic_fit(X, Y, mask)
    W_r, b_r = jax_vmsm.batched_logistic_fit(X, Y, mask)
    assert W.shape == (3, 2, 5) and b.shape == (3, 2)
    np.testing.assert_allclose(W, W_r, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(b, b_r, rtol=1e-10, atol=1e-13)
    sw = rng.rand(*mask.shape)
    Yc = X @ rng.randn(5, 2) + 0.1 * rng.randn(3, X.shape[1], 2)
    coef = vectorized_msm.batched_wlinreg(X, Yc, sw, mask)
    np.testing.assert_allclose(coef, jax_vmsm.batched_wlinreg(X, Yc, sw,
                                                              mask),
                               rtol=1e-10, atol=1e-13)
    assert coef.shape == (3, 6, 2)


def _handed_over(dataset_name, seed):
    """The JAX package's msm collection of ``seed`` as
    `jax_vmsm.vectorized_msm_sweep` makes it (f64), carried over."""
    np.random.seed(seed)
    ref = jax_make_collection(dataset_name, dict(SIZES), seed, coeff=2.0,
                              treatment_mode='multilabel',
                              dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    return convert.collection_from_numpy(
        raw, ref.train_scaling_params, dataset_name,
        projection_horizon=ref.projection_horizon,
        treatment_mode='multilabel', seed=seed)


@pytest.mark.parametrize('dataset_name', ['EQ_4_D', 'cancer_sim'])
def test_msm_column_on_handed_over_collections_matches_jax(dataset_name):
    ref = jax_vmsm.vectorized_msm_sweep(dataset_name, n_seeds=2,
                                        num_patients=dict(SIZES),
                                        epochs=100)
    got = vectorized_msm.msm_column(
        [_handed_over(dataset_name, s) for s in (0, 1)], epochs=100)
    assert list(got) == list(ref)
    worst = max(float(np.max(np.abs(got[k] / ref[k] - 1))) for k in ref)
    print(f'{dataset_name} msm column: largest relative deviation '
          f'{worst:.3e}')
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-10, err_msg=k)


def test_msm_column_rows_honour_seed_start():
    """Seeds 3 and 4 of the port's own column: the rows of the standard
    sweep's cohorts, each within the batched Newton fit's tolerance of the
    standard path's L-BFGS-B fit at 1 step (as the JAX package holds its
    column to its standard path)."""
    cfg = RunConfig(methods=('msm',), datasets=('EQ_4_A',), seed_runs=2,
                    seed_start=3, train_samples=30, val_samples=4,
                    test_samples=4)
    rows, _ = runner.vectorized_sweep(cfg, device='cpu',
                                      dtype=torch.float64)
    assert [r['seed'] for r in rows] == [3, 4]
    for row in rows:
        ref = runner.run_experiment('EQ_4_A', 'msm', row['seed'], 2.0, cfg,
                                    device='cpu', dtype=torch.float64)
        np.testing.assert_allclose(row['encoder_test_rmse_orig'],
                                   ref['encoder_test_rmse_orig'], rtol=1e-3)
