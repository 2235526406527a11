"""`harness/checkpoint.py`: a fitted estimator of each family saved and
loaded into a fresh one, on the CPU (`tests/test_checkpoint.py` in the JAX
package).

- Every family (sindy, insite, the one-ODE fold, ct, crn, edct, rmsn,
  gnet, msm, and ct, crn, rmsn, gnet and edct on a vitals collection)
  round-trips: the fresh estimator's 1-step and n-step predictions equal
  the saved one's exactly.
- A checkpoint of one class refuses an estimator of another.
- An insite checkpoint predicts through the rollout kernels' plain
  versions here (no launch: the tensors lie on the host).

The JAX package's checkpoints are flax msgpack, which the port does not
read; the round trips are the port's own.
"""

import json

import numpy as np
import pytest
import torch

from insite_tpu_torch import ops
from insite_tpu_torch.data.collection import PkpdDatasetCollection
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.checkpoint import (STATE_FILE, load_model,
                                                 save_model)
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.models.ct import CausalTransformer, CTConfig
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
from insite_tpu_torch.ops import rollout
from torch_handover import (DIM_VITALS, jax_vitals_collection,
                            port_real_collection)

torch.set_num_threads(1)
TINY = {'train': 32, 'val': 8, 'test': 6}
SEQ = 20
NEURAL = ('ct', 'crn', 'edct', 'rmsn', 'gnet')


def _collection(treatment_mode='multilabel'):
    return PkpdDatasetCollection(2.0, dict(TINY), 'EQ_4_D', 0,
                                 max_seq_length=SEQ,
                                 treatment_mode=treatment_mode, device='cpu')


def _sindy(coll, **flags):
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0,
                      treatment_mode=coll.treatment_mode, **flags)
    return cfg, SINDyRegressor(cfg, coll, device='cpu')


def _neural(method, coll):
    """A fresh estimator of ``method`` as the runner builds it (2
    epochs)."""
    cfg = RunConfig(epochs=2, gnet_mc_samples=2, train_samples=32,
                    val_samples=8, test_samples=6)
    return runner._build_model(method, 'EQ_4_D', coll, cfg, device='cpu')


def _predictions(model, coll):
    n_step = (coll.test_cf_treatment_seq_mc if type(model).__name__ == 'GNet'
              else coll.test_cf_treatment_seq)
    return (model.get_predictions(coll.test_cf_one_step),
            model.get_autoregressive_predictions(n_step))


@pytest.mark.parametrize('kind', ['sindy', 'insite', 'one_ode', 'msm'] +
                         list(NEURAL) + [f'{m}_vitals' for m in NEURAL])
def test_round_trip(tmp_path, kind):
    method, vitals = kind.removesuffix('_vitals'), kind.endswith('_vitals')
    if vitals:
        coll = port_real_collection(jax_vitals_collection(TINY, SEQ))
    else:
        coll = _collection('multiclass' if kind in ('sindy', 'insite')
                           else 'multilabel')
    if method in ('sindy', 'insite', 'one_ode'):
        flags = {'insite': method == 'insite',
                 'joint_model': method == 'one_ode'}
        _, model = _sindy(coll, **flags)
        model.fit(coll.train_f)
        _, fresh = _sindy(coll, **flags)
    elif method == 'msm':
        from insite_tpu_torch.models.msm import MSM, MSMConfig
        coll.process_data_multi()
        cfg = MSMConfig(max_epochs=2,
                        **runner._dims_from_collection(coll))
        model = MSM(cfg, coll).fit(coll.train_f)
        fresh = MSM(cfg, coll)
    else:
        model = _neural(method, coll)
        model.fit(coll.train_f, coll.val_f)
        fresh = _neural(method, coll)
    want = _predictions(model, coll)
    path = save_model(model, str(tmp_path / kind))
    meta = json.load(open(f'{path}/meta.json'))
    assert meta['class'] == type(model).__name__
    assert (tmp_path / kind / STATE_FILE).exists()
    assert load_model(fresh, path) is fresh
    got = _predictions(fresh, coll)
    for w, g in zip(want, got):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)
    if method == 'gnet':
        np.testing.assert_array_equal(fresh.holdout_resid,
                                      model.holdout_resid)
        if vitals:
            assert fresh.holdout_resid.shape[-1] == 1 + DIM_VITALS
    if method in ('sindy', 'insite', 'one_ode'):
        assert fresh.global_equation_string == model.global_equation_string


def test_checkpoint_class_mismatch(tmp_path):
    coll = _collection('multiclass')
    _, model = _sindy(coll)
    path = save_model(model.fit(coll.train_f), str(tmp_path / 'sindy'))
    other = CausalTransformer(CTConfig(), None, device='cpu')
    with pytest.raises(ValueError, match='checkpoint is a SINDyRegressor'):
        load_model(other, path)


def test_insite_checkpoint_predicts_through_the_plain_kernels(tmp_path):
    """An insite checkpoint reloads and fine-tunes on the host through the
    plain versions of both kernels (no launch), as the saved model
    does."""
    coll = _collection('multiclass')
    _, model = _sindy(coll, insite=True)
    path = save_model(model.fit(coll.train_f), str(tmp_path / 'insite'))
    want = model.get_predictions(coll.test_cf_one_step)
    _, fresh = _sindy(coll, insite=True)
    assert fresh.coefs is None and fresh.library is None
    ops.reset_launch_counts()
    load_model(fresh, path)
    got = fresh.get_predictions(coll.test_cf_one_step)
    assert (rollout.ROLLOUT_LAUNCHES, rollout.SENS_LAUNCHES) == (0, 0)
    np.testing.assert_array_equal(got, want)
